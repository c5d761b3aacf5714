"""The port's per-client worker functions (commefficient_torch/federated/
worker.py) against the JAX package's on the CPU, on one client's batch of
a tiny ResNet9 from the same flat weights.

Tolerances: the gradients come from PyTorch's CPU convolutions and XLA's,
which sum in another order, so a gradient (and everything linear in it:
clips, momentum, error, fedavg's weight delta) agrees to ``rtol=1e-4,
atol=1e-5`` (as ``tests/test_torch_models.py`` holds the flat gradient);
losses to ``rtol=1e-4``; accuracies and counts are exact. Where both
packages get the same input vector (the top-k, the sketch table, the
topk-down reconstruction), the results must be equal bit for bit.
"""

import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.federated import worker as jwk  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_tpu.ops.flat import ravel_pytree  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.federated import worker as twk  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
B, K = 4, 500
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def pair():
    jm = JResNet9(channels=TINY)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                     train=False)["params"]
    flat, unravel = ravel_pytree(params)
    jtrain, _ = j_losses(jm)
    tm = ResNet9(channels=TINY)
    layout = ParamLayout(tm)
    ttrain, _ = t_losses(tm)
    js = jsk.make_sketch(layout.d, 2048, 3, seed=0, num_blocks=2)
    ts = tsk.make_sketch(layout.d, 2048, 3, seed=0, num_blocks=2,
                         device="cpu")
    return dict(jtrain=jtrain, unravel=unravel, flat=np.asarray(flat),
                ttrain=ttrain, layout=layout, js=js, ts=ts)


def _client_batch(seed, short=False):
    rng = np.random.RandomState(seed)
    mask = np.ones(B, np.float32)
    if short:
        mask[2:] = 0.0
    return {"inputs": rng.randn(B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=B).astype(np.int64),
            "mask": mask}


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _ravel(tree):
    return ravel_pytree(tree)[0]


CONFIGS = {
    "uncompressed": dict(mode="uncompressed"),
    "max_grad_norm": dict(mode="uncompressed", max_grad_norm=0.05),
    "dp-zero-noise": dict(mode="uncompressed", do_dp=True,
                          l2_norm_clip=0.03, noise_multiplier=0.0),
    "microbatch": dict(mode="uncompressed", microbatch_size=3),
    "local-topk": dict(mode="local_topk", error_type="local",
                       local_momentum=0.9, k=K),
    "true_topk-momentum": dict(mode="true_topk", error_type="virtual",
                               local_momentum=0.9, k=K),
    "sketch-local": dict(mode="sketch", error_type="local",
                         local_momentum=0.9, k=K),
    "sketch-max_grad_norm": dict(mode="sketch", error_type="local",
                                 local_momentum=0.9, k=K,
                                 max_grad_norm=0.05),
}


def _configs(name):
    kw = dict(num_workers=4, weight_decay=5e-4, **CONFIGS[name])
    return jwk.WorkerConfig(**kw), twk.WorkerConfig(**kw)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _metrics_close(tm, jm):
    assert len(tm) == len(jm) == 3
    np.testing.assert_allclose(float(tm[0]), float(jm[0]), rtol=RTOL)
    assert float(tm[1]) == float(jm[1]) and float(tm[2]) == float(jm[2])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_grad_matches(pair, name):
    jcfg, tcfg = _configs(name)
    b = _client_batch(1, short=name == "microbatch")
    sk = name.startswith("sketch")
    jg, jmet, _, jdense = jwk.forward_grad(
        pair["jtrain"], jnp.asarray(pair["flat"]), pair["unravel"], _ravel,
        {}, _jax(b), jax.random.key(1), jcfg, pair["js"] if sk else None)
    w = flat_from_jax(pair["flat"], pair["layout"])
    tg, tmet, _, tdense = twk.forward_grad(
        pair["ttrain"], w, pair["layout"], {}, _torch(b),
        torch.Generator().manual_seed(1), tcfg, pair["ts"] if sk else None)
    _metrics_close(tmet, jmet)
    _close(tdense, jdense)
    if name in ("max_grad_norm", "dp-zero-noise"):
        # the clip is active: the norm is the clip's
        clip = tcfg.max_grad_norm or tcfg.l2_norm_clip
        np.testing.assert_allclose(float(torch.linalg.vector_norm(tdense)),
                                   clip, rtol=1e-5)
    if sk:
        assert tuple(tg.shape) == pair["ts"].table_shape
        if tcfg.max_grad_norm is None:
            # the table is sketch_vec of the dense gradient, exactly
            np.testing.assert_array_equal(
                tg.numpy(), tsk.sketch_vec(pair["ts"], tdense).numpy())
        else:
            np.testing.assert_allclose(float(tsk.l2estimate(tg)),
                                       tcfg.max_grad_norm, rtol=1e-5)
        # table cells sum several gradient entries: an absolute tolerance
        # of the summed magnitudes
        _close(tg, jg, atol=1e-4)
    else:
        _close(tg, jg)


@pytest.mark.parametrize("name", ["uncompressed", "local-topk",
                                  "true_topk-momentum", "sketch-local"])
def test_local_step_matches(pair, name):
    """Local momentum and error from nonzero rows, the x count scaling and
    the local top-k with its masks."""
    jcfg, tcfg = _configs(name)
    b = _client_batch(2, short=True)
    sk = name.startswith("sketch")
    shape = pair["ts"].table_shape if sk else (pair["layout"].d,)
    rng = np.random.RandomState(5)
    vel = (rng.randn(*shape) * 1e-3).astype(np.float32)
    err = (rng.randn(*shape) * 1e-3).astype(np.float32)
    jres, _ = jwk.local_step(
        pair["jtrain"], jnp.asarray(pair["flat"]), pair["unravel"], _ravel,
        {}, jnp.asarray(vel), jnp.asarray(err), _jax(b), jax.random.key(2),
        jcfg, pair["js"] if sk else None)
    tres, _ = twk.local_step(
        pair["ttrain"], flat_from_jax(pair["flat"], pair["layout"]),
        pair["layout"], {}, torch.from_numpy(vel),
        torch.from_numpy(err), _torch(b), torch.Generator().manual_seed(2),
        tcfg, pair["ts"] if sk else None)
    _metrics_close(tres.metrics, jres.metrics)
    atol = 1e-4 if sk else ATOL
    _close(tres.transmit, jres.transmit, atol=atol)
    for t, j, has in ((tres.new_velocity, jres.new_velocity,
                       tcfg.has_velocity),
                      (tres.new_error, jres.new_error, tcfg.has_error)):
        if has:
            _close(t, j, atol=atol)
    if name == "local-topk":
        tsel = set(np.flatnonzero(tres.transmit.numpy()))
        jsel = set(np.flatnonzero(np.asarray(jres.transmit)))
        assert len(tsel) >= K
        assert len(tsel & jsel) / max(len(tsel), len(jsel)) >= 0.99
        # zero error and velocity exactly where the top-k kept a coordinate
        kept = tres.transmit.numpy() != 0
        assert not tres.new_error.numpy()[kept].any()
        assert not tres.new_velocity.numpy()[kept].any()


def test_topk_and_sketch_of_one_vector_are_exact(pair):
    """From one input vector (JAX's client gradient of the local-topk
    config), the port's top-k keeps JAX's set with JAX's values, and the
    port's sketch table is JAX's, bit for bit."""
    jcfg, _ = _configs("local-topk")
    jres, _ = jwk.local_step(
        pair["jtrain"], jnp.asarray(pair["flat"]), pair["unravel"], _ravel,
        {}, jnp.zeros(pair["layout"].d), jnp.zeros(pair["layout"].d),
        _jax(_client_batch(3)), jax.random.key(3),
        dataclasses.replace(jcfg, mode="uncompressed"), None)
    v = np.array(jres.transmit)
    np.testing.assert_array_equal(
        ttk.topk(torch.from_numpy(v), K).numpy(),
        np.asarray(jtk.topk(jnp.asarray(v), K)))
    np.testing.assert_array_equal(
        tsk.sketch_vec(pair["ts"], torch.from_numpy(v)).numpy(),
        np.asarray(jsk.sketch_vec(pair["js"], jnp.asarray(v))))


@pytest.mark.parametrize("epochs,fbs,decay,short", [
    (1, -1, 1.0, False), (2, 2, 0.9, True), (1, 3, 1.0, False)])
def test_fedavg_local_matches(pair, epochs, fbs, decay, short):
    """Local SGD over ``fedavg_batch_size`` chunks, epochs, the lr decay
    and (``short``: the second chunk is all padding) the skipped empty
    chunk."""
    kw = dict(mode="fedavg", num_fedavg_epochs=epochs, fedavg_batch_size=fbs,
              fedavg_lr_decay=decay)
    jcfg, tcfg = jwk.WorkerConfig(**kw), twk.WorkerConfig(**kw)
    b = _client_batch(4, short=short)
    lr = 0.3
    jres, _ = jwk.fedavg_local(
        pair["jtrain"], jnp.asarray(pair["flat"]), pair["unravel"], _ravel,
        {}, _jax(b), jax.random.key(4), lr, jcfg)
    tres, _ = twk.fedavg_local(
        pair["ttrain"], flat_from_jax(pair["flat"], pair["layout"]),
        pair["layout"], {}, _torch(b),
        torch.Generator().manual_seed(4), lr, tcfg)
    _metrics_close(tres.metrics, jres.metrics)
    assert tres.new_velocity is None and tres.new_error is None
    _close(tres.transmit, jres.transmit)
    assert np.abs(tres.transmit.numpy()).max() > 0


@pytest.mark.parametrize("topk_down", [True, False])
def test_get_new_worker_weights_exact(topk_down):
    rng = np.random.RandomState(7)
    ps = rng.randn(20_000).astype(np.float32)
    stale = ps.copy()
    moved = rng.choice(ps.size, 3_000, replace=False)
    stale[moved] += rng.randn(moved.size).astype(np.float32)
    want = np.asarray(jwk.get_new_worker_weights(
        jnp.asarray(ps), jnp.asarray(stale), K, topk_down))
    got = twk.get_new_worker_weights(torch.from_numpy(ps),
                                     torch.from_numpy(stale), K, topk_down)
    np.testing.assert_array_equal(got.numpy(), want)
    # the top-k reconstruction moves exactly k coordinates (no ties here)
    assert (got.numpy() != stale).sum() == (K if topk_down else moved.size)


@pytest.mark.parametrize("norm", [None, 0.5, 3.0])
def test_clip_by_l2_matches(norm):
    from commefficient_tpu.ops.clip import clip_by_l2 as jclip
    from commefficient_torch.ops.clip import clip_by_l2 as tclip

    x = np.random.RandomState(8).randn(5_000).astype(np.float32) * 0.05
    for clip in (0.1, 1e3):
        jn = None if norm is None else jnp.float32(norm)
        tn = None if norm is None else torch.tensor(norm)
        _close(tclip(torch.from_numpy(x), clip, tn), jclip(jnp.asarray(x),
                                                           clip, jn),
               rtol=1e-6, atol=0)
