"""``--batchnorm`` in the port against the JAX package on the CPU: the flat
layout and d, the logits in train and eval mode, the running-statistics
update (flax's conventions), the slot-masked average of the per-client
statistics, and a 3-round sketch trajectory.

flax's BatchNorm is not torch's: ``momentum=0.9`` is the weight of the
old running statistic (torch's ``momentum`` weights the new one), and the
running variance takes the biased batch variance ``E[x^2] - E[x]^2``
(torch's takes the unbiased one); the port follows flax.

Tolerances: XLA's CPU convolutions and PyTorch's sum in different orders,
and the batch statistics divide small differences by a batch standard
deviation, so logits and statistics agree to ``rtol=1e-4, atol=1e-5``; a
single BatchNorm on the same input to ``rtol=1e-5, atol=1e-6``. The
trajectory carries the tolerances of ``tests/test_torch_rounds.py``
(losses ``rtol=1e-4``, weights ``rtol=1e-4, atol=1e-6``, kept sets
overlapping by at least 0.99 a round), for the same reason.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import linen as fnn  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import (  # noqa: E402
    flat_from_jax,
    model_state_from_flax,
    params_from_flax,
)
from commefficient_torch.federated import FedModel, FedOptimizer  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.federated.rounds import average_model_state  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.models.layers import BatchNorm, BNContext  # noqa: E402
from commefficient_torch.ops.flat import ParamLayout  # noqa: E402

TINY = (("prep", 8), ("layer1", 16), ("layer2", 16), ("layer3", 32))
RTOL, ATOL = 1e-4, 1e-5
W, B, NCLIENTS, LR = 4, 4, 8, 0.1
ARGV = ["--mode", "sketch", "--error_type", "virtual",
        "--local_momentum", "0", "--virtual_momentum", "0.9",
        "--k", "500", "--num_cols", "2048", "--num_rows", "3",
        "--num_blocks", "2", "--num_workers", str(W), "--num_devices", "1",
        "--num_clients", str(NCLIENTS), "--dataset_name", "CIFAR10",
        "--local_batch_size", str(B), "--seed", "0", "--batchnorm"]


def _jax_init(channels=TINY):
    jm = JResNet9(do_batchnorm=True, channels=channels)
    v = jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False)
    return jm, v


def test_flat_layout_and_d_match_jax():
    jm, v = _jax_init()
    flat, _ = ravel_pytree(v["params"])
    tm = ResNet9(channels=TINY, do_batchnorm=True)
    layout = ParamLayout(tm)
    assert layout.d == flat.size
    names = ["/".join(e.jax_path) for e in layout.entries]
    jnames = ["/".join(str(k.key) for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(v["params"])[0]]
    assert names == jnames
    assert names[:3] == ["layer1/BatchNorm_0/bias",
                         "layer1/BatchNorm_0/scale", "layer1/Conv_0/kernel"]
    tparams = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                      v["params"]), layout)
    np.testing.assert_array_equal(layout.flatten(tparams).numpy(),
                                  np.asarray(flat))
    # the running statistics: the same paths, flax's initial values
    tstate = tm.initial_model_state()
    jstate = model_state_from_flax(jax.tree_util.tree_map(
        np.asarray, v["batch_stats"]))
    assert list(tstate) == list(jstate)
    for k in tstate:
        np.testing.assert_array_equal(tstate[k].numpy(), jstate[k].numpy())
    # full width: d grows by 2 x 2,240 BatchNorm channels
    full = ParamLayout(ResNet9(do_batchnorm=True))
    jfull = jax.eval_shape(lambda: JResNet9(do_batchnorm=True).init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    assert full.d == 6_573_120 == sum(
        int(np.prod(x.shape)) for x in
        jax.tree_util.tree_leaves(jfull["params"]))
    assert ParamLayout(ResNet9()).d == 6_568_640


def _perturbed(v, seed):
    """JAX variables with BatchNorm scale, bias and statistics moved off
    their initial values, so every term of the normalization counts."""
    rng = np.random.RandomState(seed)

    def move(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name in ("scale", "var"):
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(move, v)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_and_statistics(train):
    jm, v = _jax_init()
    v = _perturbed(v, 3)
    x = np.random.RandomState(4).randn(6, 32, 32, 3).astype(np.float32)
    if train:
        jlog, upd = jm.apply(v, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
        jstate = model_state_from_flax(jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"]))
    else:
        jlog = jm.apply(v, jnp.asarray(x), train=False)
        jstate = model_state_from_flax(jax.tree_util.tree_map(
            np.asarray, v["batch_stats"]))
    tm = ResNet9(channels=TINY, do_batchnorm=True)
    layout = ParamLayout(tm)
    tparams = params_from_flax(v["params"], layout)
    state = model_state_from_flax(v["batch_stats"])
    tlog, tstate = torch.func.functional_call(
        tm, tparams, (torch.from_numpy(x), state, train))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog),
                               rtol=RTOL, atol=ATOL)
    assert list(tstate) == list(jstate)
    for k in jstate:
        np.testing.assert_allclose(tstate[k].detach().numpy(),
                                   jstate[k].numpy(), rtol=RTOL, atol=ATOL)
    if not train:
        assert tstate is state


def test_running_update_is_flax_convention():
    """One BatchNorm on the same NCHW input: flax's statistics (biased
    variance, running ``0.9 * old + 0.1 * batch``), which torch's
    ``nn.BatchNorm2d`` does not give."""
    rng = np.random.RandomState(7)
    c = 5
    x = (rng.randn(3, c, 4, 4) * 2 + 1).astype(np.float32)
    old_m = rng.randn(c).astype(np.float32)
    old_v = rng.uniform(0.5, 2, c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)

    bn = BatchNorm(c, ("cell",))
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    ctx = BNContext({"cell/BatchNorm_0/mean": torch.from_numpy(old_m),
                     "cell/BatchNorm_0/var": torch.from_numpy(old_v)}, True)
    y = bn(torch.from_numpy(x), ctx).detach().numpy()

    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5)
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    fvars = {"params": {"scale": jnp.asarray(scale),
                        "bias": jnp.asarray(bias)},
             "batch_stats": {"mean": jnp.asarray(old_m),
                             "var": jnp.asarray(old_v)}}
    fy, fupd = fbn.apply(fvars, xh, mutable=["batch_stats"])
    np.testing.assert_allclose(y, np.asarray(fy).transpose(0, 3, 1, 2),
                               rtol=1e-5, atol=1e-6)
    new_m = ctx.new["cell/BatchNorm_0/mean"].numpy()
    new_v = ctx.new["cell/BatchNorm_0/var"].numpy()
    np.testing.assert_allclose(new_m, np.asarray(fupd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(new_v, np.asarray(fupd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    x64 = x.astype(np.float64)
    biased = x64.var(axis=(0, 2, 3))
    np.testing.assert_allclose(new_v, 0.9 * old_v + 0.1 * biased, rtol=1e-5)
    # torch's own convention differs: momentum 0.1 on the new statistic
    # and the unbiased variance
    tbn = torch.nn.BatchNorm2d(c, momentum=0.1)
    with torch.no_grad():
        tbn.running_mean.copy_(torch.from_numpy(old_m))
        tbn.running_var.copy_(torch.from_numpy(old_v))
    tbn.train()(torch.from_numpy(x))
    n = x.size // c
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               0.9 * old_v + 0.1 * biased * n / (n - 1),
                               rtol=1e-5)
    assert not np.allclose(tbn.running_var.numpy(), new_v, rtol=1e-4)


def _jax_average(new_ms, model_state, worker_mask):
    """``commefficient_tpu/federated/rounds.py:847-869`` on one device,
    transcribed (the JAX package runs it inside its jitted round)."""
    wsum = worker_mask.sum()
    local_mean = jax.tree_util.tree_map(
        lambda x: jnp.einsum("c,c...->...", worker_mask, x)
        / jnp.maximum(wsum, 1.0), new_ms)
    return jax.tree_util.tree_map(
        lambda new, old: jnp.where(wsum > 0, new, old), local_mean,
        model_state)


@pytest.mark.parametrize("wmask", [[1, 1, 1, 1], [1, 0, 1, 0], [0, 0, 0, 0]],
                         ids=["full", "short", "all-padding"])
def test_slot_masked_average(wmask):
    rng = np.random.RandomState(9)
    keys = ("a/BatchNorm_0/mean", "a/BatchNorm_0/var")
    old = {k: rng.randn(6).astype(np.float32) for k in keys}
    new = {k: rng.randn(4, 6).astype(np.float32) for k in keys}
    wm = np.asarray(wmask, np.float32)
    want = _jax_average({k: jnp.asarray(v) for k, v in new.items()},
                        {k: jnp.asarray(v) for k, v in old.items()},
                        jnp.asarray(wm))
    got = average_model_state({k: torch.from_numpy(v)
                               for k, v in new.items()},
                              {k: torch.from_numpy(v)
                               for k, v in old.items()},
                              torch.from_numpy(wm))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    if not wm.any():
        for k in keys:
            np.testing.assert_array_equal(got[k].numpy(), old[k])
    assert average_model_state({}, {}, torch.from_numpy(wm)) == {}


def _batch(rnd):
    rng = np.random.RandomState(300 + rnd)
    mask = np.ones((W, B), np.float32)
    wmask = np.ones(W, np.float32)
    if rnd == 1:  # a short client and a padded slot
        mask[1, 2:] = 0.0
        mask[3] = 0.0
        wmask[3] = 0.0
    if rnd == 2:  # an all-padding round
        mask[:] = 0.0
        wmask[:] = 0.0
    return {"inputs": rng.randn(W, B, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(W, B)).astype(np.int64),
            "mask": mask,
            "client_ids": rng.choice(NCLIENTS, W, replace=False)
            .astype(np.int32),
            "worker_mask": wmask}


@pytest.fixture(scope="module")
def trajectories():
    jargs = j_parse(argv=ARGV + ["--no_telemetry"])
    jm = JResNet9(do_batchnorm=True, channels=TINY)
    jtrain, jval = j_losses(jm, has_batch_stats=True)
    jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                    num_clients=NCLIENTS)
    assert jfm.mesh is None or jfm.mesh.devices.size == 1
    jopt = JFedOptimizer(jfm, jargs)
    jopt.set_lr_factor(LR)
    flat0 = np.asarray(ravel_pytree(jfm.params)[0])
    state0 = jax.tree_util.tree_map(np.asarray, jfm._model_state)

    targs = t_parse(argv=ARGV + ["--device", "cpu"])
    tm = ResNet9(channels=TINY, do_batchnorm=True)
    layout = ParamLayout(tm)
    ttrain, tval = t_losses(tm)
    tfm = FedModel(tm, ttrain, targs, tval, num_clients=NCLIENTS,
                   init_params=flat_from_jax(flat0, layout), device="cpu")
    # the port starts from flax's initial statistics
    start = model_state_from_flax(state0)
    assert list(tfm._model_state) == list(start)
    for k, v in start.items():
        assert torch.equal(tfm._model_state[k], v)
    topt = FedOptimizer(tfm, targs)
    topt.set_lr_factor(LR)
    out = []
    for rnd in range(3):
        b = _batch(rnd)
        jres = jfm(b)
        jopt.step()
        tres = tfm(b)
        topt.step()
        out.append(dict(
            jres=jres, tres=tres,
            jw=np.asarray(ravel_pytree(jfm.params)[0]),
            tw=tfm.layout.unchunk(tfm.ps_weights).numpy().copy(),
            js=model_state_from_flax(jax.tree_util.tree_map(
                np.asarray, jfm._model_state)),
            ts={k: v.numpy().copy() for k, v in tfm._model_state.items()}))
    vb = {"inputs": _batch(7)["inputs"][0], "targets": _batch(7)["targets"][0],
          "mask": np.ones(B, np.float32)}
    jfm.train(False)
    tfm.train(False)
    return flat0, model_state_from_flax(state0), out, jfm(vb), tfm(vb)


def test_trajectory_matches_jax(trajectories):
    flat0, state0, out, jval, tval = trajectories
    jprev = tprev = flat0
    for rnd, r in enumerate(out):
        (jl, ja, jd, ju), (tl, ta, td, tu) = r["jres"], r["tres"]
        assert tl.shape == jl.shape
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_allclose(td, jd, rtol=0.01)
        np.testing.assert_allclose(r["tw"], r["jw"], rtol=1e-4, atol=1e-6)
        jsel = set(np.flatnonzero(r["jw"] != jprev))
        tsel = set(np.flatnonzero(r["tw"] != tprev))
        assert len(jsel & tsel) >= 0.99 * max(len(jsel), len(tsel)), rnd
        jprev, tprev = r["jw"], r["tw"]
        assert list(r["ts"]) == list(r["js"])
        for k in r["js"]:
            np.testing.assert_allclose(r["ts"][k], r["js"][k].numpy(),
                                       rtol=RTOL, atol=ATOL)
            assert np.all(np.isfinite(r["ts"][k]))
    # the all-padding round (2) keeps the state of round 1 bit for bit
    for k in out[1]["ts"]:
        np.testing.assert_array_equal(out[2]["ts"][k], out[1]["ts"][k])
        assert not np.array_equal(out[1]["ts"][k], state0[k].numpy())
    # eval normalizes with the running statistics
    for j, t in zip(jval, tval):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
