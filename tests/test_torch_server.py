"""The port's server step (commefficient_torch/federated/server.py) against
the JAX package's ``server_update`` on the CPU, from the same aggregated
round gradient and state: the sketch mode (chunked-resident branch) and
the four dense rules.

The dense rules (``_uncompressed``, ``_true_topk``, ``_local_topk``,
``_fedavg``) are run op by op on the JAX side, as ``server_update`` runs
outside ``jit``, so their float32 arithmetic is the port's and the results
must be equal bit for bit (a jitted XLA program may contract ``g + m * v``
into a fused multiply-add).

The query, the threshold descent and the selected set are exact given the
same error table, so they are compared bit for bit from one error table.
The end-to-end update, velocity and error are compared with
``rtol=1e-6, atol=1e-7``: ``g + momentum * v`` may be contracted to a fused
multiply-add by XLA and not by PyTorch, a difference of at most one
rounding per element.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.federated import server as jsrv  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch.federated import server as tsrv  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

D, K = 31_640, 500
RTOL, ATOL = 1e-6, 1e-7


def _setup(r, seed, vm=0.9):
    js = jsk.make_sketch(D, 2048, r, seed=seed, num_blocks=2)
    ts = tsk.make_sketch(D, 2048, r, seed=seed, num_blocks=2, device="cpu")
    rng = np.random.RandomState(seed)
    g, vel, err = (rng.randn(*js.table_shape).astype(np.float32)
                   for _ in range(3))
    jcfg = jsrv.ServerConfig(mode="sketch", error_type="virtual", k=K,
                             grad_size=D, virtual_momentum=vm)
    tcfg = tsrv.ServerConfig(mode="sketch", error_type="virtual", k=K,
                             grad_size=D, virtual_momentum=vm)
    return js, ts, jcfg, tcfg, g, vel, err


@pytest.mark.parametrize("r,seed", [(3, 0), (4, 1), (5, 2)])
def test_query_threshold_and_selection_exact(r, seed):
    js, ts, _, _, _, _, err = _setup(r, seed)
    jest = np.asarray(jsk.estimates_chunks(js, jnp.asarray(err)))
    test_ = tsk.estimates_chunks(ts, torch.from_numpy(err))
    np.testing.assert_array_equal(test_.numpy(), jest)
    jp = int(jtk.resolve_threshold(jnp.asarray(jest), K))
    tp = int(ttk.resolve_threshold(test_, K))
    assert tp == jp
    jupd = np.asarray(jsk.unsketch_chunks(js, jnp.asarray(err), K))
    tupd = tsk.unsketch_chunks(ts, torch.from_numpy(err), K).numpy()
    np.testing.assert_array_equal(tupd, jupd)
    assert (tupd != 0).sum() >= K
    # the re-sketch of the update, and so the masked cells, match too
    np.testing.assert_array_equal(
        tsk.sketch_chunks(ts, torch.from_numpy(tupd)).numpy(),
        np.asarray(jsk.sketch_chunks(js, jnp.asarray(jupd))))


@pytest.mark.parametrize("r,seed,vm", [(3, 0, 0.9), (4, 1, 0.0),
                                       (5, 3, 0.9)])
def test_server_update_matches(r, seed, vm):
    js, ts, jcfg, tcfg, g, vel, err = _setup(r, seed, vm)
    lr = 0.37
    jupd, jst = jsrv.server_update(
        jnp.asarray(g), jsrv.ServerState(jnp.asarray(vel), jnp.asarray(err)),
        jcfg, lr, sketch=js, layout=js.chunk_layout)
    tupd, tst = tsrv.server_update(
        torch.from_numpy(g),
        tsrv.ServerState(torch.from_numpy(vel), torch.from_numpy(err)),
        tcfg, lr, sketch=ts, layout=ts.chunk_layout)
    jupd = np.asarray(jupd)
    assert tupd.shape == jupd.shape == (ts.T, ts.sublanes, 128)
    np.testing.assert_array_equal(tupd.numpy() != 0, jupd != 0)
    np.testing.assert_allclose(tupd.numpy(), jupd, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tst.velocity.numpy(), np.asarray(jst.velocity),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tst.error.numpy(), np.asarray(jst.error),
                               rtol=RTOL, atol=ATOL)
    # masked cells are exactly zero in both
    np.testing.assert_array_equal(tst.error.numpy() == 0,
                                  np.asarray(jst.error) == 0)


def test_flat_caller_matches_chunked():
    _, ts, _, tcfg, g, vel, err = _setup(3, 5)
    st = tsrv.ServerState(torch.from_numpy(vel), torch.from_numpy(err))
    u3, _ = tsrv.server_update(torch.from_numpy(g), st, tcfg, 0.1, sketch=ts,
                               layout=ts.chunk_layout)
    u1, _ = tsrv.server_update(torch.from_numpy(g), st, tcfg, 0.1, sketch=ts)
    np.testing.assert_array_equal(ts.chunk_layout.unchunk(u3).numpy(),
                                  u1.numpy())


def test_legality_asserts_verbatim():
    with pytest.raises(AssertionError, match="local_momentum 0"):
        tsrv.ServerConfig(mode="sketch", error_type="virtual",
                          local_momentum=0.9)
    with pytest.raises(AssertionError, match="virtual_momentum 0"):
        tsrv.ServerConfig(mode="sketch", error_type="local",
                          virtual_momentum=0.9)
    with pytest.raises(AssertionError):
        tsrv.ServerConfig(mode="true_topk", error_type="none")


def test_other_modes_not_ported():
    """The name is kept from when the dense modes were not ported: now
    ``init_server_state`` gives ``(d,)`` zero velocity and error for each
    of them, on the device asked for, and no collective carries (the fp32
    plan)."""
    for mode, err in (("uncompressed", "none"), ("true_topk", "virtual"),
                      ("local_topk", "local"), ("fedavg", "none")):
        cfg = tsrv.ServerConfig(mode=mode, error_type=err, grad_size=D)
        st = tsrv.init_server_state(cfg, device="cpu")
        assert st.qres is None and st.dres is None
        for t in (st.velocity, st.error):
            assert t.shape == (D,) and t.dtype == torch.float32
            assert t.device.type == "cpu" and not t.any()
        assert st.velocity.data_ptr() != st.error.data_ptr()


DENSE = {
    "uncompressed": dict(error_type="none"),
    "uncompressed-dp-zero": dict(error_type="none", do_dp=True,
                                 dp_mode="server", noise_multiplier=0.0),
    "true_topk": dict(error_type="virtual", k=K),
    "local_topk": dict(error_type="local"),
    "fedavg": dict(error_type="none"),
}


@pytest.mark.parametrize("vm", [0.9, 0.0])
@pytest.mark.parametrize("name", list(DENSE))
def test_dense_rules_bit_equal(name, vm):
    mode = name.split("-")[0]
    kw = dict(mode=mode, grad_size=D, virtual_momentum=vm, **DENSE[name])
    jcfg, tcfg = jsrv.ServerConfig(**kw), tsrv.ServerConfig(**kw)
    rng = np.random.RandomState(len(name) + int(10 * vm))
    g, vel, err = (rng.randn(D).astype(np.float32) for _ in range(3))
    if mode == "local_topk":   # the clients' k-sparse sum
        g[rng.rand(D) < 0.9] = 0.0
    lr = 1.0 if mode == "fedavg" else 0.37
    jupd, jst = jsrv.server_update(
        jnp.asarray(g), jsrv.ServerState(jnp.asarray(vel), jnp.asarray(err)),
        jcfg, lr, rng=jax.random.key(0))
    tupd, tst = tsrv.server_update(
        torch.from_numpy(g),
        tsrv.ServerState(torch.from_numpy(vel), torch.from_numpy(err)),
        tcfg, lr, rng=torch.Generator().manual_seed(0))
    for t, j in ((tupd, jupd), (tst.velocity, jst.velocity),
                 (tst.error, jst.error)):
        assert t.shape == (D,)
        np.testing.assert_array_equal(t.numpy().view(np.int32),
                                      np.asarray(j).view(np.int32))
    if mode == "true_topk":
        kept = tupd.numpy() != 0
        assert kept.sum() >= K
        assert not tst.error.numpy()[kept].any()
        assert not tst.velocity.numpy()[kept].any()


def test_server_dp_noise_seeded_and_scaled():
    """Server DP noise (``uncompressed``, ``dp_mode == "server"``): one
    seed gives one draw, and the noise's standard deviation over d = 2e5
    is within 5% of ``noise_multiplier`` (the lr is 1, the gradient 0)."""
    d, nm = 200_000, 0.25
    cfg = tsrv.ServerConfig(mode="uncompressed", grad_size=d, do_dp=True,
                            dp_mode="server", noise_multiplier=nm)
    st = tsrv.init_server_state(cfg, device="cpu")
    zero = torch.zeros(d)

    def draw(seed):
        return tsrv.server_update(zero, st, cfg, 1.0,
                                  rng=torch.Generator().manual_seed(seed))

    (u1, s1), (u2, _), (u3, _) = draw(7), draw(7), draw(8)
    assert torch.equal(u1, u2) and not torch.equal(u1, u3)
    assert abs(float(u1.std()) / nm - 1.0) < 0.05
    assert abs(float(u1.mean())) < 5 * nm / d ** 0.5
    # the noise is on the update, not on the carried velocity
    assert not s1.velocity.any()
    with pytest.raises(AssertionError, match="generator"):
        tsrv.server_update(zero, st, cfg, 1.0)
