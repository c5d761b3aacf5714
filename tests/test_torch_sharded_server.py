"""The port's sharded server step (``federated/server.py::
sharded_server_update``, ``--server_shard``) on 2 and 4 ``gloo`` ranks
(``tests/torch_dist_ranks.py``) against the JAX package's
``sharded_server_update`` under ``shard_map`` over a 2- and 4-device
slice of the 8-device CPU mesh, mirroring ``tests/test_sharded_server.py``
and ``tests/test_compressed_collectives.py``.

Each rank passes the same transmit into the server step as JAX's shard
of that index. The reduced transmit equals the sum bit for bit: at n = 2
for any float32 values (a sum of two addends has one order), at n = 4 on
integer-valued transmits (every order is exact). Downstream of it the
threshold, the kept set and every ``== 0`` pattern (update, velocity,
error, the re-sketch) are JAX's bit for bit, and the values are within
``tests/test_torch_server.py``'s ``rtol=1e-6, atol=1e-7`` (XLA may
contract ``g + momentum * v`` to an FMA). One n = 4 case takes
real-valued transmits, whose 4-addend sums may round differently:
its update is held with ``allclose(rtol=1e-5, atol=1e-6)`` and its kept
set overlap at 0.98 or more. All five modes and the fused epilogue run.
The port's sharded step equals its replicated step (the all-reduced
transmit into ``server_update``) at the same n bit for bit.

Under a quantized plan (``uplink=int8,downlink=fp8_e4m3`` dense,
``table=int8,downlink=int4`` sketch) the carries exist and move, the
downlink's error-feedback identity holds (the gathered tile plus the new
carry equals the exact tile plus the old one, JAX's ``atol=5e-6``
relative to the values), and one round's update stays within 10%
(relative L2) of the fp32 plan's: an fp8 element keeps 3 mantissa bits
and an int4 one 1 part in 7 of its block's largest (3.9% and 5.8% here),
and the sketch's kept set may move with the table's rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from commefficient_tpu.compat import shard_map  # noqa: E402
from commefficient_tpu.federated import server as JS  # noqa: E402
from commefficient_tpu.ops.sketch import make_sketch as j_make_sketch  # noqa: E402
from tests.torch_dist_ranks import start_ranks  # noqa: E402

D_SKETCH, C, R, K = 1100, 100, 3, 50   # c_pad 128, T = 9 chunks
D_DENSE = 1001


def _case(n, rs, mode, error_type="virtual", vm=0.9, fused=False,
          integer=True, lr=0.5, plan="", rounds=1):
    sketch = mode == "sketch"
    d = D_SKETCH if sketch else D_DENSE
    shape = (R, 128) if sketch else (d,)
    if integer:
        tr = rs.randint(-50, 51, (n,) + shape).astype(np.float32)
    else:
        tr = (rs.randn(n, *shape) * 10).astype(np.float32)
    st_shape = (R, 128) if sketch else (d,)
    return dict(mode=mode, error_type=error_type, vm=vm, fused=fused,
                k=K, d=d, c=C, r=R, seed=5, transmits=tr,
                vel0=rs.randn(*st_shape).astype(np.float32),
                err0=rs.randn(*st_shape).astype(np.float32)
                if error_type == "virtual" else
                np.zeros(st_shape, np.float32),
                lr=1.0 if mode == "fedavg" else lr, count=7.0, plan=plan,
                rounds=rounds, integer=integer)


def _cases(n):
    rs = np.random.RandomState(10 + n)
    integer = n != 2
    cases = [
        _case(n, rs, "sketch", integer=integer),
        _case(n, rs, "sketch", fused=True, integer=integer),
        _case(n, rs, "sketch", error_type="local", vm=0.0, integer=integer),
        _case(n, rs, "true_topk", integer=integer),
        _case(n, rs, "uncompressed", error_type="none", integer=integer),
        _case(n, rs, "local_topk", error_type="none", integer=integer),
        _case(n, rs, "fedavg", error_type="none", vm=0.5, integer=integer),
    ]
    if n == 4:
        cases.append(_case(n, rs, "sketch", integer=False))
    else:
        cases.append(_case(n, rs, "uncompressed", error_type="none", lr=1.0,
                           plan="uplink=int8,downlink=fp8_e4m3", rounds=2))
        cases.append(_case(n, rs, "sketch", plan="table=int8,downlink=int4",
                           rounds=2))
    return cases


def _jax_step(c, n):
    """JAX's sharded step on this case: (update, velocity, error,
    re-sketch) in their global layouts."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("clients",))
    sketch = c["mode"] == "sketch"
    scfg = JS.ServerConfig(mode=c["mode"], error_type=c["error_type"],
                           k=c["k"], grad_size=c["d"],
                           virtual_momentum=c["vm"],
                           fused_epilogue=c["fused"])
    sk = layout = None
    if sketch:
        sk = j_make_sketch(c["d"], c["c"], c["r"], seed=c["seed"],
                           num_blocks=1)
        layout = sk.chunk_layout
    st = JS.init_server_state(scfg, sk, shard_n=n)
    vel, err = c["vel0"], c["err0"]
    if not sketch:
        pad = st.velocity.shape[0] - c["d"]
        vel, err = np.pad(vel, (0, pad)), np.pad(err, (0, pad))
    st = st._replace(velocity=jnp.asarray(vel), error=jnp.asarray(err))
    vspec = P() if sketch else P("clients")
    spec = JS.ServerState(velocity=vspec, error=vspec, qres=None, dres=None)

    def inner(g, s, lr, count):
        upd, new, rs = JS.sharded_server_update(
            g[0], s, scfg, lr, count, axis="clients", n_shard=n, sketch=sk,
            layout=layout, rng=jax.random.key(0))
        if rs is None:
            rs = jnp.zeros((1,), jnp.float32)
        return upd, new, rs

    f = jax.jit(shard_map(inner, mesh=mesh,
                          in_specs=(P("clients"), spec, P(), P()),
                          out_specs=(P(), spec, P()), check_vma=False))
    upd, new, rs = f(jnp.asarray(c["transmits"]), st,
                     jnp.float32(c["lr"]), jnp.float32(c["count"]))
    return (np.asarray(upd), np.asarray(new.velocity),
            np.asarray(new.error), np.asarray(rs) if sketch else None)


def _same_zeros(a, b, what):
    np.testing.assert_array_equal(a == 0, b == 0, err_msg=what + " == 0")


def _bits_equal(a, b, what):
    np.testing.assert_array_equal(np.asarray(a).view(np.uint32),
                                  np.asarray(b).view(np.uint32),
                                  err_msg=what)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 4 ranks: the 2-rank cases on ranks 0-1, then the
    4-rank cases; JAX's steps are computed while the ranks run."""
    cases = {n: _cases(n) for n in (2, 4)}
    with start_ranks(4, [("body_server", cases[n], n) for n in (2, 4)],
                     tmp_path_factory.mktemp("sharded_server")) as ranks:
        want = {n: [None if c["plan"] else _jax_step(c, n)
                    for c in cases[n]] for n in (2, 4)}
        outs = dict(zip((2, 4), ranks.join()))
    return {n: (cases[n], want[n], outs[n]) for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_server_step_against_jax(n, spawned):
    cases, want, outs = spawned[n]
    for i, c in enumerate(cases):
        what = (f"n={n} {c['mode']} {c['error_type']} fused={c['fused']} "
                f"plan={c['plan']!r}")
        ranks = [o[i] for o in outs]
        if c["plan"]:
            _check_quantized(c, ranks, n, what)
            continue
        ju, jv, je, jrs = want[i]
        sketch = c["mode"] == "sketch"
        exact = c["integer"] or n == 2
        for r, o in enumerate(ranks):
            got = o["rounds"][0]
            if exact:
                _bits_equal(o["reduced"], c["transmits"].sum(0),
                            what + " reduced transmit")
            if sketch:
                jv_r, je_r = jv, je
            else:
                per = got["vel"].shape[0]
                jv_r, je_r = (jv[r * per:(r + 1) * per],
                              je[r * per:(r + 1) * per])
            if exact:
                _same_zeros(got["update"], ju, what + " update")
                for name, a, b in (("velocity", got["vel"], jv_r),
                                   ("error", got["err"], je_r)):
                    _same_zeros(a, b, what + " " + name)
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                               err_msg=what + " " + name)
                np.testing.assert_allclose(got["update"], ju, rtol=1e-6,
                                           atol=1e-7, err_msg=what)
                if sketch:
                    _same_zeros(got["resketched"], jrs, what + " resketch")
                    np.testing.assert_allclose(got["resketched"], jrs,
                                               rtol=1e-5, atol=1e-5)
            else:
                np.testing.assert_allclose(got["update"], ju, rtol=1e-5,
                                           atol=1e-6, err_msg=what)
                a, b = set(np.flatnonzero(got["update"])), \
                    set(np.flatnonzero(ju))
                assert len(a & b) >= 0.98 * max(len(a), len(b)), what
            # the port's sharded step equals its replicated step
            _bits_equal(got["update"], o["rep_update"], what + " vs rep")
            if sketch:
                _bits_equal(got["vel"], o["rep_vel"], what + " vel vs rep")
                _bits_equal(got["err"], o["rep_err"], what + " err vs rep")
        if not sketch:
            for name in ("vel", "err"):
                full = np.concatenate([o["rounds"][0][name] for o in ranks])
                _bits_equal(full[:c["d"]], ranks[0]["rep_" + name],
                            f"{what} {name} vs rep")
        for o in ranks[1:]:
            _bits_equal(o["rounds"][0]["update"],
                        ranks[0]["rounds"][0]["update"],
                        what + " replicated update")


def _check_quantized(c, ranks, n, what):
    """Carries exist and move; the downlink identity; the update within
    10% of the fp32 plan's (the replicated step's)."""
    for o in ranks:
        for rnd in o["rounds"]:
            assert rnd["qres"] is not None and rnd["dres"] is not None
            assert np.isfinite(rnd["update"]).all()
            assert np.abs(rnd["qres"]).max() > 0
            assert np.abs(rnd["dres"]).max() > 0
        first = o["rounds"][0]
        ref = o["rep_update"]
        rel = np.linalg.norm(first["update"] - ref) / np.linalg.norm(ref)
        assert rel < 0.10, (what, rel)
    if c["mode"] == "uncompressed":
        # the update is the velocity tile (lr = 1): the gathered tile
        # plus the new downlink carry is the exact tile plus the old
        for rnd in range(len(ranks[0]["rounds"])):
            full = ranks[0]["rounds"][rnd]["update"]
            for r, o in enumerate(ranks):
                got = o["rounds"][rnd]
                per = got["vel"].shape[0]
                tile = np.pad(full, (0, per * n - full.shape[0]))[
                    r * per:(r + 1) * per]
                scale = np.abs(got["vel"]).max()
                np.testing.assert_allclose(
                    tile + got["dres"], got["vel"] + got["old_dres"],
                    atol=5e-6 * scale, err_msg=what)
