"""The port's 2-D (clients x shard) server plane, per-axis collective
plans, ``--collective_plan auto`` and the multi-node seam
(``commefficient_torch/parallel/mesh.py``, ``ops/collectives.py``,
``federated/server.py``, ``federated/checkpoint.py``, ``telemetry.py``)
against the JAX package's single-process 2-D mesh on the forced CPU
devices (``--num_devices 2 --shard_devices 2``: clients = 2 x shard = 2),
mirroring ``tests/test_multihost.py``'s ``TestVirtual2DMesh``,
``TestEngine2D`` and ``TestPerAxisLedger`` and
``tests/test_compressed_collectives.py`` section 7.

Pure functions: the grid policy against ``default_client_mesh`` (sizes
and clamp warnings), ``leg_axis_entries``, ``resolve_leg_lowering`` and
the plan spellings (results and exceptions), the ledger's
``bytes_per_axis`` at the CIFAR10 sketch geometry (the >= 3.99x cut of
DCN bytes, ICI bytes unchanged), the ``auto`` probe fed JAX's uniforms
(``rel_err`` within 1e-6, the same plan), placement and the launch seams.

On 4 ``gloo`` ranks (``tests/torch_dist_ranks.py``, one spawn; the
process group numbered by the tuple index ``p = s * 2 + c``):

- the three hierarchical collectives given JAX's uniforms: payload sums
  and every level's carry bit for bit against eager ``shard_map`` over
  the 2 x 2 mesh, and conservation per level (``atol=5e-5``);
- the dense sharded server step under per-axis plans with JAX's
  uniforms (2 rounds): update, state and every level's carry bit for bit
  on integer-valued transmits, the carries tuples with None at float32
  levels;
- the tiny Dense round of ``TestVirtual2DMesh`` (8 slots, 3 rounds) in
  all five modes: the 2-D fp32 round equal to the port's 1-D four-rank
  round bit for bit; in sketch and uncompressed mode against JAX's 2-D
  mesh on dyadic data: each round's kept set and threshold (the smallest
  kept magnitude of the weight change) bit for bit, the weights within
  ``rtol=1e-6, atol=1e-7`` (XLA may contract ``g + momentum * v`` to an
  FMA); the per-axis plan's round finite, the ranks equal, within 5% of
  the fp32 run (JAX's bound), its carries tuples;
- run states: the 2-D run state restored on the 1-D plane and on the 2-D
  grid continues bit for bit, a per-axis run state restores its level
  carries exactly and a plan change re-initializes them with the JAX
  package's warnings, and a JAX 2-D run state with ``server/qres.1`` and
  ``server/dres.1`` restores in the port with its level carries;
- ``cv_train`` on 4 ranks placed on two "nodes" (``LOCAL_WORLD_SIZE =
  2``) with ``--shard_devices 2 --collective_plan ici:fp32/dcn:int8``:
  the clients axis rides ``dcn``, two rounds finish on every rank alike,
  and the run log's ``run_start`` carries the grid and ``bytes_per_axis``,
  which the root ``scripts/obs_report.py`` renders as its ICI/DCN split.
"""

import importlib.util
import json
import os
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

from commefficient_tpu.compat import shard_map  # noqa: E402
from commefficient_tpu.federated import server as JS  # noqa: E402
from commefficient_tpu.ops import collectives as J  # noqa: E402
from commefficient_tpu.parallel import mesh as JM  # noqa: E402
from commefficient_tpu.telemetry import collective_ledger as j_ledger  # noqa: E402
from commefficient_torch.ops import collectives as C  # noqa: E402
from commefficient_torch.parallel import mesh as TM  # noqa: E402
from commefficient_torch.telemetry import collective_ledger as t_ledger  # noqa: E402
from tests.torch_dist_ranks import start_ranks  # noqa: E402

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("shard", "clients")
W = 8
PER_AXIS_PLAN = "table=shard:fp32/clients:int8," \
                "downlink=shard:fp32/clients:int8"


# --------------------------------------------------------------------------
# pure functions
# --------------------------------------------------------------------------

def _clamp_warnings(caught):
    return [str(w.message) for w in caught
            if str(w.message).startswith("--")]


@pytest.mark.parametrize("num_workers,num_devices,shard,world", [
    (8, -1, 2, 4), (8, 2, 2, 4), (8, 4, 2, 8), (8, -1, 2, 8),
    (6, -1, 4, 8), (8, 3, 2, 8), (4, 8, 2, 2), (7, -1, 2, 8),
    (12, -1, 3, 8), (8, -1, 1, 4), (8, 2, 8, 8)])
def test_grid_is_the_jax_mesh_policy(num_workers, num_devices, shard, world):
    """``grid_shape`` against ``default_client_mesh`` over ``world``
    devices: the clients and shard sizes, and the clamp warnings word for
    word."""
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        mesh = JM.default_client_mesh(num_workers, num_devices,
                                      devices=jax.devices()[:world],
                                      shard_devices=shard)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = TM.grid_shape(num_workers, num_devices, shard, world)
    shape = dict(mesh.shape)
    assert got == (shape["clients"], shape.get("shard", 1))
    assert _clamp_warnings(tw) == _clamp_warnings(jw)
    if shard == 1:
        assert TM.client_group_size(num_workers, num_devices, world) == \
            got[0]


def test_tuple_index_placement_and_seams(monkeypatch):
    """Device ``i`` of a 2 x 2 grid sits at ``c = i // 2``, ``s = i % 2``
    with tuple index ``s * 2 + c``; the placement is JAX's on one
    process, ``clients`` rides ``dcn`` on several nodes and
    ``COMMEFFICIENT_FORCE_DCN_AXIS`` forces an axis; torchrun's
    environment and the JAX package's cohort seam give the world, and a
    seam without a coordinator raises JAX's ``ValueError``."""
    assert [TM.tuple_index(i, 2, 2) for i in range(5)] == [0, 2, 1, 3, 4]
    assert [TM.tuple_index(i, 4, 1) for i in range(4)] == [0, 1, 2, 3]
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("clients",
                                                            "shard"))
    for key in ("COMMEFFICIENT_FORCE_DCN_AXIS", "WORLD_SIZE",
                "COMMEFFICIENT_NUM_PROCS", "COMMEFFICIENT_COORDINATOR"):
        monkeypatch.delenv(key, raising=False)
    assert TM.mesh_axis_placement(2) == JM.mesh_axis_placement(mesh)
    assert TM.mesh_axis_placement(2, nodes=2) == {"clients": "dcn",
                                                  "shard": "ici"}
    monkeypatch.setenv("COMMEFFICIENT_FORCE_DCN_AXIS", "shard")
    assert TM.mesh_axis_placement(2) == JM.mesh_axis_placement(mesh)
    monkeypatch.delenv("COMMEFFICIENT_FORCE_DCN_AXIS")
    assert TM.world_from_env() is None
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    w = TM.world_from_env()
    assert (w.rank, w.size, w.local_rank, w.nodes, w.init_method) == \
        (3, 4, 1, 2, None)
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("COMMEFFICIENT_NUM_PROCS", "2")
    monkeypatch.setenv("COMMEFFICIENT_PROC_ID", "1")
    with pytest.raises(ValueError) as want:
        JM.maybe_init_distributed()
    with pytest.raises(ValueError) as got:
        TM.world_from_env()
    assert str(got.value) == str(want.value)
    monkeypatch.setenv("COMMEFFICIENT_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("LOCAL_RANK", "0")
    w = TM.world_from_env()
    assert (w.rank, w.size, w.local_rank, w.nodes, w.init_method) == \
        (1, 2, 0, 2, "tcp://localhost:1234")


def _same_outcome(j_fn, t_fn):
    """Both calls return equal values, or raise the same exception type
    with the same message."""
    try:
        want = j_fn()
    except (ValueError, AssertionError) as e:
        with pytest.raises(type(e)) as got:
            t_fn()
        assert str(got.value) == str(e)
        return None
    assert t_fn() == want
    return want


@pytest.mark.parametrize("value", [
    "ici:fp32/dcn:int8", "shard:fp32/clients:int4", "dcn:fp8",
    " ici : int8 / dcn:fp32 ", "int8", "float32", "ici:int16",
    "ici:int8/dcn", ":int8", "ici:int8/ici:fp32", "ici:int8//dcn:fp32"])
def test_leg_axis_entries_like_jax(value):
    _same_outcome(lambda: J.leg_axis_entries(value),
                  lambda: C.leg_axis_entries(value))
    if ":" in value:
        _same_outcome(lambda: J.leg_quantized(value),
                      lambda: C.leg_quantized(value))


ICI_DCN = {"shard": "ici", "clients": "dcn"}
ALL_ICI = {"shard": "ici", "clients": "ici"}


@pytest.mark.parametrize("value,axes,placement", [
    ("ici:fp32/dcn:int8", AXES, ICI_DCN),
    ("ici:fp32/dcn:int8", AXES, ALL_ICI),
    ("shard:fp32/clients:int8", AXES, ALL_ICI),
    ("shard:int8/clients:int8", AXES, ALL_ICI),
    ("clients:fp8", AXES, ICI_DCN),
    ("bogus:int8", AXES, ICI_DCN),
    ("ici:int8/shard:fp32", AXES, ALL_ICI),
    ("int8", AXES, ALL_ICI),
    ("dcn:int4", "clients", {"clients": "dcn"}),
    ("ici:int4/dcn:int8", AXES, ICI_DCN)])
def test_resolve_leg_lowering_like_jax(value, axes, placement):
    _same_outcome(
        lambda: J.resolve_leg_lowering(value, axes, placement),
        lambda: C.resolve_leg_lowering(value, axes, placement))


@pytest.mark.parametrize("spec", [
    "uplink=ici:fp32/dcn:int8", "ici:fp32/dcn:int8",
    "table=shard:fp32/clients:int8,downlink=dcn:int8",
    "downlink=dcn:fp8,uplink=int4", "uplink=ici:int16",
    "uplink=ici:int8/ici:int4", "table=dcn", "uplink=ici:int8/dcn"])
def test_per_axis_spellings_like_jax(spec):
    def parse(mod):
        plan = mod.parse_collective_plan(spec)
        return plan.spec(), plan.quantized, plan.per_axis

    _same_outcome(lambda: parse(J), lambda: parse(C))


def _geom(d=6_568_640, c=500_000, r=5):
    c_pad = -(-c // 128) * 128
    return SimpleNamespace(r=r, c_pad=c_pad, T=max(1, -(-d // c_pad)),
                           sublanes=c_pad // 128, d=d)


@pytest.mark.parametrize("mode", ["sketch", "uncompressed", "true_topk"])
def test_ledger_bytes_per_axis_like_jax(mode):
    """The ledger at the CIFAR10 sketch geometry (d = 6,568,640, 5 x
    500,000) on a (shard = 4) x (clients = 2) grid equals JAX's, per-axis
    legs and placements included; in sketch mode the plan that quantizes
    only the DCN hop cuts the DCN bytes >= 3.99x with the ICI bytes
    unchanged (JAX's acceptance ratio)."""
    geo = _geom()
    sizes = {"shard": 4, "clients": 2}
    q_low = {"uplink": (("shard", "float32"), ("clients", "int8")),
             "table": (("shard", "float32"), ("clients", "int8")),
             "downlink": (("shard", "float32"), ("clients", "int8"))}
    fp_low = {leg: (("shard", "float32"), ("clients", "float32"))
              for leg in q_low}
    spec = ("table=shard:fp32/clients:int8,downlink=shard:fp32/clients:int8"
            if mode == "sketch" else
            "uplink=shard:fp32/clients:int8,downlink=shard:fp32/clients:int8")
    split = {}
    for name, low, plan_spec in (("fp32", fp_low, ""), ("q", q_low, spec)):
        kw = dict(sketch=geo if mode == "sketch" else None, n_shard=8,
                  k=50_000, lowering=low, axis_sizes=sizes,
                  axis_placement=ICI_DCN)
        want = j_ledger(mode, geo.d, plan=J.parse_collective_plan(plan_spec),
                        **kw)
        got = t_ledger(mode, geo.d, plan=C.parse_collective_plan(plan_spec),
                       **kw)
        assert got == want
        out = {"ici": 0, "dcn": 0}
        for leg, row in got.items():
            for lvl in (row.get("bytes_per_axis") or {}).values():
                out[lvl["placement"]] += lvl["bytes_per_round"]
        split[name] = out
    assert split["fp32"]["ici"] == split["q"]["ici"]
    if mode == "sketch":
        assert split["fp32"]["dcn"] / split["q"]["dcn"] >= 3.99


@pytest.mark.parametrize("geoms,budget", [
    ({"table": (5 * 1024, 1024), "downlink": (8 * 4 * 128, 4 * 128)}, 0.05),
    ({"uplink": (70_000, 8192), "downlink": (70_000, 8192)}, 0.005),
    ({"uplink": (3_000, 8192), "downlink": (40_000, 8192)}, 0.2),
    ({"table": (3 * 640, 640)}, 0.02)])
def test_autotune_like_jax(geoms, budget):
    """``autotune_collective_plan`` fed JAX's uniforms (``uniform(key(seed),
    (nb, block))``, the draw JAX's probe makes for each leg) chooses JAX's
    plan, with each candidate's ``rel_err`` within 1e-6 and its bytes
    equal; the probe times are the port's own."""
    seed = 3
    want_plan, want = J.autotune_collective_plan(geoms, error_budget=budget,
                                                 seed=seed)
    u = {}
    for leg, (elems, block) in geoms.items():
        block = int(min(block, max(1, elems)))
        nb = max(1, min(elems, 1 << 20) // block)
        u[leg] = np.asarray(jax.random.uniform(jax.random.key(seed),
                                               (nb, block), jnp.float32))
    got_plan, got = C.autotune_collective_plan(geoms, error_budget=budget,
                                               seed=seed, u=u)
    assert got_plan.spec() == want_plan.spec()
    assert sorted(got) == sorted(want)
    for leg in want:
        assert sorted(got[leg]) == sorted(want[leg])
        for dt, row in want[leg].items():
            assert got[leg][dt]["bytes_per_round"] == row["bytes_per_round"]
            assert abs(got[leg][dt]["rel_err"] - row["rel_err"]) \
                <= 1e-6 + 1e-12, (leg, dt)
            assert got[leg][dt]["probe_ms"] >= 0


# --------------------------------------------------------------------------
# the JAX side of the spawn
# --------------------------------------------------------------------------

def _mesh2d():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("clients", "shard"))


def _axis_index(p, ax):
    s, c = divmod(p, 2)
    return s if ax == "shard" else c


def _level_u(key, lowering, shapes, p):
    """Rank ``p``'s uniforms a level: JAX folds the level into the leg's
    key, then the rank's index along the level's axis."""
    return [None if dt == "float32" else np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, lvl),
                           _axis_index(p, ax)),
        shapes[lvl], jnp.float32))
        for lvl, (ax, dt) in enumerate(lowering)]


def _u_scatter(size, n, block):
    tile = size // n
    return (n, -(-tile // block), block)


def _u_psum(size, n, block):
    blk = min(block, max(1, -(-size // n)))
    tile = -(-size // (n * blk)) * blk
    return (n, tile // blk, blk)


def _u_gather(size, block):
    return (-(-size // block), block)


def _hier_shapes(op, x_shape, block):
    """The uniforms' shape at each level (shard, clients) of a
    hierarchical collective of per-rank input ``x_shape``."""
    size = int(np.prod(x_shape))
    if op == "scatter":
        return [_u_scatter(size, 2, block), _u_scatter(size // 2, 2, block)]
    if op == "psum":
        return [_u_psum(size, 2, block), _u_psum(size, 2, block)]
    # the gather runs clients first: level 1's input is the rank's tile
    return [_u_gather(size * 2, block), _u_gather(size, block)]


def _res_shapes(op, x_shape):
    if op == "scatter":
        return [x_shape, (x_shape[0] // 2,) + tuple(x_shape[1:])]
    if op == "psum":
        return [x_shape, x_shape]
    return [(x_shape[0] * 2,) + tuple(x_shape[1:]), x_shape]


# each collective with one quantized level (the conservation cases) and
# the psum with both; the server step's cases quantize both levels of the
# scatter and the gather (an eager shard_map call costs seconds)
HIER_CASES = [
    ("scatter", (("shard", "float32"), ("clients", "int8")), (16, 8), 64,
     True),
    ("psum", (("shard", "float32"), ("clients", "int8")), (3, 50), 50,
     False),
    ("psum", (("shard", "int8"), ("clients", "fp8_e4m3")), (2, 40), 128,
     True),
    ("gather", (("shard", "float32"), ("clients", "int8")), (2, 1, 128),
     128, True),
]


def _hier_cases():
    rs = np.random.RandomState(5)
    cases = []
    for i, (op, low, shape, block, with_res) in enumerate(HIER_CASES):
        x = (rs.randn(4, *shape) * 2).astype(np.float32)
        res = None
        if with_res:
            res = [None if dt == "float32" else
                   (rs.randn(4, *sh) * 0.01).astype(np.float32)
                   for (_, dt), sh in zip(low, _res_shapes(op, shape))]
            if op == "psum":
                # a psum carry is the same on the shard siblings (its
                # level's input is), so the sum stays replicated
                res = [None if r is None else r[[0, 1, 0, 1]]
                       for r in res]
        key = jax.random.key(60 + i)
        shapes = _hier_shapes(op, shape, block)
        u = [None if dt == "float32" else np.stack(
            [_level_u(key, low, shapes, p)[lvl] for p in range(4)])
            for lvl, (_, dt) in enumerate(low)]
        cases.append({"op": op, "lowering": low, "x": x, "residuals": res,
                      "block": block, "u": u, "key": key})
    return cases


def _jax_hier(case):
    fn = {"scatter": J.hierarchical_psum_scatter, "psum": J.hierarchical_psum,
          "gather": J.hierarchical_all_gather}[case["op"]]
    low = case["lowering"]
    res = case["residuals"]
    slots = [lvl for lvl, r in enumerate(res or []) if r is not None]

    def inner(x, *rr):
        residuals = None
        if res is not None:
            residuals = [None] * len(low)
            for lvl, r in zip(slots, rr):
                residuals[lvl] = r[0]
        t, new = fn(x[0], low, case["key"], residuals=residuals,
                    block=case["block"])
        return (t[None],) + tuple(
            jnp.zeros((1,), jnp.float32) if r is None else r[None]
            for r in new)

    spec = P(AXES)
    outs = shard_map(inner, mesh=_mesh2d(),
                     in_specs=(spec,) * (1 + len(slots)),
                     out_specs=(spec,) * (1 + len(low)),
                     check_vma=False)(
        jnp.asarray(case["x"]), *[jnp.asarray(res[lvl]) for lvl in slots])
    return [np.asarray(o) for o in outs]


def _server_case(rs, mode, plan, force_dcn=None):
    d = 1003
    return {"mode": mode, "error_type": "virtual" if mode == "true_topk"
            else "none", "vm": 0.5, "k": 60, "d": d, "plan": plan,
            "lr": 0.5, "count": 8.0, "force_dcn": force_dcn,
            "transmits": [rs.randint(-50, 51, (4, d)).astype(np.float32)
                          for _ in range(2)]}


SERVER_CASES = [
    ("uncompressed", "uplink=shard:fp8/clients:int8,"
                     "downlink=shard:int4/clients:int8", None),
    ("uncompressed", "uplink=ici:fp32/dcn:int8,downlink=dcn:int4",
     "clients"),
]


def _server_cases():
    rs = np.random.RandomState(8)
    cases = []
    for mode, plan, force in SERVER_CASES:
        c = _server_case(rs, mode, plan, force)
        placement = ({"shard": "ici", "clients": "dcn"} if force
                     else ALL_ICI)
        jplan = J.parse_collective_plan(plan)
        low = {leg: J.resolve_leg_lowering(getattr(jplan, leg), AXES,
                                           placement)
               for leg in J.PLAN_LEGS}
        d_pad = -(-c["d"] // 4) * 4
        up, down = low["uplink"], low["downlink"]
        c["u"], c["keys"] = [], []
        for rnd in range(2):
            key = jax.random.key(100 + rnd)
            k_up = k_down = key
            if J.leg_quantized(up) and J.leg_quantized(down):
                k_up, k_down = jax.random.split(key)
            u = {}
            for leg, lv, k, shapes in (
                    ("up", up, k_up,
                     [_u_scatter(d_pad, 2, J.DEFAULT_QUANT_BLOCK),
                      _u_scatter(d_pad // 2, 2, J.DEFAULT_QUANT_BLOCK)]),
                    ("down", down, k_down,
                     [_u_gather(d_pad // 2, J.DEFAULT_QUANT_BLOCK),
                      _u_gather(d_pad // 4, J.DEFAULT_QUANT_BLOCK)])):
                u[leg] = tuple(None if dt == "float32" else np.stack(
                    [_level_u(k, lv, shapes, p)[lvl] for p in range(4)])
                    for lvl, (_, dt) in enumerate(lv))
            c["u"].append(u)
            c["keys"].append(key)
        c["jax_lowering"] = low
        cases.append(c)
    return cases


def _jax_server(c):
    """JAX's sharded server step under the case's lowering, eagerly (the
    quantizers' division by the scale stays a division), 2 rounds: per
    round the update and the state in their global layouts."""
    low = c["jax_lowering"]
    cfg = JS.ServerConfig(mode=c["mode"], error_type=c["error_type"],
                          k=c["k"], grad_size=c["d"],
                          virtual_momentum=c["vm"])
    sizes = {"shard": 2, "clients": 2}
    st = JS.init_server_state(cfg, None, shard_n=4,
                              plan=J.parse_collective_plan(c["plan"]),
                              lowering=low, axis_sizes=sizes)
    vec = P(AXES)

    def carry_spec(lv, down):
        if not isinstance(lv, tuple):
            return vec if lv != "float32" else None
        return tuple(None if dt == "float32" else
                     (P(AXES[:j + 1]) if down else vec)
                     for j, (_, dt) in enumerate(lv))

    spec = JS.ServerState(velocity=vec, error=vec,
                          qres=carry_spec(low["uplink"], False),
                          dres=carry_spec(low["downlink"], True))

    def inner(g, s, key):
        upd, new, _ = JS.sharded_server_update(
            g[0], s, cfg, c["lr"], jnp.float32(c["count"]), axis=AXES,
            n_shard=4, rng=key, plan=J.parse_collective_plan(c["plan"]),
            lowering=low)
        return upd, new

    f = shard_map(inner, mesh=_mesh2d(), in_specs=(vec, spec, P()),
                  out_specs=(P(), spec), check_vma=False)
    out = []
    for rnd in range(2):
        upd, st = f(jnp.asarray(c["transmits"][rnd]), st, c["keys"][rnd])
        out.append({"update": np.asarray(upd),
                    "vel": np.asarray(st.velocity),
                    "err": np.asarray(st.error),
                    "qres": tuple(None if q is None else np.asarray(q)
                                  for q in st.qres),
                    "dres": tuple(None if q is None else np.asarray(q)
                                  for q in st.dres)})
    return out


# the tiny Dense round (TestVirtual2DMesh's harness) on dyadic data, so
# every sum is exact in any order
def _dyadic(rs, shape, scale=8):
    return (rs.randint(-scale, scale + 1, shape) / scale).astype(np.float32)


def _tiny_batch(rnd):
    rs = np.random.RandomState(rnd)
    return {"inputs": _dyadic(rs, (W, 2, 3)),
            "targets": _dyadic(rs, (W, 2, 4)),
            "mask": np.ones((W, 2), np.float32),
            "client_ids": np.arange(W, dtype=np.int32),
            "worker_mask": np.ones(W, np.float32)}


MODE_FLAGS = {
    "sketch": ["--mode", "sketch", "--error_type", "virtual",
               "--local_momentum", "0", "--virtual_momentum", "0.5",
               "--k", "5", "--num_cols", "16", "--num_rows", "2",
               "--num_blocks", "1"],
    "uncompressed": ["--mode", "uncompressed", "--error_type", "none",
                     "--local_momentum", "0", "--virtual_momentum", "0.5"],
    "true_topk": ["--mode", "true_topk", "--error_type", "virtual",
                  "--local_momentum", "0.5", "--virtual_momentum", "0.5",
                  "--k", "3"],
    "local_topk": ["--mode", "local_topk", "--error_type", "local",
                   "--local_momentum", "0.5", "--virtual_momentum", "0",
                   "--k", "3"],
    "fedavg": ["--mode", "fedavg", "--error_type", "none",
               "--local_momentum", "0", "--virtual_momentum", "0.5",
               "--local_batch_size", "-1", "--fedavg_batch_size", "1"],
}
COMMON = ["--num_workers", str(W), "--num_clients", "16",
          "--num_epochs", "2", "--weight_decay", "0", "--server_shard",
          "--seed", "0", "--no_telemetry", "--dataset_name", "CIFAR10"]
GRID_2D = ["--num_devices", "2", "--shard_devices", "2"]
GRID_1D = ["--num_devices", "4"]


def _argv(mode, grid, extra=()):
    batch = [] if mode == "fedavg" else ["--local_batch_size", "2"]
    return MODE_FLAGS[mode] + COMMON + batch + grid + list(extra)


def _grid_runs():
    runs = []
    for mode in MODE_FLAGS:
        runs.append({"name": f"{mode} 2d", "argv": _argv(mode, GRID_2D),
                     "num_devices": 2, "shard": 2,
                     "save": mode == "sketch",
                     "restore": [(4, 1), (2, 2)]})
        runs.append({"name": f"{mode} 1d", "argv": _argv(mode, GRID_1D),
                     "num_devices": 4, "shard": 1})
    runs.append({"name": "sketch per-axis",
                 "argv": _argv("sketch", GRID_2D,
                               ["--collective_plan", PER_AXIS_PLAN]),
                 "num_devices": 2, "shard": 2, "save": True,
                 "restore": [(2, 2), (2, 2)],
                 "restore_argvs": [None, _argv("sketch", GRID_2D, [
                     "--collective_plan", "int8"])]})
    runs.append({"name": "uncompressed per-axis",
                 "argv": _argv("uncompressed", GRID_2D, [
                     "--collective_plan",
                     "uplink=shard:fp32/clients:int8,"
                     "downlink=shard:int8/clients:fp32"]),
                 "num_devices": 2, "shard": 2})
    return runs


def _tiny_jax(argv, flat0):
    import flax.linen as nn

    from commefficient_tpu.config import parse_args as j_parse
    from commefficient_tpu.federated.aggregator import (
        FedModel,
        FedOptimizer,
    )

    class Tiny(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            return nn.Dense(4, use_bias=False)(x)

    def loss(params, model_state, batch, rng, train):
        pred = Tiny().apply({"params": params}, batch["inputs"])
        err = pred - batch["targets"]
        mask = batch["mask"]
        return jnp.sum(jnp.square(err).mean(-1) * mask), (), \
            jnp.sum(mask), model_state

    args = j_parse(argv=argv)
    init = {"Dense_0": {"kernel": jnp.asarray(flat0.reshape(3, 4))}}
    fm = FedModel(Tiny(), loss, args, input_shape=(3,), init_params=init)
    opt = FedOptimizer(fm, args)
    opt.set_lr_factor(0.5)
    return fm, opt


def _jax_rounds(argv, flat0, batches, save=None):
    """JAX's rounds on its 2-D mesh from ``flat0``: the weights after
    each; ``save``: the run state written after the rounds."""
    from commefficient_tpu.federated.aggregator import LambdaLR
    from commefficient_tpu.federated.checkpoint import save_run_state

    fm, opt = _tiny_jax(argv, flat0)
    assert dict(fm.mesh.shape) == {"clients": 2, "shard": 2}
    np.testing.assert_array_equal(np.asarray(ravel_pytree(fm.params)[0]),
                                  flat0)
    ws = []
    for b in batches:
        fm({k: jnp.asarray(v) for k, v in b.items()})
        opt.step()
        ws.append(np.asarray(ravel_pytree(fm.params)[0]))
    if save is not None:
        save_run_state(save, fm, opt, LambdaLR(opt, lambda s: 0.5),
                       next_epoch=1)
    return ws, fm, opt


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """One spawn of 4 ranks runs every body of this file while the parent
    computes JAX's side."""
    tmp = tmp_path_factory.mktemp("multi2d")
    hier = _hier_cases()
    server = _server_cases()
    batches = [_tiny_batch(r) for r in range(3)]
    # the JAX 2-D run's initial weights, dyadic, and its per-axis run
    # state (written first: the port restores it)
    flat0 = _dyadic(np.random.RandomState(42), (12,), 4)
    jax_state = str(tmp / "jax_per_axis")
    jpa_argv = _argv("sketch", GRID_2D, ["--collective_plan", PER_AXIS_PLAN])
    jax_pa, jfm_pa, jopt_pa = _jax_rounds(jpa_argv, flat0, batches[:2],
                                          save=jax_state)
    spec = {"W": W, "num_clients": 16, "lr": 0.5, "flat0": flat0,
            "batches": batches, "save_at": 2, "dir": str(tmp),
            "runs": _grid_runs()}
    jax_spec = dict(spec, batches=batches[2:], save_at=0, runs=[
        {"name": "jax per-axis state", "argv": jpa_argv,
         "num_devices": 2, "shard": 2, "load": jax_state + ".npz"}])
    cli = {"argv": ["--device", "cpu", "--dataset_name", "CIFAR10",
                    "--dataset_dir", str(tmp / "data"), "--num_epochs", "1",
                    "--num_workers", "4", "--local_batch_size", "4",
                    "--iid", "--num_clients", "8", "--mode", "sketch",
                    "--error_type", "virtual", "--local_momentum", "0",
                    "--virtual_momentum", "0.9", "--k", "500",
                    "--num_cols", "2048", "--num_rows", "3",
                    "--num_blocks", "2", "--lr_scale", "0.01",
                    "--pivot_epoch", "0.5", "--seed", "0",
                    "--server_shard", "--num_devices", "2",
                    "--shard_devices", "2", "--collective_plan",
                    "ici:fp32/dcn:int8", "--telemetry"],
           "env": {"COMMEFFICIENT_TINY_MODEL": "1",
                   "COMMEFFICIENT_SYNTHETIC_PER_CLASS": "4",
                   "COMMEFFICIENT_RUN_DIR": str(tmp / "run")},
           "local_world": 2}
    items = [("body_hier", hier), ("body_server_2d", server),
             ("body_grid_rounds", spec), ("body_grid_rounds", jax_spec),
             ("cli_cv_train", cli)]
    with start_ranks(4, items, tmp) as ranks, ThreadPoolExecutor(3) as pool:
        jh = [pool.submit(_jax_hier, c) for c in hier]
        js = [pool.submit(_jax_server, c) for c in server]
        jrounds = {mode: _jax_rounds(_argv(mode, GRID_2D), flat0, batches)[0]
                   for mode in ("sketch", "uncompressed")}
        want_hier = [f.result() for f in jh]
        want_server = [f.result() for f in js]
        outs = ranks.join()
    return {"hier": (hier, want_hier, outs[0]),
            "server": (server, want_server, outs[1]),
            "rounds": (spec, jrounds, outs[2]),
            "jax_state": (jax_pa, jfm_pa, jopt_pa, outs[3]),
            "cli": (outs[4], tmp / "run"), "flat0": flat0,
            "batches": batches}


# --------------------------------------------------------------------------
# across ranks
# --------------------------------------------------------------------------

def _u32(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_hierarchical_collectives_equal_jax(spawned):
    """Outputs and every level's carry bit for bit given JAX's uniforms;
    None at float32 levels."""
    cases, want, outs = spawned["hier"]
    for i, case in enumerate(cases):
        what = f"{case['op']} {case['lowering']}"
        for p in range(4):
            got = outs[p][i]
            np.testing.assert_array_equal(_u32(got["out"]),
                                          _u32(want[i][0][p]), err_msg=what)
            for lvl, (_, dt) in enumerate(case["lowering"]):
                if dt == "float32":
                    assert got["res"][lvl] is None, what
                else:
                    np.testing.assert_array_equal(
                        _u32(got["res"][lvl]), _u32(want[i][1 + lvl][p]),
                        err_msg=f"{what} level {lvl} rank {p}")


def test_hierarchical_conservation_per_level(spawned):
    """What each quantized level sent plus its new carries is what it was
    given plus its old carries (JAX's ``atol=5e-5``): the scatter's
    clients level per destination, the table psum's sum, the gather's
    emitted tiles."""
    cases, _, outs = spawned["hier"]
    # scatter, shard fp32 / clients int8: destination p' = s * 2 + c'
    case = cases[0]
    x, res1 = case["x"], case["residuals"][1]
    per = x.shape[1] // 4
    total = x.sum(0)
    for p in range(4):
        s, c = divmod(p, 2)
        sib = [s * 2 + cc for cc in range(2)]
        exact = total[p * per:(p + 1) * per] + sum(
            res1[q][c * per:(c + 1) * per] for q in sib)
        sent = outs[p][0]["out"] + sum(
            outs[q][0]["res"][1][c * per:(c + 1) * per] for q in sib)
        np.testing.assert_allclose(sent, exact, atol=5e-5)
    # psum, shard fp32 / clients int8 (no old carry): every rank's sum is
    # the same, and sum + the clients pair's carries is the exact sum
    case = cases[1]
    out = [outs[p][1]["out"] for p in range(4)]
    for p in range(1, 4):
        np.testing.assert_array_equal(out[p], out[0])
    got = out[0] + outs[0][1]["res"][1] + outs[1][1]["res"][1]
    np.testing.assert_allclose(got, case["x"].sum(0), atol=1e-4)
    # gather, shard fp32 / clients int8: chunk p of the gathered array
    # plus rank p's new carry is its tile plus its old carry
    case = cases[3]
    full = outs[0][3]["out"].reshape((4,) + case["x"].shape[1:])
    for p in range(4):
        np.testing.assert_array_equal(outs[p][3]["out"], outs[0][3]["out"])
        np.testing.assert_allclose(
            full[p] + outs[p][3]["res"][1],
            case["x"][p] + case["residuals"][1][p], atol=5e-5)


def test_per_axis_server_step_equal_jax(spawned):
    """The dense sharded server step under per-axis plans (the forced-DCN
    alias included), 2 rounds with JAX's uniforms: the lowering is JAX's,
    and the update, the state slices and every level's carry (a tuple,
    None at float32 levels) equal JAX's bit for bit."""
    from commefficient_torch.federated.checkpoint import _carry_part

    cases, want, outs = spawned["server"]
    for i, c in enumerate(cases):
        for p in range(4):
            got = outs[p][i]
            assert got["lowering"] == c["jax_lowering"]
            group = SimpleNamespace(rank=p, size=4)
            shard = SimpleNamespace(rank=p // 2, size=2)
            for rnd in range(2):
                g, w = got["rounds"][rnd], want[i][rnd]
                what = f"{c['plan']} rank {p} round {rnd}"
                np.testing.assert_array_equal(_u32(g["update"]),
                                              _u32(w["update"]), what)
                per = g["vel"].shape[0]
                for key in ("vel", "err"):
                    np.testing.assert_array_equal(
                        _u32(g[key]), _u32(w[key][p * per:(p + 1) * per]),
                        f"{what} {key}")
                for name in ("qres", "dres"):
                    low = c["jax_lowering"]["uplink" if name == "qres"
                                            else "downlink"]
                    assert isinstance(g[name], tuple), what
                    for j, (_, dt) in enumerate(low):
                        if dt == "float32":
                            assert g[name][j] is None
                            continue
                        tiles = shard if j == 0 else group
                        part = _carry_part(w[name][j], name,
                                           g[name][j].shape, group, tiles)
                        np.testing.assert_array_equal(
                            _u32(g[name][j]), _u32(part),
                            f"{what} {name}.{j}")
                        if rnd == 1:
                            assert np.abs(g[name][j]).max() > 0


def _runs_by_name(outs):
    return [{r["name"]: r for r in
             ({**rec, "name": name} for rec, name in
              zip(o, [run["name"] for run in _grid_runs()]))}
            for o in outs]


def test_2d_fp32_round_equals_1d_round_in_all_modes(spawned):
    """THE transparency pin: on the same four ranks, the 2-D (clients x
    shard) fp32 round and the 1-D clients round give the same weights
    after each of 3 rounds, bit for bit, in all five modes; the ranks
    agree; the 2-D ranks reduce over ``("shard", "clients")``."""
    _, _, outs = spawned["rounds"]
    runs = _runs_by_name(outs)
    for mode in MODE_FLAGS:
        for p in range(4):
            r2, r1 = runs[p][f"{mode} 2d"], runs[p][f"{mode} 1d"]
            assert r2["axes"] == AXES and r2["sizes"] == {"shard": 2,
                                                          "clients": 2}
            assert r1["axes"] == "clients"
            assert r2["rank"] == p
            for rnd, (a, b) in enumerate(zip(r2["w"], r1["w"])):
                np.testing.assert_array_equal(
                    _u32(a), _u32(b), f"{mode} rank {p} round {rnd}")
                np.testing.assert_array_equal(
                    _u32(a), _u32(runs[0][f"{mode} 2d"]["w"][rnd]))
            assert np.isfinite(r2["w"][-1]).all()
        assert not np.array_equal(runs[0][f"{mode} 2d"]["w"][-1],
                                  spawned["flat0"]), mode


@pytest.mark.parametrize("mode", ["sketch", "uncompressed"])
def test_2d_round_matches_jax_2d_mesh(mode, spawned):
    """The port's 2-D round against JAX's 2-D mesh, 3 rounds on dyadic
    data: each round's kept set and threshold bit for bit, the weights
    within ``rtol=1e-6, atol=1e-7``."""
    _, jrounds, outs = spawned["rounds"]
    runs = _runs_by_name(outs)
    prev_t = prev_j = spawned["flat0"]
    for rnd, (tw, jw) in enumerate(zip(runs[0][f"{mode} 2d"]["w"],
                                       jrounds[mode])):
        dt, dj = prev_t - tw, prev_j - jw
        np.testing.assert_array_equal(dt != 0, dj != 0,
                                      f"{mode} round {rnd} kept set")
        if (dt != 0).any():
            np.testing.assert_array_equal(
                _u32(np.abs(dt[dt != 0]).min()),
                _u32(np.abs(dj[dj != 0]).min()),
                f"{mode} round {rnd} threshold")
        np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
        prev_t, prev_j = tw, jw


def test_per_axis_plan_round_and_carries(spawned):
    """The per-axis plan on the 2-D grid: its lowering is JAX's, its
    carries are tuples (None at the fp32 shard level, live at the
    quantized clients level), its 3 rounds are finite, equal on every
    rank and within 5% of the fp32 run (JAX's bound), in sketch and in
    the dense mode."""
    _, _, outs = spawned["rounds"]
    runs = _runs_by_name(outs)
    for name, base, legs in (("sketch per-axis", "sketch 2d",
                              ("qres", "dres")),
                             ("uncompressed per-axis", "uncompressed 2d",
                              ("qres", "dres"))):
        moved = {leg: 0.0 for leg in legs}
        for p in range(4):
            r = runs[p][name]
            w, wf = r["w"][-1], runs[p][base]["w"][-1]
            assert np.isfinite(w).all()
            np.testing.assert_array_equal(_u32(w),
                                          _u32(runs[0][name]["w"][-1]))
            assert np.abs(w - wf).max() / max(np.abs(wf).max(), 1e-12) < 0.05
            for leg in legs:
                carry = r["state"][leg]
                assert isinstance(carry, tuple) and len(carry) == 2
                live = [j for j, c in enumerate(carry) if c is not None]
                assert len(live) == 1, (name, leg, live)
                moved[leg] = max(moved[leg],
                                 float(np.abs(carry[live[0]]).max()))
        # a rank whose update tile is all padding carries zeros
        assert all(v > 0 for v in moved.values()), (name, moved)
    assert runs[0]["sketch per-axis"]["lowering"] == {
        "uplink": "float32",
        "table": (("shard", "float32"), ("clients", "int8")),
        "downlink": (("shard", "float32"), ("clients", "int8"))}


def test_elastic_and_per_axis_restores(spawned):
    """The 2-D fp32 run state restores onto the 1-D four-rank plane and
    onto the 2-D grid without a carry warning: the weights and the server
    state equal the saving run's, and the continued round equals its
    round bit for bit. The per-axis run state restores its level carries
    exactly and continues bit for bit; restored under the flat int8 plan,
    its levels' keys do not match and the carries start from zero with
    the JAX package's warnings."""
    _, _, outs = spawned["rounds"]
    runs = _runs_by_name(outs)
    for p in range(4):
        src = runs[p]["sketch 2d"]
        for got in src["restored"]:
            assert got["warnings"] == []
            np.testing.assert_array_equal(_u32(got["w"][-1]),
                                          _u32(src["w"][-1]))
            np.testing.assert_array_equal(_u32(got["w_load"]),
                                          _u32(src["w"][1]))
        np.testing.assert_array_equal(
            _u32(src["restored"][0]["state"]["vel"]),
            _u32(src["state"]["vel"]))
        pa = runs[p]["sketch per-axis"]
        same, flat = pa["restored"]
        assert same["warnings"] == []
        np.testing.assert_array_equal(_u32(same["w"][-1]), _u32(pa["w"][-1]))
        for leg in ("qres", "dres"):
            assert same["state"][leg][0] is None
            np.testing.assert_array_equal(_u32(same["state"][leg][1]),
                                          _u32(pa["state"][leg][1]))
        assert sorted(flat["warnings"]) == sorted([
            "checkpoint has no matching server/qres carry; re-initializing "
            "the quantized-reduce residual to zero",
            "checkpoint has no matching server/dres carry; re-initializing "
            "the quantized-downlink residual to zero"])
        assert not isinstance(flat["at_load"]["qres"], tuple)
        assert not np.abs(flat["at_load"]["qres"]).any()


def test_jax_per_axis_run_state_restores_in_the_port(spawned):
    """A JAX 2-D run state written under the per-axis plan (with
    ``server/qres.1`` and ``server/dres.1``) restores in the port's 2-D
    grid: each rank's level carries are its part of JAX's global arrays,
    bit for bit, the weights are JAX's, and the third round runs finite
    and equal on every rank."""
    from commefficient_torch.federated.checkpoint import _carry_part

    jax_w, jfm, jopt, outs = spawned["jax_state"]
    qres, dres = jopt.server_state.qres, jopt.server_state.dres
    assert qres[0] is None and dres[0] is None
    assert np.abs(np.asarray(qres[1])).max() > 0
    assert np.abs(np.asarray(dres[1])).max() > 0
    for p in range(4):
        got = outs[p][0]
        assert got["warnings"] == []
        np.testing.assert_array_equal(_u32(got["w_load"]), _u32(jax_w[-1]))
        group = SimpleNamespace(rank=p, size=4)
        q = got["at_load"]["qres"][1]
        np.testing.assert_array_equal(
            _u32(q), _u32(_carry_part(np.asarray(qres[1]), "qres", q.shape,
                                      group, group)))
        d = got["at_load"]["dres"][1]
        np.testing.assert_array_equal(
            _u32(d), _u32(_carry_part(np.asarray(dres[1]), "dres", d.shape,
                                      group, group)))
        assert np.isfinite(got["w"][-1]).all()
        np.testing.assert_array_equal(_u32(got["w"][-1]),
                                      _u32(outs[0][0]["w"][-1]))


def test_cv_train_on_two_nodes_of_a_2d_grid(spawned):
    """``cv_train.main`` on 4 gloo ranks that torchrun's environment
    places on two nodes (``LOCAL_WORLD_SIZE = 2``), ``--shard_devices 2
    --collective_plan ici:fp32/dcn:int8``: every rank ends with the same
    finite summary; rank 0's ``run_start`` records the grid (clients on
    ``dcn``, shard on ``ici``, 4 processes on 2 nodes), the resolved plan
    and ``bytes_per_axis`` (the DCN level int8, the ICI level float32),
    and the root ``scripts/obs_report.py`` renders the ICI/DCN split."""
    outs, run_dir = spawned["cli"]
    outs = [dict(o) for o in outs]
    for o in outs:
        o.pop("train_time")
        o.pop("total_time")
    assert all(o == outs[0] for o in outs)
    assert np.isfinite(outs[0]["train_loss"])
    path = os.path.join(str(run_dir), "telemetry.jsonl")
    with open(path) as f:
        events = [json.loads(line) for line in f]
    start = next(e for e in events if e["ev"] == "run_start")
    assert start["mesh"]["process_count"] == 4
    assert start["mesh"]["nodes"] == 2
    assert {a["name"]: (a["size"], a["placement"])
            for a in start["mesh"]["axes"]} == {"clients": (2, "dcn"),
                                                "shard": (2, "ici")}
    row = start["ledger"]["transmit_reduce"]
    assert row["collective"] == "hierarchical_psum (per-axis)"
    assert {ax: (lvl["dtype"], lvl["placement"])
            for ax, lvl in row["bytes_per_axis"].items()} == {
        "shard": ("float32", "ici"), "clients": ("int8", "dcn")}
    assert sum(1 for e in events if e["ev"] == "round") >= 2
    spec = importlib.util.spec_from_file_location(
        "obs_report", os.path.join(_REPO, "scripts", "obs_report.py"))
    obs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(obs)
    import io

    buf = io.StringIO()
    obs.render(obs.load_events(path), out=buf)
    text = buf.getvalue()
    assert "per-axis wire split" in text and "DCN" in text
