"""The port's opt-in sketch round (``--stream_sketch --sketch_coalesce
--fused_epilogue``, and the one-launch top-k descent under
``COMMEFFICIENT_PALLAS_TOPK_FUSED=1``) against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode. Integer and
permutation math is compared bit for bit:

- the running-table accumulate, from a random incoming table, over
  unaligned segments that straddle chunk boundaries (``assert_array_equal``
  treats +0.0 and -0.0 as equal, the one documented deviation of a segment
  fold: the sign of an all-zero cell);
- the leaf layout and the coalescing plan;
- the fused epilogue's update (bit patterns) and table (``==``: the JAX
  kernel adds +0.0 at masked positions where the port adds sign * 0.0),
  and the port's fused pair against its own composed pair, zero signs
  included;
- the one-launch descent's threshold.

Subnormals are kept out of the JAX comparisons (XLA on the CPU flushes
them to zero). Rounds are compared with the tolerances of
``tests/test_torch_rounds.py``, for the reasons stated there.
"""

import importlib
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from commefficient_tpu.config import parse_args as j_parse  # noqa: E402
from commefficient_tpu.federated import FedModel as JFedModel  # noqa: E402
from commefficient_tpu.federated import FedOptimizer as JFedOptimizer  # noqa: E402
from commefficient_tpu.federated.losses import make_cv_losses as j_losses  # noqa: E402
from commefficient_tpu.models import ResNet9 as JResNet9  # noqa: E402
from commefficient_tpu.ops import flat as jflat  # noqa: E402
from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch import kernels  # noqa: E402
from commefficient_torch.config import parse_args as t_parse  # noqa: E402
from commefficient_torch.convert import flat_from_jax  # noqa: E402
from commefficient_torch.federated import FedModel, FedOptimizer  # noqa: E402
from commefficient_torch.federated.losses import make_cv_losses as t_losses  # noqa: E402
from commefficient_torch.federated.rounds import (  # noqa: E402
    ClientStates,
    RoundConfig,
    build_round_step,
)
from commefficient_torch.federated.server import ServerConfig  # noqa: E402
from commefficient_torch.federated.worker import WorkerConfig  # noqa: E402
from commefficient_torch.models import ResNet9  # noqa: E402
from commefficient_torch.ops import flat as tflat  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from tests.test_torch_rounds import (  # noqa: E402
    ARGV,
    LR,
    NCLIENTS,
    TINY,
    B,
    W,
    _batch,
)

jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")

OPT_IN = ["--stream_sketch", "--sketch_coalesce", "--fused_epilogue"]


def _pair(d, c, r, seed):
    return (jsk.make_sketch(d, c, r, seed=seed, num_blocks=2),
            tsk.make_sketch(d, c, r, seed=seed, num_blocks=2, device="cpu"))


def _rand(shape, seed, special=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if special:
        f = x.reshape(-1)
        f[3], f[10], f[41] = np.inf, -np.inf, -0.0
    return x


def _bits_equal(a, b):
    """Equal NaN positions and equal bit patterns elsewhere (zero signs
    included)."""
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.int32)[~nan],
                                  b.view(np.int32)[~nan])


# ---- the running-table accumulate ----------------------------------------

ACC_GEOMS = [(31_640, 2048, 3, 0), (5000, 300, 5, 7), (9001, 700, 4, 2)]


@pytest.mark.parametrize("d,c,r,seed", ACC_GEOMS)
def test_segment_accum_bit_equal_to_jax_interpret(d, c, r, seed):
    """Leaf by leaf from a random table, including the unaligned segment
    [137, c_pad + 501) that straddles the first chunk boundary."""
    js, ts = _pair(d, c, r, seed)
    v = _rand((d,), seed + 1, special=True)
    tbl = _rand(js.table_shape, seed + 2)
    cuts = [0, 137, js.c_pad + 501, d - 3, d]
    jt, tt = jnp.asarray(tbl), torch.from_numpy(tbl)
    for a, b in zip(cuts[:-1], cuts[1:]):
        jt = jsk.sketch_segment_accum(js, jt, jnp.asarray(v[a:b]), a,
                                      interpret=True)
        tt = tsk.sketch_segment_accum(ts, tt, torch.from_numpy(v[a:b]), a)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    # the pure-XLA fold agrees too, and the stream equals tbl + the sketch
    # of the whole vector under ==
    want = jsk.sketch_segment_accum(js, jnp.asarray(tbl), jnp.asarray(v[137:]),
                                    137)
    got = tsk.sketch_segment_accum(ts, torch.from_numpy(tbl),
                                   torch.from_numpy(v[137:]), 137)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("d,c,r,seed", ACC_GEOMS)
def test_segments_accum_bit_equal_to_jax_interpret(d, c, r, seed):
    """One launch for a group of adjacent segments (with a zero-size one),
    from a random table."""
    js, ts = _pair(d, c, r, seed)
    v = _rand((d,), seed + 3)
    tbl = _rand(js.table_shape, seed + 4)
    bounds = [137, 400, 400, js.c_pad + 50, min(d, 2 * js.c_pad + 9)]
    segs = [v[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    want = jsk.sketch_segments_accum(js, jnp.asarray(tbl),
                                     [jnp.asarray(x) for x in segs], 137,
                                     interpret=True)
    got = tsk.sketch_segments_accum(ts, torch.from_numpy(tbl),
                                    [torch.from_numpy(x) for x in segs], 137)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # and it equals the per-segment fold under ==
    fold = torch.from_numpy(tbl)
    for a, x in zip(bounds[:-1], segs):
        fold = tsk.sketch_segment_accum(ts, fold, torch.from_numpy(x), a)
    np.testing.assert_array_equal(got.numpy(), fold.numpy())


@pytest.mark.parametrize("d,c,r,seed", ACC_GEOMS)
def test_chunks_accum_bit_equal_to_jax_interpret(d, c, r, seed):
    js, ts = _pair(d, c, r, seed)
    v3 = np.array(jsk._chunks3(js, jnp.asarray(_rand((d,), seed + 5))))
    tbl = _rand(js.table_shape, seed + 6, special=True)
    want = jsk.sketch_chunks_accum(js, jnp.asarray(tbl), jnp.asarray(v3),
                                   interpret=True)
    got = tsk.sketch_chunks_accum(ts, torch.from_numpy(tbl),
                                  torch.from_numpy(v3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the running fold from a zero table is the zero-table accumulate
    zero = torch.zeros(ts.table_shape)
    _bits_equal(tsk.sketch_chunks_accum(ts, zero, torch.from_numpy(v3)),
                tsk.sketch_chunks(ts, torch.from_numpy(v3)))


def test_coalesce_budget_matches_jax():
    for d, c, r in ((6_568_640, 500_000, 5), (31_640, 2048, 3),
                    (124_000_000, 500_000, 5), (1000, 5000, 3)):
        js, ts = _pair(d, c, r, 0)
        assert tsk.coalesce_vmem_budget(ts) == jsk.coalesce_vmem_budget(js)


# ---- the leaf layout and the coalescing plan ------------------------------

def _jax_params(channels):
    tree = jax.eval_shape(JResNet9(channels=channels).init,
                          jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return tree["params"]


@pytest.mark.parametrize("width", ["tiny", "full"])
def test_leaf_segments_and_plan_equal_jax(width):
    channels = TINY if width == "tiny" else (
        ("prep", 64), ("layer1", 128), ("layer2", 256), ("layer3", 512))
    jsegs = jflat.leaf_segments(_jax_params(channels))
    tsegs = tflat.leaf_segments(tflat.ParamLayout(ResNet9(channels=channels)))
    assert tsegs == jsegs
    d = tsegs[-1].offset + tsegs[-1].size
    c = 2048 if width == "tiny" else 500_000
    r = 3 if width == "tiny" else 5
    js, ts = _pair(d, c, r, 0)
    jplan = jflat.coalesce_segments(jsegs, jsk.coalesce_vmem_budget(js),
                                    chunk_elems=js.c_pad)
    tplan = tflat.coalesce_segments(tsegs, tsk.coalesce_vmem_budget(ts),
                                    chunk_elems=ts.c_pad)
    assert tplan == jplan
    if width == "full":
        # the headline round: 5 groups, so 6 running-accumulate launches a
        # round with weight decay
        assert d == 6_568_640
        names = [[s.path.split("/")[0] + ("/" + s.path.split("/")[1]
                                          if s.path.startswith("res") else "")
                  for s in tsegs[g.start:g.stop]] for g in tplan]
        assert names == [["layer1", "layer2"], ["layer3"],
                         ["linear", "prep", "res1/res1", "res1/res2"],
                         ["res3/res1"], ["res3/res2"]]


def _segs(mod, sizes):
    out, off = [], 0
    for i, n in enumerate(sizes):
        out.append(mod.LeafSegment(path=f"leaf{i}", offset=off, size=n))
        off += n
    return tuple(out)


CE = 512
PLAN_CASES = [
    # an oversized leaf alone, zero-size leaves riding neighbours
    ((0, 100, 0, 10 * CE + 37, 30, 0, 700, 4000, 0), 4 * CE * 4),
    # budget below every adjacency: the degenerate plan warns once
    ((600, 600, 600, 2 * CE + 1), CE * 4),
    ((CE + 1, 3 * CE, 5 * CE), CE * 4),
    # one group over the whole layout, and a single leaf (silent)
    ((137, 1, CE, 3 * CE + 11, 40), 64 * CE * 4),
    ((20 * CE,), CE * 4),
    ((), CE * 4),
]


@pytest.mark.parametrize("sizes,budget", PLAN_CASES)
def test_synthetic_plans_and_warnings_equal_jax(sizes, budget):
    plans, warned = [], []
    for mod in (jflat, tflat):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            plans.append(mod.coalesce_segments(_segs(mod, sizes), budget,
                                               chunk_elems=CE))
        warned.append([str(w.message) for w in rec
                       if issubclass(w.category, RuntimeWarning)])
    assert plans[1] == plans[0]
    assert warned[1] == warned[0]
    assert len(warned[1]) <= 1


# ---- the fused epilogue ----------------------------------------------------

EPI_CASES = [(31_640, 2048, 3, 0, 500), (5000, 300, 5, 7, 64),
             (9001, 700, 4, 2, 9001)]


def _estimates(js, seed):
    """Estimate chunks with NaN, +-inf and ties at the k-th magnitude."""
    est = np.array(jsk.estimates_chunks(
        js, jnp.asarray(_rand(js.table_shape, seed))))
    f = est.reshape(-1)
    f[5], f[6], f[7] = np.nan, np.inf, -np.inf
    f[20:60] = 1.25
    f[60:70] = -1.25
    return np.array(js.chunk_layout.mask_tail(jnp.asarray(est)))


@pytest.mark.parametrize("fused_descent", [False, True],
                         ids=["per-pass", "one-launch"])
@pytest.mark.parametrize("d,c,r,seed,k", EPI_CASES)
def test_fused_epilogue_equals_jax_and_composed(d, c, r, seed, k,
                                                fused_descent, monkeypatch):
    if fused_descent:
        monkeypatch.setenv(ttk.FUSED_DESCENT_ENV, "1")
    js, ts = _pair(d, c, r, seed)
    est = _estimates(js, seed)
    ju, jt = jsk.fused_epilogue_chunks(js, jnp.asarray(est), k,
                                       interpret=True)
    tu, tt = tsk.fused_epilogue_chunks(ts, torch.from_numpy(est), k)
    assert tu.shape == (ts.T, ts.sublanes, 128) and tt.shape == ts.table_shape
    _bits_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert np.isnan(tu.numpy()).sum() == 1
    # the port's composed pair, bit for bit, zero signs included
    cu = ttk.topk_dense_nd(torch.from_numpy(est), k)
    _bits_equal(tu.numpy(), cu.numpy())
    _bits_equal(tt.numpy(), tsk.sketch_chunks(ts, cu).numpy())


def test_fused_epilogue_with_chunk_offset():
    """t0 != 0 with pre-sliced shift columns: the plain epilogue equals the
    composed pair on the same chunk range."""
    js, ts = _pair(5000, 300, 5, 7)
    est = torch.from_numpy(_estimates(js, 3))
    t0, Tn = 2, ts.T - 2
    sl = est[t0:].contiguous()
    q, w = tsk._shift_cols(ts.shift_q, ts.shift_w, t0, Tn)
    p = ttk.resolve_threshold(sl, 40)
    upd, tbl = tsk.fused_epilogue(sl, p, q, w, ts.sign_keys, t0)
    cu = ttk.topk_dense_nd(sl, 40)
    _bits_equal(upd.numpy(), cu.numpy())
    _bits_equal(tbl.reshape(ts.table_shape).numpy(),
                tsk.sketch_chunks(ts, cu, t0=t0).numpy())


# ---- the one-launch descent -----------------------------------------------

def _edge(n, kind):
    v = np.random.RandomState(n).randn(n).astype(np.float32)
    if kind == "special":
        v[:10] = 3.0
        v[10:20] = -3.0
        v[20], v[21], v[22], v[23] = np.inf, -np.inf, np.nan, -np.nan
    elif kind == "ties":
        v[:] = 0.0
        v[:30] = 2.5
        v[30:60] = -2.5
        v[60:100] = 1.0
    elif kind == "zeros":
        v[:] = 0.0
    return v


DESCENT_CASES = [(70_001, "random", 1000), (66_000, "special", 15),
                 (66_000, "special", 1), (66_000, "special", 21),
                 (5000, "ties", 45), (5000, "ties", 30), (5000, "zeros", 10),
                 (300, "random", 300), (300, "random", 500)]


@pytest.mark.parametrize("n,kind,k", DESCENT_CASES)
def test_descent_equals_jax_fused_and_per_pass(n, kind, k, monkeypatch):
    v = _edge(n, kind)
    want = int(jtk._threshold_descent_fused(jnp.asarray(v).view(jnp.int32),
                                            k, interpret=True))
    bits = torch.from_numpy(v).view(torch.int32)
    assert int(ttk._descent_plain(bits, k)) == want
    assert int(ttk.topk_descent(bits, k)) == want
    assert int(ttk._descent(bits, k, ttk.topk_count_ge)) == want
    assert int(ttk.resolve_threshold(torch.from_numpy(v), k)) == want
    monkeypatch.setenv(ttk.FUSED_DESCENT_ENV, "1")
    assert ttk.fused_descent_enabled()
    assert int(ttk.resolve_threshold(torch.from_numpy(v), k)) == want
    p = ttk.topk_descent(bits, k)
    assert p.shape == () and p.dtype == torch.int32


def test_fused_descent_switch_default_off(monkeypatch):
    monkeypatch.delenv(ttk.FUSED_DESCENT_ENV, raising=False)
    assert not ttk.fused_descent_enabled()
    for val in ("0", "", "true"):
        monkeypatch.setenv(ttk.FUSED_DESCENT_ENV, val)
        assert not ttk.fused_descent_enabled()
    monkeypatch.setenv(ttk.FUSED_DESCENT_ENV, "1")
    assert ttk.fused_descent_enabled()


# ---- the streaming client phase --------------------------------------------

def _steps(stream, coalesce, wd, microbatch, k=500):
    model = ResNet9(channels=TINY)
    params = tflat.ParamLayout(model)
    train, val = t_losses(model)
    wcfg = WorkerConfig(mode="sketch", error_type="virtual", k=k,
                        num_workers=W, weight_decay=wd,
                        microbatch_size=microbatch)
    scfg = ServerConfig(mode="sketch", error_type="virtual", k=k,
                        grad_size=params.d, virtual_momentum=0.9)
    cs = tsk.make_sketch(params.d, 2048, 3, seed=0, device="cpu")
    cfg = RoundConfig(worker=wcfg, server=scfg, grad_size=params.d,
                      stream_sketch=stream, sketch_coalesce=coalesce)
    steps = build_round_step(train, val, params, cfg, cs)
    gen = torch.Generator().manual_seed(1)
    w = torch.empty(params.d).uniform_(-0.1, 0.1, generator=gen)
    return steps, cs.chunk_layout.chunk(w)


def _client_table(steps, ps3, rnd=0):
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in _batch(rnd).items()}
    b["targets"] = b["targets"].to(torch.int64)
    ctx, _, metrics = steps.client_step(ps3, ClientStates(None, None, None),
                                        {}, b, LR, None)
    table = ctx.gradient
    return table, metrics


@pytest.mark.parametrize("coalesce", [False, True],
                         ids=["per-leaf", "coalesced"])
def test_stream_table_equals_composed_one_microbatch_no_wd(coalesce):
    """One microbatch, no weight decay: the per-cell adds are the composed
    fold's, so the tables are equal under == (the sign of an all-zero cell
    may differ)."""
    composed, ps3 = _steps(False, False, 0.0, -1)
    stream, _ = _steps(True, coalesce, 0.0, -1)
    tc, mc = _client_table(composed, ps3, 1)
    ts_, ms = _client_table(stream, ps3, 1)
    np.testing.assert_array_equal(ts_.numpy(), tc.numpy())
    for a, b in zip(ms, mc):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("wd,microbatch", [(5e-4, -1), (0.0, 2),
                                           (5e-4, 3)])
def test_stream_table_close_to_composed(wd, microbatch):
    """Weight decay (sketched apart from the gradient) and several
    microbatches (each sketched apart) reorder float32 sums: the tables
    agree to a few float32 roundings of the cells' magnitude."""
    composed, ps3 = _steps(False, False, wd, microbatch)
    stream, _ = _steps(True, True, wd, microbatch)
    tc, _ = _client_table(composed, ps3)
    ts_, _ = _client_table(stream, ps3)
    scale = float(tc.abs().max())
    np.testing.assert_allclose(ts_.numpy(), tc.numpy(), rtol=1e-5,
                               atol=1e-6 * scale)
    assert not np.array_equal(ts_.numpy(), np.zeros_like(ts_.numpy()))


def test_stream_launches_follow_the_plan(monkeypatch):
    """One running accumulate per group and microbatch (its segment form),
    plus one for weight decay, and none of the zero-table accumulate."""
    calls = {"into": 0, "zero": 0}
    seg, into, zero = (tsk.sketch_segment_into, tsk.sketch_accumulate_into,
                       tsk.sketch_accumulate)

    def count_seg(*a, **kw):
        calls["into"] += 1
        return seg(*a, **kw)

    def count_into(*a, **kw):
        calls["into"] += 1
        return into(*a, **kw)

    def count_zero(*a, **kw):
        calls["zero"] += 1
        return zero(*a, **kw)

    monkeypatch.setattr(tsk, "sketch_segment_into", count_seg)
    monkeypatch.setattr(tsk, "sketch_accumulate_into", count_into)
    monkeypatch.setattr(tsk, "sketch_accumulate", count_zero)
    for coalesce, microbatch in ((True, -1), (True, 2), (False, -1)):
        steps, ps3 = _steps(True, coalesce, 5e-4, microbatch)
        calls.update(into=0, zero=0)
        _client_table(steps, ps3)
        n_iters = 1 if microbatch < 0 else -(-B // microbatch)
        per_iter = (len(steps.stream_groups) if coalesce
                    else sum(1 for s in steps.stream_segments if s.size))
        assert steps.stream_segments is not None
        assert calls == {"into": per_iter * n_iters + 1, "zero": 0}
    assert kernels.launch_counts()["sketch_accumulate_into"] == 0


def test_stream_leaves_are_views_of_the_plane():
    model = ResNet9(channels=TINY)
    params = tflat.ParamLayout(model)
    layout = tsk.make_sketch(params.d, 2048, 3, device="cpu").chunk_layout
    w = torch.arange(params.d, dtype=torch.float32)
    ps3 = layout.chunk(w)
    leaves = params.leaves(layout.unchunk(ps3))
    flat = params.params(w)
    for e, leaf in zip(params.entries, leaves):
        assert leaf.requires_grad and leaf.is_leaf
        assert tuple(leaf.shape) == e.jax_shape
        assert leaf.data_ptr() == ps3.data_ptr() + 4 * e.offset
        np.testing.assert_array_equal(
            tflat.jax_to_torch_layout(leaf, e.kind).detach().numpy(),
            flat[e.torch_name].numpy())


def test_sketch_coalesce_without_stream_notes_and_composes(capsys):
    args = t_parse(argv=ARGV + ["--device", "cpu", "--sketch_coalesce"])
    assert "NOTE: --sketch_coalesce" in capsys.readouterr().out
    tm = ResNet9(channels=TINY)
    ttrain, _ = t_losses(tm)
    fm = FedModel(tm, ttrain, args, num_clients=NCLIENTS, device="cpu")
    assert fm.steps.stream_segments is None
    assert fm.steps.stream_groups is None
    args = t_parse(argv=ARGV + ["--device", "cpu"] + OPT_IN)
    assert args.stream_sketch and args.sketch_coalesce and args.fused_epilogue
    assert "NOTE" not in capsys.readouterr().out


# ---- three rounds against the JAX package -----------------------------------

@pytest.fixture(scope="module")
def opt_in_trajectories():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COMMEFFICIENT_FUSED_EPILOGUE", "interpret")
        mp.setenv("COMMEFFICIENT_PALLAS_SKETCH", "interpret")
        mp.setenv(ttk.FUSED_DESCENT_ENV, "1")
        jargs = j_parse(argv=ARGV + OPT_IN)
        jm = JResNet9(channels=TINY)
        jtrain, jval = j_losses(jm)
        jfm = JFedModel(jm, jtrain, jargs, jval, input_shape=(32, 32, 3),
                        num_clients=NCLIENTS)
        assert jfm.mesh is None or jfm.mesh.devices.size == 1
        jopt = JFedOptimizer(jfm, jargs)
        jopt.set_lr_factor(LR)
        flat0 = np.asarray(ravel_pytree(jfm.params)[0])

        targs = t_parse(argv=ARGV + ["--device", "cpu"] + OPT_IN)
        tm = ResNet9(channels=TINY)
        layout = tflat.ParamLayout(tm)
        ttrain, tval = t_losses(tm)
        tfm = FedModel(tm, ttrain, targs, tval, num_clients=NCLIENTS,
                       init_params=flat_from_jax(flat0, layout),
                       device="cpu")
        assert tfm.server_config.fused_epilogue
        assert tfm.steps.stream_groups is not None
        topt = FedOptimizer(tfm, targs)
        topt.set_lr_factor(LR)
        out = []
        for rnd in range(3):
            b = _batch(rnd)
            jres = jfm(b)
            jopt.step()
            tres = tfm(b)
            topt.step()
            jw = np.asarray(ravel_pytree(jfm.params)[0])
            tw = tfm.layout.unchunk(tfm.ps_weights).numpy().copy()
            out.append((jres, tres, jw, tw))
    return flat0, out


def test_opt_in_rounds_track_jax(opt_in_trajectories):
    flat0, out = opt_in_trajectories
    jprev = tprev = flat0
    for rnd, (jres, tres, jw, tw) in enumerate(out):
        (jl, ja, _, ju), (tl, ta, _, tu) = jres, tres
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-6)
        jsel = set(np.flatnonzero(jw != jprev))
        tsel = set(np.flatnonzero(tw != tprev))
        assert len(jsel) >= 500 and len(tsel) >= 500
        overlap = len(jsel & tsel) / max(len(jsel), len(tsel))
        assert overlap >= 0.99, (rnd, overlap)
        jprev, tprev = jw, tw


# ---- the histogram radix select of the one-launch descent -----------------

RADIX_DIGITS = ((20, 11), (10, 10), (0, 10))  # (shift, bits), from the top


def _radix_select_np(bits, k):
    """numpy transcription of ``csrc/topk_descent.cu``: 3 passes over the
    31 magnitude bits; each histograms one digit over the patterns whose
    higher digits equal the prefix so far, walks the bins from the top
    until the running count reaches the remaining rank, keeps that digit
    and takes the count of the bins above it off the rank. Fewer than k
    patterns give 0."""
    m = np.asarray(bits, np.int32) & 0x7FFFFFFF
    m = np.where(m > 0x7F800000, 0, m).astype(np.int64)
    prefix, rank = 0, int(k)
    for shift, nbits in RADIX_DIGITS:
        top = shift + nbits
        live = m[(m >> top) == (prefix >> top)]
        hist = np.bincount((live >> shift) & ((1 << nbits) - 1),
                           minlength=1 << nbits)
        above = np.concatenate([[0], np.cumsum(hist[::-1])[:-1]])[::-1]
        hit = np.flatnonzero((above < rank) & (above + hist >= rank))
        if hit.size == 0:
            return 0
        digit = int(hit[0])
        prefix |= digit << shift
        rank -= int(above[digit])
    return prefix


def _radix_edge(n, kind):
    v = np.random.RandomState(n + 11).randn(n).astype(np.float32)
    if kind == "straddle":
        # tie runs on both sides of a digit-1 boundary (0x3F8003FF and
        # 0x3F800400) and of a digit-0 boundary (1.0 = 0x3F800000 and the
        # patterns just below it), above small random values
        one = 0x3F800000
        runs = [(0x3F800400, 10), (0x3F8003FF, 10), (one + 1, 10),
                (one, 40), (one - 10, 10)]
        v = (v * np.float32(1e-3)).astype(np.float32)
        at = 0
        for i, (pat, count) in enumerate(runs):
            pats = np.full(count, pat, np.int32)
            if i in (2, 4):  # distinct patterns, not a tie run
                pats += np.arange(count, dtype=np.int32)
            v[at:at + count] = pats.view(np.float32) * (-1) ** i
            at += count
    elif kind == "equal":
        v[:] = np.float32(-0.375)
    elif kind == "subnormal":
        v = (v * np.float32(1e-40)).astype(np.float32)
    return v


RADIX_CASES = DESCENT_CASES + [
    (5000, "straddle", 10), (5000, "straddle", 11), (5000, "straddle", 20),
    (5000, "straddle", 45), (5000, "straddle", 70), (5000, "straddle", 71),
    (5000, "straddle", 75), (4097, "random", 4097), (1, "random", 1),
    (1, "random", 2), (3000, "equal", 1), (3000, "equal", 3000),
    (3000, "equal", 3001)]


def _radix_input(n, kind):
    return _edge(n, kind) if kind in ("random", "special", "ties",
                                      "zeros") else _radix_edge(n, kind)


@pytest.mark.parametrize("n,kind,k", RADIX_CASES)
def test_radix_select_equals_descent_and_jax(n, kind, k):
    """The new descent's algorithm against the port's 8-pass plain descent
    and the JAX package's one-launch Pallas descent (interpret mode)."""
    v = _radix_input(n, kind)
    bits = v.view(np.int32)
    got = _radix_select_np(bits, k)
    assert got == int(ttk._descent_plain(torch.from_numpy(bits), k))
    want = int(jtk._threshold_descent_fused(jnp.asarray(bits), k,
                                            interpret=True))
    assert got == want
    if k > n:
        assert got == 0


@pytest.mark.parametrize("k", [1, 64, 4999, 5000])
def test_radix_select_keeps_subnormals(k):
    """Subnormal magnitudes sit in digit-0 bins 0-7; against the port's
    plain descent only (XLA on the CPU flushes them)."""
    bits = _radix_edge(5000, "subnormal").view(np.int32)
    got = _radix_select_np(bits, k)
    assert got == int(ttk._descent_plain(torch.from_numpy(bits), k))
    assert 0 < got < 0x00800000


# ---- the segment form of the running accumulate ----------------------------

SEG_CASES = {"mid-chunk": (2048 + 300, 900), "one-element": (4096 + 5, 1),
             "straddling": (137, 2048 + 500),
             "ends-at-d-in-tail": (31_640 - 2048 - 100, 2048 + 100)}


def _padded_fold_np(js, tbl, seg, e0):
    """numpy transcription of the segment form's plain version: the segment
    zero-padded to the chunks ``[t_a, t_b)`` it touches, then per row and
    cell ``acc += sign * x[(c - m) mod c_pad]`` in float32, chunk by chunk,
    onto the incoming table. The geometry (shifts, keys) is the JAX
    package's. Returns ``(table, t_b)``."""
    c_pad, r = js.c_pad, js.r
    t_a, lpad = divmod(e0, c_pad)
    t_b = t_a + -(-(lpad + seg.size) // c_pad)
    x = np.zeros((t_b - t_a) * c_pad, np.float32)
    x[lpad:lpad + seg.size] = seg
    q, w = np.asarray(js.shift_q), np.asarray(js.shift_w)
    keys = np.asarray(js.sign_keys).astype(np.uint32)
    pos = np.arange(c_pad, dtype=np.int64)
    acc = np.array(tbl, np.float32).reshape(r, c_pad)
    for t in range(t_a, t_b):
        xt = x[(t - t_a) * c_pad:(t - t_a + 1) * c_pad]
        idx = (t * c_pad + pos).astype(np.uint32)
        for j in range(r):
            h = idx ^ keys[j]
            h ^= h >> np.uint32(16)
            h *= np.uint32(0x85EBCA6B)
            h ^= h >> np.uint32(13)
            h *= np.uint32(0xC2B2AE35)
            h ^= h >> np.uint32(16)
            sign = np.where(h & np.uint32(1), np.float32(1), np.float32(-1))
            sv = (sign * xt).astype(np.float32)
            m = int(q[j, t]) * 128 + int(w[j, t])
            acc[j] = acc[j] + sv[(pos - m) % c_pad]
    return acc, t_b


def _zero_cells(tbl):
    """Zero incoming cells, a third -0.0 and a third +0.0, spread over the
    table so that some of them receive only the padding's ``sign * 0``
    adds: -0.0 keeps the sign of those adds visible (+0.0 + -0.0 is +0.0
    whatever the adds' signs)."""
    flat = tbl.reshape(-1)
    flat[0::3] = -0.0
    flat[1::3] = 0.0
    return tbl


def _neg_zeros(x):
    x = np.asarray(x)
    return int(((x == 0) & np.signbit(x)).sum())


@pytest.mark.parametrize("kind", list(SEG_CASES))
def test_segment_form_plain_equals_padded_chunks(kind):
    """The segment form's plain version against a numpy transcription of
    the padded fold (``_segment_chunks`` then the running accumulate of the
    covering chunks), bit for bit with zero signs included, and against the
    JAX package's segment fold in interpret mode."""
    js, ts = _pair(31_640, 2048, 3, 0)
    e0, n = SEG_CASES[kind]
    seg = _rand((n,), n + 1)
    tbl = _zero_cells(_rand(ts.table_shape, n + 2))
    got = tsk.sketch_segment_into(ts, torch.from_numpy(tbl),
                                  torch.from_numpy(seg), e0)
    want, t_b = _padded_fold_np(js, tbl, seg, e0)
    _bits_equal(got.numpy(), want)
    assert _neg_zeros(got.numpy()) > 0   # zero signs were compared
    if kind == "ends-at-d-in-tail":
        assert t_b == ts.T and e0 + n == ts.d
    jt = jsk.sketch_segment_accum(js, jnp.asarray(tbl), jnp.asarray(seg), e0,
                                  interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jt))


def test_segments_form_with_zero_size_segment_equals_padded():
    """A group holding a zero-size segment: one segment-form accumulate of
    the concatenation, against the JAX package's group accumulate in
    interpret mode and the numpy padded fold's bits."""
    js, ts = _pair(31_640, 2048, 3, 0)
    bounds = [2048 + 300, 2048 + 300, 2048 + 700, 2 * 2048 + 100]
    v = _rand((31_640,), 9)
    tbl = _zero_cells(_rand(ts.table_shape, 10))
    segs = [v[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    assert segs[0].size == 0
    got = tsk.sketch_segments_accum(ts, torch.from_numpy(tbl),
                                    [torch.from_numpy(x) for x in segs],
                                    bounds[0])
    want = jsk.sketch_segments_accum(js, jnp.asarray(tbl),
                                     [jnp.asarray(x) for x in segs],
                                     bounds[0], interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fold, _ = _padded_fold_np(js, tbl, v[bounds[0]:bounds[-1]], bounds[0])
    _bits_equal(got.numpy(), fold)
    assert _neg_zeros(got.numpy()) > 0   # zero signs were compared
