"""The port's CUDA kernels (commefficient_torch/csrc/*.cu) against their
plain PyTorch versions.

Tests marked ``gpu`` need an NVIDIA card and skip without one; whether a
card is present is decided inside the ``cuda`` fixture, never at import.
On the card: ``python -m pytest tests/test_torch_kernels.py -m gpu``.
Every comparison is exact (``torch.equal``, NaN-aware): the accumulate
keeps the plain version's per-cell add order, the query the median's
values (the sign of a zero median is free) and writes its masked tail as
+0.0 bit for bit, the fused epilogue the composed mask and accumulate,
and the counts and the descent are integers. All six kernels also run at
the FEMNIST ResNet101-LN geometry (Tn = 86 chunks of 500,096).

Also on the card, at a tiny width with cuDNN pinned deterministic: the
round engine's non-drain submits under
``torch.cuda.set_sync_debug_mode("error")`` with results equal to the
synchronous loop, and a resume through ``save_round_state`` /
``load_run_state`` bit-equal to the continuous run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_torch import kernels  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402
from commefficient_torch.ops import topk as ttk  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run on the chip with "
                    "`python -m pytest tests/test_torch_kernels.py -m gpu`")
    return torch.device("cuda")


def _nan_equal(a, b):
    a, b = a.cpu(), b.cpu()
    return bool(torch.equal(torch.isnan(a), torch.isnan(b))
                and torch.equal(torch.nan_to_num(a, nan=0.0),
                                torch.nan_to_num(b, nan=0.0)))


def _bit_equal(a, b):
    """Equal NaN positions, and equal bit patterns (zero signs included)
    everywhere else."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(torch.int32)[~nan],
                                b.view(torch.int32)[~nan]))


def _special(x):
    flat = x.view(-1)
    flat[3] = float("nan")
    flat[5] = float("inf")
    flat[8] = float("-inf")
    flat[11:40] = 1e-40
    flat[41] = -0.0
    return x


# (d, c, r, seed, t0): ragged c, partial last chunk, even r, t0 != 0
GEOMS = [(31_640, 2048, 3, 0, 0), (50_000, 3000, 4, 1, 0),
         (50_000, 3000, 4, 1, 2), (9_001, 700, 5, 2, 3),
         (4_000, 500, 8, 3, 0), (1_000, 1_000, 1, 4, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("d,c,r,seed,t0", GEOMS)
def test_accumulate_kernel_equals_plain(cuda, d, c, r, seed, t0):
    cs = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    Tn = cs.T - t0
    gen = torch.Generator().manual_seed(seed)
    v3 = _special(torch.randn((Tn, cs.sublanes, 128), generator=gen))
    q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
    before = kernels.SKETCH_ACCUMULATE.launches
    got = kernels.sketch_accumulate(v3.to(cuda), q, w, cs.sign_keys, t0)
    torch.cuda.synchronize()
    assert kernels.SKETCH_ACCUMULATE.launches == before + 1
    want = tsk._sketch_accumulate_plain(v3.to(cuda), q, w, cs.sign_keys, t0)
    assert _nan_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,c,r,seed,t0", GEOMS)
def test_estimates_kernel_equals_plain(cuda, d, c, r, seed, t0):
    cs = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    Tn = cs.T - t0
    gen = torch.Generator().manual_seed(seed + 10)
    t3 = _special(torch.randn((r, cs.sublanes, 128), generator=gen)).to(cuda)
    got = tsk.sketch_estimates(t3, cs, t0=t0, Tn=Tn)
    iq, iw = tsk._shift_cols(cs.inv_q, cs.inv_w, t0, Tn)
    want = tsk._sketch_estimates_plain(t3, iq, iw, cs.sign_keys, t0)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (Tn, cs.sublanes, 128)
    assert _nan_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("r", range(1, 9))
@pytest.mark.parametrize("d,c,seed,t0", [g[:2] + g[3:] for g in GEOMS])
def test_estimates_kernel_masked_equals_plain(cuda, d, c, seed, t0, r):
    """The query at every row count the kernel takes, with ``n_valid`` at
    d and at the chunk range's end, on ``_special`` tables and on tables
    half of whose cells are zero (both signs): one launch each, every
    coordinate >= n_valid +0.0 bit for bit, every other cell the plain
    version's (the sign of a zero median is free, see
    ``csrc/sketch_kernels.cu``)."""
    cs = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    Tn = cs.T - t0
    q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
    iq, iw = tsk._shift_cols(cs.inv_q, cs.inv_w, t0, Tn)
    gen = torch.Generator().manual_seed(seed + 50 + r)
    shape = (r, cs.sublanes, 128)
    half_zero = torch.randn(shape, generator=gen)
    zero = torch.rand(shape, generator=gen)
    half_zero[zero < 0.25] = 0.0
    half_zero[(zero >= 0.25) & (zero < 0.5)] = -0.0
    coord = (t0 * cs.c_pad + torch.arange(Tn * cs.c_pad, device=cuda)
             ).view(Tn, cs.sublanes, 128)
    for tbl in (_special(torch.randn(shape, generator=gen)), half_zero):
        tbl = tbl.to(cuda)
        plain = tsk._sketch_estimates_plain(tbl, iq, iw, cs.sign_keys, t0)
        for n_valid in (d, (t0 + Tn) * cs.c_pad):
            before = kernels.SKETCH_ESTIMATES.launches
            got = kernels.sketch_estimates(tbl, q, w, cs.sign_keys, t0,
                                           n_valid)
            torch.cuda.synchronize()
            assert kernels.SKETCH_ESTIMATES.launches == before + 1
            tail = coord >= n_valid
            assert int(tail.sum()) == max(0, (t0 + Tn) * cs.c_pad - n_valid)
            assert not got[tail].view(torch.int32).any()
            assert _nan_equal(got[~tail], plain[~tail])


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(7_001_344, 50_000), (70_001, 1000),
                                 (1, 1), (129, 500)])
def test_count_kernel_and_descent_equal_plain(cuda, n, k):
    gen = torch.Generator().manual_seed(n)
    v = _special(torch.randn(n + 64, generator=gen))[-n:].contiguous()
    bits = v.view(torch.int32).to(cuda)
    p = torch.zeros((), dtype=torch.int32, device=cuda)
    for shift in range(28, -1, -4):
        ts = ttk._pass_thresholds(p, shift)
        got = kernels.topk_count_ge(bits, ts)
        want = ttk._count_ge_plain(bits, ts)
        assert torch.equal(got, want)
        p = p + ((want >= k).sum().to(torch.int32) << shift)
    assert int(ttk.resolve_threshold(v.to(cuda), k)) == int(
        ttk.resolve_threshold(v, k))


# Thresholds beyond the descent's sorted p + (j << shift): unsorted, with
# repeats, 0, negative ones and 0x7FFFFFFF
MIXED_THRESHOLDS = [0x3F400000, 0, 0x7F800000, 0x3F400000, 1, 0x7FFFFFFF,
                    -5, 0x3E800000, 0x00800000, 0x3F400000, 0x7F7FFFFF,
                    0x100, 0x3F000000, -2**31, 0x40400000, 0x3F400001]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mixed", "all-max", "own", "offset-1",
                                  "n=1", "n=3", "n=129", "headline",
                                  "back-to-back"])
def test_count_kernel_contract_cases(cuda, kind):
    """The count pass for any 16 thresholds (unsorted, repeated, 0,
    negative, all 0x7FFFFFFF), on views at a 4-byte offset, on 1, 3, 129
    and 7,001,344 NaN, inf and subnormal patterns, and twice back to back
    (the kernel's scratch totals and ticket come back to zero)."""
    n = 7_001_344 if kind == "headline" else 70_001
    gen = torch.Generator().manual_seed(11)
    bits = _special(torch.randn(n + 8, generator=gen)).view(torch.int32)
    bits = bits.to(cuda)[:n]
    ts = torch.tensor(MIXED_THRESHOLDS, dtype=torch.int32, device=cuda)
    if kind == "all-max":
        ts = torch.full((16,), 0x7FFFFFFF, dtype=torch.int32, device=cuda)
    elif kind == "own":
        ts = ttk._mag(bits)[torch.randint(0, n, (16,), generator=gen)
                            .to(cuda)]
    elif kind == "offset-1":
        bits = bits[1:]
    elif kind in ("n=1", "n=3", "n=129"):
        bits = bits[1:1 + int(kind[2:])]
    before = kernels.TOPK_COUNT_GE.launches
    got = kernels.topk_count_ge(bits, ts)
    if kind == "back-to-back":
        other = bits[3:].flip(0).contiguous()
        ts2 = ttk._pass_thresholds(torch.tensor(0x3F000000, dtype=torch.int32,
                                                device=cuda), 20)
        got2 = kernels.topk_count_ge(other, ts2)
        assert torch.equal(got2, ttk._count_ge_plain(other, ts2))
    assert torch.equal(got, ttk._count_ge_plain(bits, ts))
    assert torch.equal(got.cpu(), ttk._count_ge_plain(bits.cpu(), ts.cpu()))
    assert kernels.TOPK_COUNT_GE.launches == before + (
        2 if kind == "back-to-back" else 1)


@pytest.mark.gpu
@pytest.mark.parametrize("d,c,r,seed,t0", GEOMS)
def test_accumulate_into_kernel_equals_plain(cuda, d, c, r, seed, t0):
    cs = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    Tn = cs.T - t0
    gen = torch.Generator().manual_seed(seed + 20)
    tbl = _special(torch.randn((r, cs.sublanes, 128), generator=gen))
    v3 = _special(torch.randn((Tn, cs.sublanes, 128), generator=gen))
    tbl, v3 = tbl.to(cuda), v3.to(cuda)
    q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
    before = kernels.SKETCH_ACCUMULATE_INTO.launches
    got = kernels.sketch_accumulate_into(tbl, v3, q, w, cs.sign_keys, t0)
    torch.cuda.synchronize()
    assert kernels.SKETCH_ACCUMULATE_INTO.launches == before + 1
    want = tsk._sketch_accumulate_into_plain(tbl, v3, q, w, cs.sign_keys, t0)
    assert _bit_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,c,r,seed,t0", GEOMS[:4])
def test_segment_accum_on_card_equals_cpu(cuda, d, c, r, seed, t0):
    """An unaligned segment straddling a chunk boundary, from a random
    table: the kernel on the card equals the plain version on the CPU."""
    cs_g = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    cs_c = tsk.make_sketch(d, c, r, seed=seed, device="cpu")
    rng = np.random.RandomState(seed)
    tbl = torch.from_numpy(rng.randn(*cs_c.table_shape).astype(np.float32))
    e0 = 137 + t0 * cs_c.c_pad
    n = min(cs_c.c_pad + 50, d - e0)
    seg = _special(torch.from_numpy(rng.randn(n).astype(np.float32)))
    got = tsk.sketch_segment_accum(cs_g, tbl.to(cuda), seg.to(cuda), e0)
    want = tsk.sketch_segment_accum(cs_c, tbl, seg, e0)
    assert _bit_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,c,r,seed,t0", GEOMS)
def test_fused_epilogue_kernel_equals_plain(cuda, d, c, r, seed, t0):
    cs = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    Tn = cs.T - t0
    gen = torch.Generator().manual_seed(seed + 30)
    est = _special(torch.randn((Tn, cs.sublanes, 128), generator=gen))
    flat = est.view(-1)
    flat[50:90] = 0.75        # ties at the threshold
    flat[90:100] = -0.75
    mag = torch.where(torch.isnan(flat), torch.zeros_like(flat), flat.abs())
    k = int((mag > 0.75).sum()) + 20
    est = est.to(cuda)
    p = ttk.resolve_threshold(est, k)
    assert int(p) == int(torch.tensor(0.75).view(torch.int32))
    q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
    before = kernels.FUSED_EPILOGUE.launches
    upd, tbl = kernels.fused_epilogue(est, p, q, w, cs.sign_keys, t0)
    torch.cuda.synchronize()
    assert kernels.FUSED_EPILOGUE.launches == before + 1
    want_u, want_t = tsk._fused_epilogue_plain(est, p, q, w, cs.sign_keys, t0)
    assert _bit_equal(upd, want_u)
    assert _bit_equal(tbl, want_t)
    assert int((upd.abs() == 0.75).sum()) == 50


@pytest.mark.gpu
@pytest.mark.parametrize("p_bits", [0, 0x7F800001])
@pytest.mark.parametrize("d,c,r,seed,t0", [GEOMS[0], GEOMS[3],
                                           (20_000, 1_100, 5, 5, 1)])
def test_fused_epilogue_kernel_at_threshold_extremes(cuda, p_bits, d, c, r,
                                                     seed, t0):
    """p = 0 keeps every estimate, p = 0x7F800001 none but the NaNs; rows
    of 2,048, 768 and 1,152 cells (the last two not a multiple of the
    kernel's 1,024-cell tile). The update is the plain version's bit for
    bit, NaN payloads included."""
    cs = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    Tn = cs.T - t0
    gen = torch.Generator().manual_seed(seed + 40)
    est = _special(torch.randn((Tn, cs.sublanes, 128), generator=gen))
    est.view(-1).view(torch.int32)[7] = 0xFFC00123 - 2**32  # -NaN, payload
    est = est.to(cuda)
    p = torch.tensor(p_bits, dtype=torch.int32, device=cuda)
    q, w = tsk._shift_cols(cs.shift_q, cs.shift_w, t0, Tn)
    upd, tbl = kernels.fused_epilogue(est, p, q, w, cs.sign_keys, t0)
    want_u, want_t = tsk._fused_epilogue_plain(est, p, q, w, cs.sign_keys, t0)
    torch.cuda.synchronize()
    assert torch.equal(upd.view(torch.int32), want_u.view(torch.int32))
    assert _bit_equal(tbl, want_t)
    if p_bits:
        assert int((upd != 0).sum()) == int(torch.isnan(est).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(7_001_344, 50_000), (70_001, 1000),
                                 (1, 1), (129, 500), (5000, 5000),
                                 (66_000, 1)])
def test_descent_kernel_equals_per_pass_and_plain(cuda, n, k):
    gen = torch.Generator().manual_seed(n + 1)
    v = _special(torch.randn(n + 64, generator=gen))[-n:].contiguous()
    v[: n // 3] = v[n // 3: 2 * (n // 3)]  # ties
    bits = v.view(torch.int32).to(cuda)
    before = kernels.TOPK_DESCENT.launches
    got = int(kernels.topk_descent(bits, k))
    assert kernels.TOPK_DESCENT.launches == before + 1
    assert got == int(ttk._descent(bits, k, kernels.topk_count_ge))
    assert got == int(ttk._descent_plain(bits, k))
    assert got == int(ttk._descent_plain(bits.cpu(), k))


def test_new_wrappers_refuse_cpu_tensors():
    """The running accumulate, the fused epilogue and the one-launch
    descent launch on CUDA tensors only, like the other wrappers."""
    cs = tsk.make_sketch(1000, 256, 3, seed=0, device="cpu")
    v3 = torch.zeros((cs.T, cs.sublanes, 128))
    t3 = torch.zeros((3, cs.sublanes, 128))
    p = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sketch_accumulate_into(t3, v3, cs.shift_q, cs.shift_w,
                                       cs.sign_keys)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_epilogue(v3, p, cs.shift_q, cs.shift_w, cs.sign_keys)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.topk_descent(torch.zeros(10, dtype=torch.int32), 3)


def test_wrappers_refuse_cpu_tensors():
    """A wrapper launches on CUDA tensors only (it never computes the plain
    version); on a CPU tensor it raises before touching the library."""
    cs = tsk.make_sketch(1000, 256, 3, seed=0, device="cpu")
    v3 = torch.zeros((cs.T, cs.sublanes, 128))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sketch_accumulate(v3, cs.shift_q, cs.shift_w, cs.sign_keys)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sketch_estimates(torch.zeros((3, cs.sublanes, 128)),
                                 cs.shift_q, cs.shift_w, cs.sign_keys)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.topk_count_ge(torch.zeros(10, dtype=torch.int32),
                              torch.zeros(16, dtype=torch.int32))


def test_build_flags_keep_ieee_denormals():
    """sm_90a target, and never fast-math (it flushes subnormals); every
    kernel's entry point is in one of the sources the build compiles."""
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "ftz=true" not in flags
    srcs = {f"commefficient_torch/csrc/{f.name}": f.read_text()
            for f in kernels.SOURCES}
    for k in kernels.KERNELS:
        assert f"int {k.name}(" in srcs[k.source], k


ALL_ZERO = {"sketch_accumulate": 0, "sketch_accumulate_into": 0,
            "sketch_estimates": 0, "fused_epilogue": 0, "topk_count_ge": 0,
            "topk_descent": 0}


def test_launch_counters_start_and_reset():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == ALL_ZERO
    assert [k.name for k in kernels.KERNELS] == list(kernels.launch_counts())
    assert all(k.replaces.startswith("commefficient_tpu/ops/")
               for k in kernels.KERNELS)


def test_plain_versions_on_cpu_do_not_count(monkeypatch):
    kernels.reset_launch_counts()
    cs = tsk.make_sketch(2000, 256, 3, seed=1, device="cpu")
    v = torch.from_numpy(np.random.RandomState(1).randn(2000)
                         .astype(np.float32))
    table = tsk.sketch_vec(cs, v)
    tsk.unsketch(cs, table, 10)
    tsk.sketch_chunks_accum(cs, table, cs.chunk_layout.chunk(v))
    monkeypatch.setenv(ttk.FUSED_DESCENT_ENV, "1")
    tsk.fused_epilogue_chunks(cs, tsk.estimates_chunks(cs, table), 10)
    assert kernels.launch_counts() == ALL_ZERO


# (e0, n) of a segment, by kind, in a geometry of c_pad = 3072, d = 50_000
def _segment_cases(c_pad, d):
    return {"straddling": (137, c_pad + 500),
            "mid-chunk": (c_pad + 100, 900),
            "one-element": (2 * c_pad + 5, 1),
            "ends-at-d": (d - c_pad - 7, c_pad + 7),
            "whole-range": (0, d)}


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["straddling", "mid-chunk", "one-element",
                                  "ends-at-d", "whole-range"])
def test_segment_form_equals_padded_plain(cuda, kind):
    """The kernel reads the segment in place; the plain version pads it to
    its covering chunks. Equal bits, zero signs included, from a random
    incoming table."""
    cs = tsk.make_sketch(50_000, 3000, 4, seed=1, device=cuda)
    e0, n = _segment_cases(cs.c_pad, cs.d)[kind]
    gen = torch.Generator().manual_seed(n)
    tbl = _special(torch.randn(cs.table_shape, generator=gen)).to(cuda)
    seg = torch.randn(n, generator=gen)
    if n > 50:
        seg = _special(seg)
    seg = seg.to(cuda)
    before = kernels.SKETCH_ACCUMULATE_INTO.launches
    got = tsk.sketch_segment_into(cs, tbl, seg, e0)
    torch.cuda.synchronize()
    assert kernels.SKETCH_ACCUMULATE_INTO.launches == before + 1
    assert _bit_equal(got, tsk._sketch_segment_into_plain(cs, tbl, seg, e0))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["misaligned", "k=n", "k>n", "all-equal",
                                  "all-zero", "offset-2", "offset-3"])
def test_descent_kernel_edge_cases(cuda, kind):
    """Views at every 4-byte offset (a head before the first 16-byte
    boundary), k at and past n, and inputs whose patterns are all one bin."""
    n, k = 70_001, 1000
    gen = torch.Generator().manual_seed(7)
    v = _special(torch.randn(n + 8, generator=gen)).to(cuda)
    bits = v.view(torch.int32)[:n]
    if kind == "misaligned":
        bits = bits[1:]
    elif kind == "offset-2":
        bits = bits[2:]
    elif kind == "offset-3":
        bits = bits[3:]
    elif kind == "k=n":
        k = n
    elif kind == "k>n":
        k = n + 5
    elif kind == "all-equal":
        bits = torch.full((n,), 0x3F400000, dtype=torch.int32, device=cuda)
    else:
        bits = torch.zeros(n, dtype=torch.int32, device=cuda)
    got = int(kernels.topk_descent(bits, k))
    assert got == int(ttk._descent_plain(bits, k))
    assert got == int(ttk._descent_plain(bits.cpu(), k))
    if kind == "k>n":
        assert got == 0


def _plain_on_card(monkeypatch):
    """Every kernel of the headline server step swapped for its plain
    version, on the card."""
    def plain_estimates(table3, cs, t0=0, Tn=None, n_valid=None):
        est = tsk._sketch_estimates_plain(table3, cs.inv_q, cs.inv_w,
                                          cs.sign_keys, t0)
        return est if n_valid is None else tsk._mask_from(est, t0, n_valid)

    monkeypatch.setattr(tsk, "sketch_estimates", plain_estimates)
    monkeypatch.setattr(tsk, "sketch_accumulate",
                        tsk._sketch_accumulate_plain)
    monkeypatch.setattr(ttk, "topk_count_ge", ttk._count_ge_plain)
    monkeypatch.setattr(ttk, "topk_descent", ttk._descent_plain)


@pytest.mark.gpu
def test_zero_sign_at_p_zero(cuda, monkeypatch):
    """The headline server step at top-k threshold 0 (fewer than k nonzero
    estimates: 2,000 nonzero cells a row, and an estimate is nonzero only
    where 3 of its 5 cells are), through the kernels and through the plain
    versions, on weights a quarter of which are -0.0 and a quarter +0.0.
    Every estimate is kept, so the query's free sign of a zero median
    reaches ``ps - update``: the new weights must be equal under ==, and
    differ in at most the sign bit of zero weights; the count of such
    weights is printed."""
    from commefficient_torch.federated import server as tsrv

    d, c, r, k, lr = 6_568_640, 500_000, 5, 50_000, 0.1
    cs = tsk.make_sketch(d, c, r, seed=0, device=cuda)
    gen = torch.Generator().manual_seed(0)
    table = torch.zeros(cs.table_shape)
    for j in range(r):
        idx = torch.randperm(cs.c_pad, generator=gen)[:2000]
        table[j, idx] = torch.randn(2000, generator=gen)
    table = table.to(cuda)
    w = torch.randn(d, generator=gen)
    w[0::4] = -0.0
    w[1::4] = 0.0
    ps3 = cs.chunk_layout.chunk(w.to(cuda))
    cfg = tsrv.ServerConfig(mode="sketch", error_type="virtual", k=k,
                            grad_size=d, virtual_momentum=0.9)
    state = tsrv.init_server_state(cfg, cs)
    est = tsk.estimates_chunks(cs, table)
    assert int((est != 0).sum()) < k
    assert int(ttk.resolve_threshold(est, k)) == 0
    upd_k, st_k = tsrv.server_update(table, state, cfg, lr, sketch=cs,
                                     layout=cs.chunk_layout)
    new_k = ps3 - upd_k
    kernels.reset_launch_counts()
    with monkeypatch.context() as m:
        _plain_on_card(m)
        upd_p, st_p = tsrv.server_update(table, state, cfg, lr, sketch=cs,
                                         layout=cs.chunk_layout)
        new_p = ps3 - upd_p
        torch.cuda.synchronize()
    assert kernels.launch_counts() == ALL_ZERO, "plain path launched"
    for a, b in ((upd_k, upd_p), (st_k.velocity, st_p.velocity),
                 (st_k.error, st_p.error), (new_k, new_p)):
        assert _nan_equal(a, b)
    sign_only = (new_k.view(torch.int32) != new_p.view(torch.int32))
    assert not new_k[sign_only].any() and not new_p[sign_only].any()
    zero_w = int((new_p == 0).sum())
    print(f"zero weights {zero_w}, of which {int(sign_only.sum())} differ "
          f"in the sign bit (kernels against plain versions, p = 0)")


def _lifecycle_model(cuda, extra=()):
    """A tiny headline round on the card: ResNet9 at 8/16/16/32 channels,
    a 3 x 2048 sketch, 4 clients of 8 a round."""
    from commefficient_torch.config import parse_args
    from commefficient_torch.federated import FedModel, FedOptimizer, LambdaLR
    from commefficient_torch.federated.losses import make_cv_losses
    from commefficient_torch.models import ResNet9

    args = parse_args(argv=[
        "--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--k", "500", "--num_cols", "2048",
        "--num_rows", "3", "--num_blocks", "2", "--num_workers", "4",
        "--num_clients", "8", "--dataset_name", "CIFAR10",
        "--local_batch_size", "4", "--seed", "0",
        "--checkpoint_path", "unused"] + list(extra))
    model = ResNet9(channels=(("prep", 8), ("layer1", 16), ("layer2", 16),
                              ("layer3", 32)))
    train, val = make_cv_losses(model)
    fm = FedModel(model, train, args, val, num_clients=8, device=cuda)
    opt = FedOptimizer(fm, args)
    return args, fm, opt, LambdaLR(opt, lambda s: 0.05 * (1 + s % 7))


def _lifecycle_batch(rnd):
    rng = np.random.RandomState(500 + rnd)
    return {"inputs": rng.randn(4, 4, 32, 32, 3).astype(np.float32),
            "targets": rng.randint(0, 10, size=(4, 4)).astype(np.int64),
            "mask": np.ones((4, 4), np.float32),
            "client_ids": rng.choice(8, 4, replace=False).astype(np.int32),
            "worker_mask": np.ones(4, np.float32)}


@pytest.fixture
def deterministic_cudnn():
    old = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


@pytest.mark.gpu
def test_engine_submits_without_stream_sync(cuda, deterministic_cudnn):
    """Between drains no submit synchronizes the stream (armed with
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    synchronizing call) or fetches; the drained results equal the
    synchronous loop's bit for bit, and so do the weights."""
    from commefficient_torch.federated.engine import PipelinedRoundEngine
    from commefficient_torch.profiling import host_sync_monitor

    _, fm_s, opt_s, sched_s = _lifecycle_model(cuda)
    _, fm_e, opt_e, sched_e = _lifecycle_model(cuda)
    eng = PipelinedRoundEngine(fm_e, opt_e, sched_e, window=2,
                               drain_every=4)
    want, got = [], []
    for rnd in range(12):
        b = _lifecycle_batch(rnd)
        sched_s.step()
        want.append(fm_s(b))
        opt_s.step()
        if eng.pending + 1 < eng.drain_every:
            with host_sync_monitor(strict=True) as counter:
                assert eng.submit(b) == []
            assert counter.count == 0
        else:
            got.extend(eng.submit(b))
    got.extend(eng.drain())
    assert eng.window_waits > 0
    for r, w in zip(got, want):
        for a, b in zip(r.values, w):
            np.testing.assert_array_equal(a, b)
    assert _bit_equal(fm_e.ps_weights, fm_s.ps_weights)


@pytest.mark.gpu
def test_resume_bit_equal_on_card(cuda, deterministic_cudnn, tmp_path):
    """6 rounds straight against 3, ``save_round_state``, a new model
    restored with ``load_run_state``, and 3 more: weights, server state
    and the download accounting are bit-equal."""
    from commefficient_torch.federated.checkpoint import (
        load_run_state,
        save_round_state,
    )

    def rounds(fm, opt, sched, rng):
        for rnd in rng:
            sched.step()
            fm(_lifecycle_batch(rnd))
            opt.step()

    _, fm_a, opt_a, sched_a = _lifecycle_model(cuda)
    rounds(fm_a, opt_a, sched_a, range(6))
    args, fm_b, opt_b, sched_b = _lifecycle_model(cuda)
    args.checkpoint_path = str(tmp_path)
    rounds(fm_b, opt_b, sched_b, range(3))
    sampler = {"permuted": np.arange(8), "cursor": np.zeros(8, np.int64)}
    path = save_round_state(args, 0, 3, sampler, fm_b, opt_b, sched_b,
                            (0.0, 0.0))
    _, fm_c, opt_c, sched_c = _lifecycle_model(cuda)
    fm_c.ps_weights = fm_c.ps_weights + 1.0
    _, _, mid = load_run_state(path, fm_c, opt_c, sched_c)
    assert mid["rounds_done"] == 3
    rounds(fm_c, opt_c, sched_c, range(3, 6))
    for a, b in ((fm_c.ps_weights, fm_a.ps_weights),
                 (opt_c.server_state.velocity, opt_a.server_state.velocity),
                 (opt_c.server_state.error, opt_a.server_state.error),
                 (fm_c._prev_ps, fm_a._prev_ps)):
        assert _bit_equal(a, b)
    assert torch.equal(fm_c._last_changed, fm_a._last_changed)
    np.testing.assert_array_equal(fm_c._client_part_round,
                                  fm_a._client_part_round)
    assert fm_c.rounds_dispatched == fm_a.rounds_dispatched == 6


# GPT-2's geometry in miniature: more than 200 chunks of a narrow table
# (its round runs Tn = 249 chunks of 500,096)
GPT2_LIKE = (430_001, 2_000, 5, 21)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["accumulate", "accumulate_into",
                                  "estimates", "count_and_descent",
                                  "epilogue"])
def test_kernels_at_gpt2_like_chunk_count(cuda, kind):
    """Each kernel against its plain version at Tn = 210 chunks of 2,048
    cells (the accumulate's shift-tile loop, the query's grid over the
    chunk rows, the count pass's single-launch publication, the
    descent's grid): exact, as everywhere."""
    d, c, r, seed = GPT2_LIKE
    cs = tsk.make_sketch(d, c, r, seed=seed, device=cuda)
    assert cs.T == 210
    gen = torch.Generator().manual_seed(seed)
    v3 = cs.chunk_layout.chunk(_special(torch.randn(d, generator=gen)))
    v3 = v3.to(cuda)
    q, w, keys = cs.shift_q, cs.shift_w, cs.sign_keys
    table = tsk._sketch_accumulate_plain(v3, q, w, keys, 0)
    if kind == "accumulate":
        got = kernels.sketch_accumulate(v3, q, w, keys, 0)
        torch.cuda.synchronize()
        assert _nan_equal(got, table)
    elif kind == "accumulate_into":
        tbl = torch.randn(table.shape, generator=gen).to(cuda)
        got = kernels.sketch_accumulate_into(tbl, v3, q, w, keys, 0)
        want = tsk._sketch_accumulate_into_plain(tbl, v3, q, w, keys, 0)
        torch.cuda.synchronize()
        assert _bit_equal(got, want)
    elif kind == "estimates":
        got = kernels.sketch_estimates(table, q, w, keys, 0, d)
        want = cs.chunk_layout.mask_tail(tsk._sketch_estimates_plain(
            table, cs.inv_q, cs.inv_w, keys, 0))
        torch.cuda.synchronize()
        assert _nan_equal(got, want)
    else:
        est = cs.chunk_layout.mask_tail(tsk._sketch_estimates_plain(
            torch.nan_to_num(table), cs.inv_q, cs.inv_w, keys, 0))
        k = 2_000
        if kind == "count_and_descent":
            bits = est.reshape(-1).view(torch.int32)
            p = torch.zeros((), dtype=torch.int32, device=cuda)
            for shift in range(28, -1, -4):
                ts = ttk._pass_thresholds(p, shift)
                want = ttk._count_ge_plain(bits, ts)
                assert torch.equal(kernels.topk_count_ge(bits, ts), want)
                p = p + ((want >= k).sum().to(torch.int32) << shift)
            assert int(kernels.topk_descent(bits, k)) == int(p) == \
                int(ttk._descent_plain(bits, k))
        else:
            p = ttk.resolve_threshold(est, k)
            got_u, got_t = kernels.fused_epilogue(est, p, q, w, keys, 0)
            want_u, want_t = tsk._fused_epilogue_plain(est, p, q, w, keys, 0)
            torch.cuda.synchronize()
            assert _bit_equal(got_u, want_u) and _bit_equal(got_t, want_t)


@pytest.mark.gpu
def test_tiny_gpt2_round_on_card(cuda, monkeypatch):
    """A tiny GPT-2 sketch round on the card (dropout on): 2 / 1 / 8
    launches of the accumulate, the query and the count pass, a finite
    loss, and one server step through the kernels equal to the plain
    versions."""
    from commefficient_torch.config import parse_args
    from commefficient_torch.federated import FedModel, FedOptimizer
    from commefficient_torch.federated.losses import make_gpt2_losses
    from commefficient_torch.federated.rounds import ClientStates
    from commefficient_torch.models import GPT2DoubleHeads

    args = parse_args(argv=[
        "--mode", "sketch", "--error_type", "virtual", "--local_momentum",
        "0", "--virtual_momentum", "0.9", "--k", "2000", "--num_cols",
        "20000", "--num_rows", "5", "--num_workers", "3", "--num_clients",
        "6", "--dataset_name", "PERSONA", "--local_batch_size", "2",
        "--seed", "0"])
    model = GPT2DoubleHeads(vocab_size=512, n_positions=64, n_embd=64,
                            n_layer=2, n_head=2)
    train, val = make_gpt2_losses(model)
    fm = FedModel(model, train, args, val, num_clients=6, device=cuda)
    opt = FedOptimizer(fm, args)
    opt.set_lr_factor(0.05)
    rng = np.random.RandomState(0)
    batch = {"input_ids": rng.randint(0, 512, (3, 2, 2, 32)),
             "token_type_ids": rng.randint(0, 512, (3, 2, 2, 32)),
             "lm_labels": rng.randint(0, 512, (3, 2, 2, 32)),
             "mc_token_ids": rng.randint(0, 32, (3, 2, 2)),
             "mc_labels": rng.randint(0, 2, (3, 2)),
             "mask": np.ones((3, 2), np.float32),
             "client_ids": np.arange(3, dtype=np.int32),
             "worker_mask": np.ones(3, np.float32)}
    kernels.reset_launch_counts()
    loss = fm(batch)[0]
    opt.step()
    torch.cuda.synchronize()
    assert np.all(np.isfinite(loss))
    assert kernels.launch_counts() == {**ALL_ZERO, "sketch_accumulate": 2,
                                       "sketch_estimates": 1,
                                       "topk_count_ge": 8}
    fm.begin_round(batch)
    ctx, lr = fm._round_ctx, opt.get_lr()

    def states():
        return ClientStates(*(None if x is None else x.clone()
                              for x in fm.client_states))

    out_k = fm.steps.server_step(fm.ps_weights, opt.server_state, states(),
                                 ctx, lr, fm._rng)
    with monkeypatch.context() as m:
        _plain_on_card(m)
        out_p = fm.steps.server_step(fm.ps_weights, opt.server_state,
                                     states(), ctx, lr, fm._rng)
    torch.cuda.synchronize()
    # the weights, server and client state (then the metric vector: the
    # telemetry plane is on by default)
    (ps_k, ss_k, _), (ps_p, ss_p, _) = out_k[:3], out_p[:3]
    for a, b in ((ps_k, ps_p), (ss_k.velocity, ss_p.velocity),
                 (ss_k.error, ss_p.error)):
        assert _nan_equal(a, b)


# FEMNIST ResNet101-LN's geometry: d = 42,620,926 in Tn = 86 chunks of
# c_pad = 500,096, r = 5, the count pass and the descent over Tn * c_pad
# patterns at k = 50,000
FEMNIST_D, FEMNIST_K = 42_620_926, 50_000


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sketch_accumulate",
                                  "sketch_accumulate_into",
                                  "sketch_estimates", "fused_epilogue",
                                  "topk_count_ge", "topk_descent"])
def test_kernels_at_femnist_geometry(cuda, name):
    cs = tsk.make_sketch(FEMNIST_D, 500_000, 5, seed=7, device=cuda)
    assert (cs.T, cs.c_pad) == (86, 500_096)
    gen = torch.Generator().manual_seed(86)
    v3 = cs.chunk_layout.chunk(torch.randn(FEMNIST_D, generator=gen)
                               ).to(cuda)
    tbl = torch.randn((5, cs.sublanes, 128), generator=gen).to(cuda)
    q, w, keys = cs.shift_q, cs.shift_w, cs.sign_keys
    kern = next(k for k in kernels.KERNELS if k.name == name)
    before = kern.launches
    if name == "sketch_accumulate":
        got = kernels.sketch_accumulate(v3, q, w, keys, 0)
        assert _nan_equal(got, tsk._sketch_accumulate_plain(v3, q, w, keys,
                                                            0))
    elif name == "sketch_accumulate_into":
        got = kernels.sketch_accumulate_into(tbl, v3, q, w, keys, 0)
        assert _bit_equal(got, tsk._sketch_accumulate_into_plain(
            tbl, v3, q, w, keys, 0))
    elif name == "sketch_estimates":
        got = kernels.sketch_estimates(tbl, q, w, keys, 0, FEMNIST_D)
        iq, iw = tsk._shift_cols(cs.inv_q, cs.inv_w, 0, cs.T)
        want = cs.chunk_layout.mask_tail(tsk._sketch_estimates_plain(
            tbl, iq, iw, keys, 0))
        assert _nan_equal(got, want)
        assert not got.view(-1)[FEMNIST_D:].view(torch.int32).any()
    elif name == "fused_epilogue":
        est = tsk.estimates_chunks(cs, tbl)
        p = ttk.resolve_threshold(est, FEMNIST_K)
        upd, t = kernels.fused_epilogue(est, p, q, w, keys, 0)
        want_u, want_t = tsk._fused_epilogue_plain(est, p, q, w, keys, 0)
        assert _bit_equal(upd, want_u) and _bit_equal(t, want_t)
        assert int((upd != 0).sum()) >= FEMNIST_K
    else:
        bits = v3.reshape(-1).view(torch.int32)
        if name == "topk_count_ge":
            p = torch.zeros((), dtype=torch.int32, device=cuda)
            for shift in range(28, -1, -4):
                ts = ttk._pass_thresholds(p, shift)
                want = ttk._count_ge_plain(bits, ts)
                assert torch.equal(kernels.topk_count_ge(bits, ts), want)
                p = p + ((want >= FEMNIST_K).sum().to(torch.int32) << shift)
            assert kern.launches == before + 8
            assert int(p) == int(ttk._descent_plain(bits, FEMNIST_K))
            return
        got = int(kernels.topk_descent(bits, FEMNIST_K))
        assert got == int(ttk._descent_plain(bits, FEMNIST_K))
    torch.cuda.synchronize()
    assert kern.launches == before + 1
