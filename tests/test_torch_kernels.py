"""The port's CUDA kernels (commefficient_torch/csrc/sketch_kernels.cu)
against their plain PyTorch versions.

Tests marked ``gpu`` need an NVIDIA card and skip without one; whether a
card is present is decided inside the ``cuda`` fixture, never at import.
On the card: ``python -m pytest tests/test_torch_kernels.py -m gpu``.
Every comparison is exact (``torch.equal``, NaN-aware): the accumulate
keeps the plain version's per-cell add order, the query its min/max
network, and the counts are integers.
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
    """sm_90a target, and never fast-math (it flushes subnormals)."""
    flags = " ".join(kernels.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "ftz=true" not in flags
    src = kernels.SOURCE.read_text()
    for name in ("sketch_accumulate", "sketch_estimates", "topk_count_ge"):
        assert f"int {name}(" in src


def test_launch_counters_start_and_reset():
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "sketch_accumulate": 0, "sketch_estimates": 0, "topk_count_ge": 0}
    assert [k.name for k in kernels.KERNELS] == list(kernels.launch_counts())
    assert all(k.replaces.startswith("commefficient_tpu/ops/")
               for k in kernels.KERNELS)


def test_plain_versions_on_cpu_do_not_count():
    kernels.reset_launch_counts()
    cs = tsk.make_sketch(2000, 256, 3, seed=1, device="cpu")
    v = torch.from_numpy(np.random.RandomState(1).randn(2000)
                         .astype(np.float32))
    tsk.unsketch(cs, tsk.sketch_vec(cs, v), 10)
    assert kernels.launch_counts() == {
        "sketch_accumulate": 0, "sketch_estimates": 0, "topk_count_ge": 0}
