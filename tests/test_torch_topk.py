"""The port's radix-descent top-k (commefficient_torch/ops/topk.py) against
the JAX package on the CPU.

The descent is exact integer arithmetic on bit patterns, so the resolved
threshold and the kept set must match bit for bit: against the XLA descent
(``_threshold_descent_xla``) and against the Pallas count-pass descent run
in interpret mode (``_threshold_descent_pallas``). The dense outputs are
compared with ``assert_array_equal`` (NaN equal to NaN).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402

# the package re-exports a function named topk over the module name
jtk = importlib.import_module("commefficient_tpu.ops.topk")
ttk = importlib.import_module("commefficient_torch.ops.topk")


def _edge(n, kind):
    v = np.zeros(n, np.float32)
    if kind == "random":
        v = np.random.RandomState(n).randn(n).astype(np.float32)
    elif kind == "special":
        v[:10] = 3.0
        v[10:20] = -3.0
        v[20] = np.inf
        v[21] = -np.inf
        v[22] = np.nan
        v[23] = -np.nan
        v[24:40] = 1e-40           # subnormals
        v[40:45] = -1e-45
        v[45:60] = np.random.RandomState(1).randn(15)
    elif kind == "ties":
        v[:30] = 2.5
        v[30:60] = -2.5
        v[60:100] = 1.0
    elif kind == "subnormal":
        v = (np.random.RandomState(5).randn(n) * 1e-40).astype(np.float32)
    elif kind == "sparse":
        v[:5] = 2.0
    # "zeros": all zero
    return v


CASES = [
    (70_001, "random", 1000),
    (4096, "random", 64),
    (66_000, "special", 15),
    (66_000, "special", 3),
    (5000, "ties", 45),
    (5000, "subnormal", 64),
    (5000, "zeros", 10),
    (66_000, "sparse", 1000),   # fewer nonzeros than k
    (300, "random", 500),       # k > d
    (300, "random", 300),       # k == d
]


@pytest.mark.parametrize("n,kind,k", CASES)
def test_threshold_and_kept_set_match_xla(n, kind, k):
    v = _edge(n, kind)
    want_p = int(jtk._threshold_descent_xla(jnp.asarray(v).view(jnp.int32),
                                            k))
    got_p = int(ttk.resolve_threshold(torch.from_numpy(v), k))
    assert got_p == want_p
    want = np.asarray(jtk._topk_threshold_1d(jnp.asarray(v), k))
    got = ttk.topk(torch.from_numpy(v), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.view(np.int32) != 0,
                                  want.view(np.int32) != 0)


@pytest.mark.parametrize("n,kind,k", CASES[:4] + CASES[5:6] + CASES[7:9])
def test_threshold_matches_pallas_interpret(n, kind, k):
    v = _edge(n, kind)
    want = int(jtk._threshold_descent_pallas(
        jnp.asarray(v).view(jnp.int32), k, interpret=True))
    assert int(ttk.resolve_threshold(torch.from_numpy(v), k)) == want


def test_count_pass_matches_pallas_kernel():
    """One pass of the count kernel's contract, 16 padded candidates."""
    v = _edge(70_001, "special")
    bits = torch.from_numpy(v).view(torch.int32)
    ts = ttk._pass_thresholds(torch.tensor(0x3F000000, dtype=torch.int32), 20)
    raw = jnp.asarray(v).view(jnp.int32)
    v3, T = jtk._blocks3(raw)
    want = np.asarray(jtk._count_ge_pallas(v3, jnp.asarray(ts.numpy()), T=T,
                                           interpret=True))
    np.testing.assert_array_equal(ttk.topk_count_ge(bits, ts).numpy(), want)


def test_nan_passes_through_and_never_wins():
    v = np.arange(1, 101, dtype=np.float32)
    v[7] = np.nan
    out = ttk.topk(torch.from_numpy(v), 5).numpy()
    assert np.isnan(out[7])
    np.testing.assert_array_equal(np.flatnonzero(np.nan_to_num(out)),
                                  [95, 96, 97, 98, 99])


def test_chunked_shape_preserving():
    """topk_dense_nd over a (T, S, 128) plane equals the flat top-k."""
    v = np.random.RandomState(3).randn(4, 16, 128).astype(np.float32)
    got = ttk.topk_dense_nd(torch.from_numpy(v), 777).numpy()
    want = np.asarray(jtk.topk_dense_nd(jnp.asarray(v), 777))
    assert got.shape == v.shape
    np.testing.assert_array_equal(got, want)


def test_rowwise_2d():
    v = np.random.RandomState(4).randn(3, 500).astype(np.float32)
    want = np.asarray(jtk.topk(jnp.asarray(v), 20))
    np.testing.assert_array_equal(ttk.topk(torch.from_numpy(v), 20).numpy(),
                                  want)


def test_sort_method_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttk.topk(torch.zeros(10), 2, method="sort")
