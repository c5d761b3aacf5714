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


# Thresholds beyond the descent's sorted p + (j << shift), as the count
# pass's contract allows (the sharded server counts others): unsorted, with
# repeats, 0, negative ones and 0x7FFFFFFF; all 0x7FFFFFFF; and 16 of the
# data's own magnitudes in random order
MIXED_THRESHOLDS = [0x3F400000, 0, 0x7F800000, 0x3F400000, 1, 0x7FFFFFFF,
                    -5, 0x3E800000, 0x00800000, 0x3F400000, 0x7F7FFFFF,
                    0x100, 0x3F000000, -2**31, 0x40400000, 0x3F400001]


def _thresholds(kind, bits):
    if kind == "mixed":
        return np.array(MIXED_THRESHOLDS, np.int32)
    if kind == "all-max":
        return np.full(16, 0x7FFFFFFF, np.int32)
    m = bits & 0x7FFFFFFF
    m = np.where(m > 0x7F800000, 0, m)
    return m[np.random.RandomState(2).randint(0, bits.size, 16)]


@pytest.mark.parametrize("kind", ["mixed", "all-max", "own"])
def test_count_pass_any_thresholds_matches_pallas_kernel(kind):
    """The count pass at unsorted, repeated, zero and negative thresholds.
    Two whole blocks of the Pallas kernel (2 * 512 * 128 patterns), so its
    zero padding, which thresholds <= 0 would count, is empty."""
    v = _edge(2 * 512 * 128, "special")
    bits = v.view(np.int32)
    ts = _thresholds(kind, bits)
    v3, T = jtk._blocks3(jnp.asarray(bits))
    assert T * 512 * 128 == bits.size
    want = np.asarray(jtk._count_ge_pallas(v3, jnp.asarray(ts), T=T,
                                           interpret=True))
    got = ttk.topk_count_ge(torch.from_numpy(bits), torch.from_numpy(ts))
    np.testing.assert_array_equal(got.numpy(), want)


def _bucket_count(bits, ts):
    """A numpy transcription of the card's count pass
    (``csrc/sketch_kernels.cu``): the 16 thresholds sorted by stable rank
    and padded with 16 sentinels no magnitude reaches, a pattern's bucket
    ``#{i : sorted[i] <= mag}`` by the 5-step binary search (the first
    pivot ``sorted[15]``), a histogram of the buckets, suffix sums over
    buckets 1..16, and each threshold's count read at its rank."""
    ts = np.asarray(ts, np.int64)
    rank = np.array([sum(ts[i] < ts[j] or (ts[i] == ts[j] and i < j)
                         for i in range(16)) for j in range(16)])
    s = np.full(32, 0x7FFFFFFF, np.int64)
    s[rank] = ts
    m = bits.astype(np.int64) & 0x7FFFFFFF
    m = np.where(m > 0x7F800000, 0, m)
    b = np.where(s[15] <= m, 16, 0)
    for step in (8, 4, 2, 1):
        b = np.where(s[b + step - 1] <= m, b + step, b)
    total = np.bincount(b, minlength=17)[1:]   # buckets 1..16
    suffix = np.cumsum(total[::-1])[::-1]       # patterns in buckets >= q+1
    return suffix[rank].astype(np.int32)


@pytest.mark.parametrize("data", ["random", "special", "ties", "subnormal",
                                  "zeros"])
@pytest.mark.parametrize("kind", ["mixed", "all-max", "own", "descent"])
def test_bucket_count_transcription_matches_plain(data, kind):
    """The card's bucket search, transcribed, equals the plain count on the
    descent's thresholds and on any others."""
    bits = _edge(5000, data).view(np.int32)
    if kind == "descent":
        ts = ttk._pass_thresholds(torch.tensor(0x3F000000, dtype=torch.int32),
                                  20).numpy()
    else:
        ts = _thresholds(kind, bits)
    want = ttk._count_ge_plain(torch.from_numpy(bits), torch.from_numpy(ts))
    np.testing.assert_array_equal(_bucket_count(bits, ts), want.numpy())


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
    """(Once the pin of the missing sort method; the name stays.) The
    port's ``method="sort"`` returns the JAX package's values bit for bit
    on ``tests/test_ops.py``'s sort cases: the heavy-tailed 4,096-vector
    at k = 256, k > d, 1-D and row-wise 2-D inputs, ties (the lower index
    wins, as in ``lax.top_k``), and the randomized shapes over 60 orders
    of magnitude; an unknown method raises ``ValueError`` in both."""
    rng = np.random.RandomState(7)
    ties = np.zeros(40, np.float32)
    ties[[3, 9, 17, 30]] = 2.5
    ties[[5, 25]] = -2.5
    cases = [((rng.randn(4096) * rng.rand(4096) ** 3).astype(np.float32),
              256),
             (np.random.RandomState(1).randn(7).astype(np.float32), 12),
             (ties, 3),
             (np.random.RandomState(4).randn(3, 500).astype(np.float32), 20)]
    r = np.random.RandomState(0)
    for t, (d, k) in enumerate([(10, 3), (257, 260), (1024, 1),
                                (8192, 500), (19997, 4096)]):
        scale = 10.0 ** r.randint(-30, 30)
        cases.append(((r.randn(d) * scale * (r.rand(d) ** r.randint(0, 6)))
                      .astype(np.float32), k))
    for v, k in cases:
        want = np.asarray(jtk.topk(jnp.asarray(v), k, method="sort"))
        got = ttk.topk(torch.from_numpy(v.copy()), k, method="sort").numpy()
        np.testing.assert_array_equal(got, want)
    assert set(np.flatnonzero(ttk.topk(torch.from_numpy(ties), 3,
                                       method="sort").numpy())) == {3, 5, 9}
    with pytest.raises(ValueError, match="unknown topk method"):
        ttk.topk(torch.zeros(10), 2, method="heap")
    with pytest.raises(ValueError, match="unknown topk method"):
        jtk.topk(jnp.zeros(10), 2, method="heap")
