"""The port's median query on the CPU: the card kernel's median step
(``commefficient_torch/csrc/sketch_kernels.cu::median_of``) transcribed
in PyTorch and held against the JAX package's ``_median_small``, its sign
hash (``csrc/sketch_common.cuh::sign_word``) transcribed in numpy and
held against ``_signs_for``, and the query's tail mask against the JAX
entry points.

The kernel takes the median with NaN-propagating min and max (``min.NaN``
/ ``max.NaN``): R = 5 and R = 3 by short formulas, other R by the bubble
network. Among equal values it may pick another one than the bubble
network does, so the sign of a zero median is free (no consumer reads it);
values, and NaN positions, must be equal. ``assert_array_equal`` compares
that way (+0.0 equals -0.0, NaN equals NaN). The tail's zeros are not
free: the mask writes +0.0, bit for bit.

Subnormals are kept out of the JAX comparisons: XLA on the CPU flushes
them to zero in min, max and arithmetic; the port does not.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402


def _median3(x, y, z):
    mn, mx = torch.minimum, torch.maximum
    return mx(mn(x, y), mn(mx(x, y), z))


def kernel_median(rows):
    """``median_of<R>`` of the query kernel, transcribed: ``torch.minimum``
    and ``torch.maximum`` propagate NaN as ``min.NaN`` and ``max.NaN`` do."""
    mn, mx = torch.minimum, torch.maximum
    r = len(rows)
    if r == 5:
        a, b, c, d, e = rows
        return _median3(e, mx(mn(a, b), mn(c, d)), mn(mx(a, b), mx(c, d)))
    if r == 3:
        return _median3(*rows)
    v = list(rows)
    for i in range(r):
        for j in range(r - 1 - i):
            v[j], v[j + 1] = mn(v[j], v[j + 1]), mx(v[j], v[j + 1])
    if r % 2:
        return v[r // 2]
    return 0.5 * (v[r // 2 - 1] + v[r // 2])


SPECIAL = np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, np.inf, np.nan],
                   np.float32)


def _rows(r: int) -> np.ndarray:
    """``(r, n)`` float32 rows: for r <= 5 every r-tuple of SPECIAL; for
    larger r seeded values with many ties (a few levels, both zeros), NaN
    and infinities."""
    if r <= 5:
        return np.array(list(itertools.product(SPECIAL, repeat=r)),
                        np.float32).T.copy()
    rng = np.random.RandomState(r)
    n = 20_000
    rows = (rng.randint(-3, 4, size=(r, n)) * 0.5).astype(np.float32)
    rows[rng.rand(r, n) < 0.15] = -0.0
    rows[rng.rand(r, n) < 0.02] = np.inf
    rows[rng.rand(r, n) < 0.02] = -np.inf
    rows[rng.rand(r, n) < 0.01] = np.nan
    return rows


@pytest.mark.parametrize("r", range(1, 9))
def test_kernel_median_matches_jax_network(r):
    rows = _rows(r)
    want = np.asarray(jsk._median_small([jnp.asarray(x) for x in rows]))
    got = kernel_median([torch.from_numpy(x) for x in rows]).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got, want)
    # a NaN in any row gives a NaN median (even r also adds inf + -inf)
    assert np.isnan(got[np.isnan(rows).any(axis=0)]).all()
    if r <= 5:
        assert np.isnan(rows).any(axis=0).sum() == 7 ** r - 6 ** r


@pytest.mark.parametrize("r", range(1, 9))
def test_kernel_median_keeps_subnormals(r):
    """Against the port's own bubble network (which keeps subnormals, as
    the kernel does): subnormal rows, with ties."""
    rng = np.random.RandomState(100 + r)
    levels = np.array([-3e-40, -1e-45, -0.0, 0.0, 1e-45, 2e-40, 1e-38],
                      np.float32)
    rows = levels[rng.randint(0, len(levels), size=(r, 5000))]
    got = kernel_median([torch.from_numpy(x) for x in rows]).numpy()
    want = tsk._median_small([torch.from_numpy(x) for x in rows]).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[got != 0]) < 1.2e-38).any()


def sign_word(folded: np.ndarray) -> np.ndarray:
    """``csrc/sketch_common.cuh::sign_word`` in numpy uint32: bit 31 is
    bit 0 of fmix32 of the value whose fold16 is ``folded``."""
    y = folded * np.uint32(0x85EBCA6B)
    y ^= y >> np.uint32(13)
    return y * np.uint32((0xC2B2AE35 * 0x80008000) & 0xFFFFFFFF)


def test_kernel_sign_word_matches_jax_signs():
    """The query's sign: fold16 of the coordinate shared by the rows,
    xored with the row key's fold16, bit 31 of sign_word set for +1; equal
    to the JAX package's ``_signs_for`` at every coordinate and key, the
    high-bit keys and a wrapping coordinate included."""
    rng = np.random.RandomState(5)
    idx = np.concatenate([rng.randint(0, 2**31 - 1, size=200_000),
                          [0, 1, 65535, 65536, 2**31 - 1]]).astype(np.int32)
    keys = np.array([1, 2**31 - 2, -1, -(2**31), -123456789, 0x5bd1e995],
                    np.int64).astype(np.int32)
    u = idx.view(np.uint32)
    fold = u ^ (u >> np.uint32(16))
    for key in keys:
        k = np.uint32(key.view(np.uint32))
        word = sign_word(fold ^ (k ^ (k >> np.uint32(16))))
        got = np.where(word >> np.uint32(31), 1.0, -1.0).astype(np.float32)
        want = np.asarray(jsk._signs_for(jnp.asarray(idx), jnp.int32(key)))
        np.testing.assert_array_equal(got, want)


def _pair(d, c, r, seed):
    return (jsk.make_sketch(d, c, r, seed=seed, num_blocks=2),
            tsk.make_sketch(d, c, r, seed=seed, num_blocks=2, device="cpu"))


def _table(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("d,c,r", [(2 * 1024 + 1, 1000, 5),
                                   (3 * 384 + 7, 300, 4)])
def test_estimates_chunks_tail_is_positive_zero(d, c, r):
    """A tail of almost a chunk (all but 1 or 7 positions of the last
    chunk): every tail cell is +0.0 bit for bit, and the rest equals the
    JAX package's estimates_chunks."""
    js, ts = _pair(d, c, r, 3)
    tbl = _table(js.table_shape, d)
    want = np.asarray(jsk.estimates_chunks(js, jnp.asarray(tbl)))
    got = tsk.estimates_chunks(ts, torch.from_numpy(tbl))
    assert got.shape == (ts.T, ts.sublanes, 128)
    flat = got.reshape(-1)
    tail = flat[d:]
    assert tail.numel() == ts.T * ts.c_pad - d >= ts.c_pad - 7
    assert torch.equal(tail.view(torch.int32), torch.zeros_like(
        tail, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)
    # unmasked, the same query has hash noise there
    raw = tsk.sketch_estimates(torch.from_numpy(tbl).view(
        ts.r, ts.sublanes, 128), ts).reshape(-1)
    assert (raw[d:] != 0).any()
    assert torch.equal(raw[:d], flat[:d])


@pytest.mark.parametrize("t0,Tn", [(0, 2), (1, 2), (2, 3), (3, 2)])
def test_query_mask_by_global_coordinate(t0, Tn):
    """``n_valid = d`` on a chunk range from ``t0`` (chunks past T
    included) equals the JAX package's estimates_chunks_local: positions
    at and past d, by global coordinate, are +0.0."""
    js, ts = _pair(2 * 1024 + 100, 1000, 3, 5)
    tbl = _table(js.table_shape, t0)
    want = np.asarray(jsk.estimates_chunks_local(
        js, jnp.asarray(tbl), jnp.int32(t0), Tn))
    got = tsk.sketch_estimates(
        torch.from_numpy(tbl).view(ts.r, ts.sublanes, 128), ts, t0=t0,
        Tn=Tn, n_valid=ts.d)
    np.testing.assert_array_equal(got.numpy(), want)
    coord = t0 * ts.c_pad + np.arange(Tn * ts.c_pad)
    masked = got.reshape(-1)[torch.from_numpy(coord >= ts.d)]
    assert torch.equal(masked.view(torch.int32),
                       torch.zeros_like(masked, dtype=torch.int32))
