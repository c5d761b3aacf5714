"""The port's count sketch (commefficient_torch/ops/sketch.py) against the
JAX package on the CPU.

Geometry, signs, the accumulate and the query are integer math, data
movement, a sign flip and a fixed per-cell add order, so they must match
bit for bit: against the pure-JAX functions and against the Pallas kernels
run in interpret mode. Comparisons use ``assert_array_equal``, which treats
+0.0 and -0.0 as equal and NaN as equal to NaN; the sign of a zero
estimate is left to the min/max network's tie order, which no consumer
reads (the top-k compares magnitudes).

Subnormal inputs are kept out of the JAX comparisons: XLA on the CPU
flushes subnormal floats to zero in arithmetic, while the port (and its
CUDA kernels, built without fast-math) keep IEEE subnormals.
``test_subnormals_survive_round_trip`` pins the port's behaviour there.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from commefficient_tpu.ops import sketch as jsk  # noqa: E402
from commefficient_torch.ops import sketch as tsk  # noqa: E402

GEOMS = [  # (d, c, r, seed): ragged c, partial last chunk, odd and even r
    (31_640, 2048, 3, 0),
    (31_640, 2048, 4, 1),
    (5000, 300, 5, 7),
    (1024, 256, 4, 3),
]


def _pair(d, c, r, seed):
    return (jsk.make_sketch(d, c, r, seed=seed, num_blocks=2),
            tsk.make_sketch(d, c, r, seed=seed, num_blocks=2, device="cpu"))


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


@pytest.mark.parametrize("d,c,r,seed", GEOMS)
def test_geometry_bit_equal(d, c, r, seed):
    js, ts = _pair(d, c, r, seed)
    assert (ts.d, ts.c, ts.c_pad, ts.r, ts.T, ts.sublanes) == \
        (js.d, js.c, js.c_pad, js.r, js.T, js.sublanes)
    for name in ("shift_q", "shift_w", "inv_q", "inv_w", "sign_keys"):
        np.testing.assert_array_equal(_np(getattr(ts, name)),
                                      np.asarray(getattr(js, name)))
        assert getattr(ts, name).dtype == torch.int32


def test_signs_bit_equal_including_high_bit_keys():
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 2**31 - 1, size=4096).astype(np.int32)
    keys = np.array([1, 2**31 - 2, -1, -(2**31), -123456789, 0x5bd1e995],
                    np.int64).astype(np.int32)
    for key in keys:
        want = np.asarray(jsk._signs_for(jnp.asarray(idx), jnp.int32(key)))
        got = _np(tsk._signs_for(torch.from_numpy(idx),
                                 torch.tensor(int(key), dtype=torch.int32)))
        np.testing.assert_array_equal(got, want)
    mix_want = np.asarray(jsk._mix32(jnp.asarray(idx))).view(np.uint32)
    mix_got = _np(tsk._mix32(torch.from_numpy(idx).to(torch.int64)))
    np.testing.assert_array_equal(mix_got.astype(np.uint32), mix_want)


def _vec(d, seed, special=False):
    v = np.random.RandomState(seed).randn(d).astype(np.float32)
    if special:
        v[3] = np.inf
        v[10] = -np.inf
        v[41] = -0.0
    return v


@pytest.mark.parametrize("d,c,r,seed", GEOMS)
def test_accumulate_bit_equal_to_jax_scan(d, c, r, seed):
    js, ts = _pair(d, c, r, seed)
    v = _vec(d, seed, special=True)
    want = np.asarray(jsk._sketch_vec_jax(js, jnp.asarray(v)))
    got = _np(tsk.sketch_vec(ts, torch.from_numpy(v)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,c,r,seed", GEOMS[:3])
def test_accumulate_bit_equal_to_pallas_interpret(d, c, r, seed):
    js, ts = _pair(d, c, r, seed)
    v = _vec(d, seed + 1)
    v3 = jsk._chunks3(js, jnp.asarray(v))
    want = np.asarray(jsk._sketch_vec_pallas(
        v3, js.shift_q, js.shift_w, js.sign_keys, jnp.zeros(1, jnp.int32),
        S=js.sublanes, T=js.T, interpret=True)).reshape(js.r, js.c_pad)
    got = _np(tsk.sketch_chunks(ts, torch.from_numpy(np.array(v3))))
    np.testing.assert_array_equal(got, want)


def test_accumulate_with_chunk_offset_bit_equal():
    """t0 != 0: a chunk range's partial table, as the sharded server
    computes it (shift columns sliced, sign base offset)."""
    js, ts = _pair(5000, 300, 5, 7)
    v3 = np.array(jsk._chunks3(js, jnp.asarray(_vec(5000, 3))))
    for t0, Tn in ((1, 2), (3, 5), (js.T - 2, 4)):
        part = np.zeros((Tn,) + v3.shape[1:], np.float32)
        n = min(Tn, js.T - t0)
        part[:n] = v3[t0:t0 + n]
        want = np.asarray(jsk._sketch_chunks_jax(js, jnp.asarray(part),
                                                 jnp.int32(t0)))
        got = _np(tsk.sketch_chunks(ts, torch.from_numpy(part), t0=t0))
        np.testing.assert_array_equal(got, want)
    # and the partials of a split sum to the full table (linearity)
    full = _np(tsk.sketch_chunks(ts, torch.from_numpy(v3)))
    parts = sum(_np(tsk.sketch_chunks(ts, torch.from_numpy(v3[a:b]), t0=a))
                for a, b in ((0, 4), (4, ts.T)))
    np.testing.assert_allclose(parts, full, rtol=1e-5, atol=1e-5)


def _table(js, seed, special=False):
    t = np.random.RandomState(seed).randn(*js.table_shape).astype(np.float32)
    if special:
        t[0, 5] = np.nan
        t[1, 77] = np.inf
        t[-1, 100] = -np.inf
    return t


@pytest.mark.parametrize("d,c,r,seed", GEOMS)
def test_query_bit_equal_to_jax_scan(d, c, r, seed):
    js, ts = _pair(d, c, r, seed)
    tbl = _table(js, seed, special=True)
    want = np.asarray(jsk._estimates_chunks_jax(js, jnp.asarray(tbl)))
    got = _np(tsk.sketch_estimates(
        torch.from_numpy(tbl).view(ts.r, ts.sublanes, 128), ts))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,c,r,seed", GEOMS)
def test_query_bit_equal_to_pallas_interpret(d, c, r, seed):
    js, ts = _pair(d, c, r, seed)
    tbl = _table(js, seed + 1)
    want = np.asarray(jsk._estimates_pallas(
        jsk._doubled_table(js, jnp.asarray(tbl)), js.shift_q, js.shift_w,
        js.sign_keys, jnp.zeros(1, jnp.int32), S=js.sublanes, T=js.T,
        c_pad=js.c_pad, interpret=True))
    got = _np(tsk.sketch_estimates(
        torch.from_numpy(tbl).view(ts.r, ts.sublanes, 128), ts))
    np.testing.assert_array_equal(got, want)
    # the masked resident form equals the JAX entry point's
    np.testing.assert_array_equal(
        _np(tsk.estimates_chunks(ts, torch.from_numpy(tbl))),
        np.asarray(js.chunk_layout.mask_tail(jnp.asarray(want))))


def test_query_with_chunk_offset_bit_equal():
    js, ts = _pair(5000, 300, 5, 7)
    tbl = _table(js, 4)
    t3 = torch.from_numpy(tbl).view(ts.r, ts.sublanes, 128)
    for t0, Tn in ((1, 2), (js.T - 3, 3)):
        want = np.asarray(jsk._estimates_chunks_jax(
            js, jnp.asarray(tbl), t0=jnp.int32(t0), Tn=Tn))
        np.testing.assert_array_equal(
            _np(tsk.sketch_estimates(t3, ts, t0=t0, Tn=Tn)), want)


@pytest.mark.parametrize("r", [3, 4, 5])
def test_nan_propagates_through_median(r):
    """A NaN table cell reaches the estimate it feeds (so the top-k's NaN
    passthrough and the train loop's NaN abort can see it)."""
    js, ts = _pair(2048, 2048, r, r)
    tbl = _table(js, r)
    tbl[1, 33] = np.nan
    est = _np(tsk.sketch_estimates(
        torch.from_numpy(tbl).view(ts.r, ts.sublanes, 128), ts)).reshape(-1)
    want = np.asarray(jsk._estimates_chunks_jax(js, jnp.asarray(tbl))
                      ).reshape(-1)
    np.testing.assert_array_equal(np.isnan(est), np.isnan(want))
    assert np.isnan(est).any()
    # the estimate of the coordinate that reads row 1, cell 33
    m = int(_np(ts.shift_q)[1, 0]) * 128 + int(_np(ts.shift_w)[1, 0])
    assert np.isnan(est[(33 - m) % ts.c_pad])


def test_median_small_matches_jax_network():
    rng = np.random.RandomState(2)
    for n in (1, 2, 3, 4, 5, 6):
        rows = rng.randn(n, 64).astype(np.float32)
        rows[:, :4] = 0.0
        rows[0, 5] = np.nan
        want = np.asarray(jsk._median_small([jnp.asarray(x) for x in rows]))
        got = _np(tsk._median_small([torch.from_numpy(x) for x in rows]))
        np.testing.assert_array_equal(got, want)


def test_l2estimate_matches():
    js, ts = _pair(4096, 2048, 5, 4)
    v = _vec(4096, 4)
    tj = jsk.sketch_vec(js, jnp.asarray(v))
    tt = tsk.sketch_vec(ts, torch.from_numpy(v))
    np.testing.assert_array_equal(_np(tt), np.asarray(tj))
    # fp32 row sums: torch and XLA reduce in different orders
    np.testing.assert_allclose(float(tsk.l2estimate(tt)),
                               float(jsk.l2estimate(tj)), rtol=1e-6)


def test_linearity():
    """Sum of sketches == sketch of sum, up to fp32 rounding of the sums."""
    ts = tsk.make_sketch(d=1000, c=64, r=3, seed=0, num_blocks=4,
                         device="cpu")
    rng = np.random.RandomState(0)
    a = torch.from_numpy(rng.randn(1000).astype(np.float32))
    b = torch.from_numpy(rng.randn(1000).astype(np.float32))
    np.testing.assert_allclose(
        _np(tsk.sketch_vec(ts, a) + tsk.sketch_vec(ts, b)),
        _np(tsk.sketch_vec(ts, a + b)), atol=1e-4)


def test_heavy_hitter_recovery():
    d, k = 5000, 5
    ts = tsk.make_sketch(d=d, c=2048, r=5, seed=1, num_blocks=3,
                         device="cpu")
    v = np.zeros(d, np.float32)
    heavy = [7, 123, 999, 2500, 4999]
    for i, h in enumerate(heavy):
        v[h] = 10.0 * (i + 1) * (-1) ** i
    table = tsk.sketch_vec(ts, torch.from_numpy(v))
    rec = _np(tsk.unsketch(ts, table, k))
    assert set(np.nonzero(rec)[0]) == set(heavy)
    np.testing.assert_allclose(rec[heavy], v[heavy], rtol=1e-5)


def test_within_chunk_collision_free():
    ts = tsk.make_sketch(d=256, c=256, r=3, seed=2, device="cpu")
    v = torch.from_numpy(np.random.RandomState(2).randn(256)
                         .astype(np.float32))
    table = tsk.sketch_vec(ts, v)
    for row in range(3):
        np.testing.assert_allclose(float(torch.linalg.norm(table[row])),
                                   float(torch.linalg.norm(v)), rtol=1e-5)


def test_subnormals_survive_round_trip():
    """One row, one chunk: the query of the sketch returns the vector bit
    for bit (a cyclic shift is a bijection and the sign squares to 1),
    subnormals, infinities and signed zeros included."""
    ts = tsk.make_sketch(d=1000, c=1024, r=1, seed=5, device="cpu")
    v = _vec(1000, 5, special=True)
    v[100:140] = np.float32(1e-40) * np.arange(1, 41, dtype=np.float32)
    v[140] = -1e-45
    table = tsk.sketch_vec(ts, torch.from_numpy(v))
    back = _np(tsk.estimates(ts, table))
    np.testing.assert_array_equal(back.view(np.int32) & 0x7FFFFFFF,
                                  v.view(np.int32) & 0x7FFFFFFF)
    np.testing.assert_array_equal(back, v)
