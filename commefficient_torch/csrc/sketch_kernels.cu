// Hand-written Hopper (sm_90a) kernels of the sketched FetchSGD round: the
// accumulate (from a zero table or from an incoming one) and the fused
// server epilogue, three instantiations of one loop body; the median query
// with the tail mask;
// the top-k count pass. The one-launch top-k descent lives in
// topk_descent.cu.
//
// Built by commefficient_torch/kernels.py, one nvcc per source, with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        -Xcompiler -fPIC -c
// and linked with the other sources into one shared library loaded with
// ctypes: every entry point is a plain extern "C" function that launches on
// the caller's stream and returns cudaGetLastError().
// Never build with --use_fast_math: it flushes denormals to zero, and the
// sketch and the top-k must keep denormal values exactly.
// Conventions shared with the JAX package: sketch_common.cuh.

#include "sketch_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// sketch_accumulate, sketch_accumulate_into and fused_epilogue: three
// instantiations of one loop body (accumulate_cells), so they cannot drift
// bit-wise.
//
// sketch_accumulate replaces commefficient_tpu/ops/sketch.py::
// _sketch_vec_pallas:
//   table[j, c] = sum_t sign_j((t0+t)*c_pad + p) * x[t, p],
//   p = (c - m[j, t]) mod c_pad, chunks added in t order from 0.
// sketch_accumulate_into replaces ops/sketch.py::_accum_pallas_call (the
// running-table kernel behind _sketch_accum_pallas and
// _sketch_segments_pallas): the same sum, but each cell starts from the
// incoming table's value, so the adds are ((tbl + c_0) + c_1) + ... in chunk
// order. That continues the incoming table's fold; launching the zero-table
// kernel and adding the table afterwards would round tbl + (c_0 + c_1 + ...)
// instead and break bit-equality with the JAX fold.
// fused_epilogue replaces ops/sketch.py::_fused_epilogue_pallas. From the
// (Tn, S, 128) median estimates and the top-k threshold thr (the k-th
// largest magnitude's int32 bit pattern, read on the card from the
// descent's output, so nothing waits on the host), in one sweep:
//   u[t, p]      = est[t, p] if mag(est[t, p]) >= thr or est is NaN, else 0
//   update[t, p] = u[t, p]                                (the masked update)
//   table[j, c]  = the accumulate of u from a zero table
// which is the composed pair topk_dense_nd(est) + sketch_chunks(update) in
// one launch: the estimates are read once per row, and the update plane is
// never read back for the re-sketch. The mask is ops/topk._apply_threshold's
// on bit patterns (tie-inclusive, NaN passes through), and the update is the
// estimate itself, NaN payloads included. Row 0's blocks store it: for a
// fixed t, c -> p is a permutation, so every position is written exactly
// once, without atomics.
//
// The chunk range [t0, t0 + Tn) is read from a flat vector v in place:
// x[t, p] = v[t*c_pad + p - lpad] where 0 <= t*c_pad + p - lpad < n, else
// 0.0f. A full-range launch is lpad = 0, n = Tn*c_pad (v is the (Tn, S,
// 128) plane; the epilogue's is always full). A streamed group passes its
// concatenated leaves, its first coordinate's offset lpad in chunk t0 and
// its length n, so no zero-padded copy of the covering chunks is made.
// Positions outside the group still add sign * 0.0f, as the padded plain
// version does: skipping them would change the sign of an all-zero cell of
// the incoming table (-0.0 + +0.0 is +0.0).
//
// The epilogue may skip the adds of zeros instead, and stays bit-identical:
// its sums start at +0.0, a float sum is -0.0 only when both terms are, so
// a cell's running sum is never -0.0, and x + (+-0.0) is x, bit for bit,
// for every other x, NaN and inf included. So the hash and add of a group's
// element k run only where some lane of the warp holds a kept nonzero
// estimate at k (a warp vote); a masked position otherwise costs a load, a
// mask test and (row 0) a store. At the headline's 50,000 kept of 7 M
// that took 0.0507 ms against 0.0556 with one vote a group (PERF.md).
//
// Bound: the sign hashes, or the bytes, whichever is larger. The accumulate
// needs one fmix32 per (row, coordinate), r*Tn*c_pad of them, about 12
// instructions each with its index, its use and the add. At least 6 of
// them (the right shifts and the xors) run only on the ALU pipe, 64 lanes
// per SM, and the SM issues 128 lanes a clock in all; so at the headline
// geometry 35 M hashes take at least 0.0126 ms on an H100 (16.7 T ALU
// op/s), against 0.011 ms (zero table) and 0.014 ms (incoming table) to
// move the plane and the tables once (chip_smoke.py::HASH_ALU_OPS). The
// epilogue needs a mask test per coordinate and a hash per kept nonzero
// value and row; the bytes bound it: the estimates read once, the update
// and the table written once, 0.0197 ms at the headline.
// Design: output-stationary. A block owns kAccTile consecutive cells of
// one row, a thread kAccCells consecutive ones. For chunk t the thread's
// sources are kAccCells consecutive positions p0 .. p0 + 3, p0 = (c - m)
// mod c_pad, so one wrap test, one range test and one index per kAccCells
// elements cover the common case, and its loads are in flight together
// while it hashes; a warp reads (and row 0 of the epilogue writes) one
// contiguous 512-byte window. Only the groups that wrap at c_pad or cross
// the ends of v take the per-element path. The row's shifts go through
// shared memory once per block, kShiftTile at a time; the index arithmetic
// is uint32 (the sign hash reads the low 32 bits of the coordinate, as the
// int64 product's cast did), and the sign flips the value's sign bit
// (signed_by) rather than multiplying it. On an H100, in an earlier form of
// this design (cells kAccThreads apart, a wrap and range test per element),
// the hashes alone took 0.041-0.045 ms and the loads alone 0.032-0.038 ms
// of the whole's 0.044-0.048 ms at the headline geometry (PERF.md): the
// int32 work sets the time, which is why the index work is shared by
// kAccCells elements. There are no atomics, and each cell's adds come in
// chunk order, which is the JAX scan's fold, so the table is bit-identical
// to the plain version. Each chunk element is read once per row (r times
// in all); the rows of one range are launched together (blockIdx.y = row)
// so the rereads mostly hit the 50 MB L2 (5 rows took 1.9x one row's time
// in the old design). The rows run from the last to row 0 (blockIdx.y = 0
// is row r - 1): the epilogue's row-0 blocks, which also write the 28 MB
// update, come last, after the other rows have read the estimates into L2
// without the update's writes evicting them; that took 0.0511-0.0513 ms
// against 0.0568-0.0574 with row 0 first, and streaming stores
// (__stcs) for the update 0.061-0.062 (PERF.md).
// table_in and table_out may be the same buffer: each thread reads its own
// cells once, before its one write of each, and touches no other cell
// (hence no __restrict__ on the two).
// ---------------------------------------------------------------------------
constexpr int kAccThreads = 256;
constexpr int kAccCells = 4;
constexpr int kAccTile = kAccThreads * kAccCells;
constexpr int kShiftTile = 256;

// Adds a group of kAccCells values to a thread's cells: cell k's value is
// v[l[k]] (0.0f where !in[k]) and its coordinate idx[k]. All the loads are
// issued before any other work. The epilogue masks the values at thr,
// stores them as the update in row 0 (store), and skips the hash and add
// of element k where no lane of the warp holds a kept nonzero value there:
// from a zero table a zero adds no bit (see above).
template <bool kEpilogue>
__device__ __forceinline__ void add_group(
    float (&acc)[kAccCells], const float* __restrict__ v,
    const int (&l)[kAccCells], const bool (&in)[kAccCells],
    const uint32_t (&idx)[kAccCells], uint32_t key, int32_t thr, bool store,
    float* __restrict__ update) {
  float x[kAccCells];
#pragma unroll
  for (int k = 0; k < kAccCells; ++k) x[k] = in[k] ? __ldg(v + l[k]) : 0.0f;
  if constexpr (kEpilogue) {
    bool hash[kAccCells];
#pragma unroll
    for (int k = 0; k < kAccCells; ++k) {
      const int32_t a = __float_as_int(x[k]) & kAbsMask;
      const bool keep = a > kInfBits || a >= thr;  // NaN passes through
      if (!keep) x[k] = 0.0f;
      if (store && in[k]) update[l[k]] = x[k];
      hash[k] = keep && a != 0;
    }
    const unsigned lanes = __activemask();
#pragma unroll
    for (int k = 0; k < kAccCells; ++k)
      if (__any_sync(lanes, hash[k])) acc[k] += signed_by(x[k], idx[k], key);
    return;
  }
#pragma unroll
  for (int k = 0; k < kAccCells; ++k) acc[k] += signed_by(x[k], idx[k], key);
}

// The loop body: this thread's cells c .. c + 3 of row j = blockIdx.y, from
// table_in (kFromTable) or from zero; the epilogue (kEpilogue) masks every
// value at *thr_bits and writes the update from row 0.
template <bool kFromTable, bool kEpilogue>
__device__ __forceinline__ void accumulate_cells(
    const float* __restrict__ v, int lpad, int n,
    const int32_t* __restrict__ shift_q, const int32_t* __restrict__ shift_w,
    const int32_t* __restrict__ keys, const float* table_in,
    float* table_out, int Tn, int c_pad, int t0,
    const int32_t* __restrict__ thr_bits, float* __restrict__ update) {
  __shared__ int s_m[kShiftTile];
  const int j = gridDim.y - 1 - blockIdx.y;  // row 0 last
  // c_pad is a multiple of 128, so the 4 cells are all in the row or all
  // past it
  const int c = blockIdx.x * kAccTile + threadIdx.x * kAccCells;
  const bool active = c < c_pad;
  const int64_t row = static_cast<int64_t>(j) * c_pad;
  const uint32_t key = static_cast<uint32_t>(keys[j]);
  int32_t thr = 0;
  if constexpr (kEpilogue) thr = *thr_bits;
  const bool store = kEpilogue && j == 0;
  float acc[kAccCells];
#pragma unroll
  for (int k = 0; k < kAccCells; ++k) {
    acc[k] = 0.0f;
    if constexpr (kFromTable) {
      if (active) acc[k] = table_in[row + c + k];
    }
  }
  for (int tb = 0; tb < Tn; tb += kShiftTile) {
    const int tn = min(kShiftTile, Tn - tb);
    __syncthreads();
    for (int t = threadIdx.x; t < tn; t += kAccThreads)
      s_m[t] = shift_q[j * Tn + tb + t] * 128 + shift_w[j * Tn + tb + t];
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int tt = 0; tt < tn; ++tt) {
      const int t = tb + tt;
      const int base = t * c_pad - lpad;  // v index of chunk t's position 0
      const uint32_t idx0 = static_cast<uint32_t>(t0 + t) *
                            static_cast<uint32_t>(c_pad);
      int p0 = c - s_m[tt];
      if (p0 < 0) p0 += c_pad;
      const int l0 = base + p0;
      int l[kAccCells];
      bool in[kAccCells];
      uint32_t idx[kAccCells];
      if (p0 + kAccCells <= c_pad && l0 >= 0 && l0 + kAccCells <= n) {
        // the common case: the 4 positions neither wrap nor leave v (a
        // call of its own, so the compiler sees in[] all true)
#pragma unroll
        for (int k = 0; k < kAccCells; ++k) {
          l[k] = l0 + k;
          in[k] = true;
          idx[k] = idx0 + static_cast<uint32_t>(p0 + k);
        }
        add_group<kEpilogue>(acc, v, l, in, idx, key, thr, store, update);
      } else {
#pragma unroll
        for (int k = 0; k < kAccCells; ++k) {
          int p = p0 + k;
          if (p >= c_pad) p -= c_pad;
          l[k] = base + p;
          in[k] = static_cast<unsigned>(l[k]) < static_cast<unsigned>(n);
          idx[k] = idx0 + static_cast<uint32_t>(p);
        }
        add_group<kEpilogue>(acc, v, l, in, idx, key, thr, store, update);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kAccCells; ++k) table_out[row + c + k] = acc[k];
  }
}

template <bool kFromTable>
__global__ void __launch_bounds__(kAccThreads)
    sketch_accumulate_kernel(const float* __restrict__ v, int lpad, int n,
                             const int32_t* __restrict__ shift_q,
                             const int32_t* __restrict__ shift_w,
                             const int32_t* __restrict__ keys,
                             const float* table_in, float* table_out, int Tn,
                             int c_pad, int t0) {
  accumulate_cells<kFromTable, false>(v, lpad, n, shift_q, shift_w, keys,
                                      table_in, table_out, Tn, c_pad, t0,
                                      nullptr, nullptr);
}

__global__ void __launch_bounds__(kAccThreads)
    fused_epilogue_kernel(const float* __restrict__ est,
                          const int32_t* __restrict__ thr_bits,
                          const int32_t* __restrict__ shift_q,
                          const int32_t* __restrict__ shift_w,
                          const int32_t* __restrict__ keys,
                          float* __restrict__ update,
                          float* __restrict__ table, int Tn, int c_pad,
                          int t0) {
  accumulate_cells<false, true>(est, 0, Tn * c_pad, shift_q, shift_w, keys,
                                nullptr, table, Tn, c_pad, t0, thr_bits,
                                update);
}

int launch_accumulate(bool from_table, const float* table_in, const float* v,
                      int lpad, int n, const int32_t* shift_q,
                      const int32_t* shift_w, const int32_t* keys,
                      float* table_out, int r, int Tn, int c_pad, int t0,
                      cudaStream_t stream) {
  // every v index t*c_pad + p - lpad must fit an int
  if (r <= 0 || c_pad <= 0 || Tn < 0 || lpad < 0 || lpad >= c_pad || n < 0 ||
      static_cast<int64_t>(Tn) * c_pad >= (int64_t{1} << 31) ||
      lpad + static_cast<int64_t>(n) > static_cast<int64_t>(Tn) * c_pad)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c_pad + kAccTile - 1) / kAccTile, r);
  if (from_table) {
    sketch_accumulate_kernel<true><<<grid, kAccThreads, 0, stream>>>(
        v, lpad, n, shift_q, shift_w, keys, table_in, table_out, Tn, c_pad,
        t0);
  } else {
    sketch_accumulate_kernel<false><<<grid, kAccThreads, 0, stream>>>(
        v, lpad, n, shift_q, shift_w, keys, nullptr, table_out, Tn, c_pad,
        t0);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// sketch_estimates
//
// Replaces commefficient_tpu/ops/sketch.py::_estimates_pallas, and the
// tail mask that commefficient_tpu/ops/sketch.py::estimates_chunks (and
// estimates_chunks_local, by global coordinate) applies after it:
//   est[t, p] = median_j( sign_j(i) * row_j[(p + m[j,t]) mod c_pad] ),
//   i = (t0+t)*c_pad + p, for i < n_valid; +0.0f for i >= n_valid,
// the median being _median_small's (even R averages the middle two). With
// n_valid = (t0+Tn)*c_pad nothing is masked; the round passes d, so the
// padded tail comes out as the +0.0 that torch.where(keep, est, 0) writes,
// and no mask pass follows the launch.
//
// Bound: the bytes (the table read once, the estimates written once: 38 MB,
// 0.0113 ms at the headline geometry), ahead of the ALU-pipe ops
// (chip_smoke.py::QUERY_ALU_OPS_*: the hash's first xor-shift once per
// coordinate, 3 ops per row and coordinate with the shifts left to the FMA
// pipe, the median's min and max).
// Each table cell is read Tn times, once per chunk, from the 50 MB L2.
//
// Design. The first form gave a thread one cell: it reloaded the row shifts
// from global memory, formed a 64-bit coordinate, tested the wrap and took
// the whole hash per (row, cell), multiplied by the sign, and sorted by the
// full bubble network with a NaN test on every comparator (0.066 ms at the
// headline geometry, flushed). Here:
//  - a block is one chunk t and kQryTile positions; the R shifts of chunk t
//    and the keys' fold16 halves go through shared memory once a block;
//  - a warp owns kQrySpan consecutive positions, a lane kQryCells cells 32
//    apart: each gather and store instruction of the warp is 32
//    consecutive floats, one wrap test a row covers the lane's cells, and
//    all kQryCells * R gathers are issued before any arithmetic;
//  - the sign takes 6 instructions a row and cell, 4 of them on the ALU
//    pipe, in place of fmix32's 9 and 6 after a shared fold16
//    (sketch_common.cuh::sign_word: the coordinate's fold16 shared by the
//    rows, the sign bit out of one multiply, one LOP3 to flip the value);
//  - the median is min/max with NaN propagation in the instruction
//    (min.NaN / max.NaN, FMNMX.NAN: a NaN operand gives the canonical NaN,
//    like torch.minimum and jnp.minimum), so no NaN test is needed: with
//    NaN-propagating min and max, any network in which every input reaches
//    the output returns NaN when some input is NaN, as the bubble network
//    does. R = 5 takes 10 of them (median3 of e and the middle two of the
//    pairs' minima and maxima), R = 3 four, other R the bubble network.
//    Among equal values a different one may be picked than the bubble
//    network picks: where +0.0 and -0.0 tie at the median the sign of the
//    zero may differ. Every nonzero value and every NaN position is the
//    plain version's, and the top-k, the re-sketch, the masks and the
//    byte accounting read no zero's sign. The weights can: when fewer
//    than k estimates are nonzero the top-k threshold is 0, every
//    estimate is kept, and ps - lr * update turns a weight of -0.0 into
//    +0.0 where the update's zero is -0.0 (-0.0 - -0.0 = +0.0) and keeps
//    it where it is +0.0. So at that threshold the new weights equal the
//    plain version's under == and may differ in the sign bit of zero
//    weights (tests/test_torch_kernels.py::test_zero_sign_at_p_zero);
//  - a cell at or past n_valid is written as +0.0f, and a thread whose
//    cells all are skips its gathers.
// On an H100 the arithmetic sets the time. At 4 cells a thread and 256
// threads, the hashes and medians alone (no loads, no stores) took 0.0297
// of the whole 0.0324 ms, the loads alone 0.026 (r = 5, Tn = 14). 8
// cells a thread (half the wrap tests and address work a cell) at 128
// threads took 0.031, and the tail select moved after the medians (a
// select in each cell's median had put every cell's arithmetic behind a
// branch of its own, which cost the scheduler its overlap of cells)
// 0.0297 masked (PERF.md). The estimates are stored with plain stores:
// the next kernel (the count pass or the descent) reads them from L2.
// Never with --use_fast_math: FMNMX keeps subnormals and orders the
// infinities without it.
// ---------------------------------------------------------------------------
constexpr int kQryThreads = 128;
constexpr int kQryCells = 8;
// A warp owns kQrySpan consecutive positions, lane l the cells l, l + 32,
// ..., l + 224, so each gather and store instruction of a warp is 32
// consecutive floats.
constexpr int kQrySpan = 32 * kQryCells;
constexpr int kQryTile = kQryThreads * kQryCells;

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float median3(float x, float y, float z) {
  return max_nan(min_nan(x, y), min_nan(max_nan(x, y), z));
}

template <int R>
__device__ __forceinline__ float median_of(float (&v)[R]) {
  if constexpr (R == 5) {
    return median3(v[4], max_nan(min_nan(v[0], v[1]), min_nan(v[2], v[3])),
                   min_nan(max_nan(v[0], v[1]), max_nan(v[2], v[3])));
  } else if constexpr (R == 3) {
    return median3(v[0], v[1], v[2]);
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R - 1 - i; ++j) {
        const float a = v[j], b = v[j + 1];
        v[j] = min_nan(a, b);
        v[j + 1] = max_nan(a, b);
      }
    }
    if constexpr (R % 2) return v[R / 2];
    return 0.5f * (v[R / 2 - 1] + v[R / 2]);
  }
}

template <int R>
__global__ void __launch_bounds__(kQryThreads)
    sketch_estimates_kernel(const float* __restrict__ table,
                            const int32_t* __restrict__ shift_q,
                            const int32_t* __restrict__ shift_w,
                            const int32_t* __restrict__ keys,
                            float* __restrict__ est, int Tn, int c_pad,
                            int t0, int64_t n_valid) {
  __shared__ int s_m[R];
  __shared__ uint32_t s_key[R];
  const int t = blockIdx.y;
  if (threadIdx.x < R) {
    const int j = threadIdx.x;
    s_m[j] = shift_q[j * Tn + t] * 128 + shift_w[j * Tn + t];
    s_key[j] = fold16(static_cast<uint32_t>(keys[j]));
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int span0 = blockIdx.x * kQryTile + (threadIdx.x / 32) * kQrySpan;
  if (span0 >= c_pad) return;
  // c_pad is a multiple of 128, so the warp's span holds 4 or 8 whole
  // columns of cells in the chunk: cell k exists iff k < cells
  const int cells = min(kQryCells, (c_pad - span0) / 32);
  const int p0 = span0 + lane;
  float* out = est + static_cast<int64_t>(t) * c_pad + p0;
  // cell k is below n_valid iff 32 k < room
  const int64_t room =
      n_valid - (static_cast<int64_t>(t0 + t) * c_pad + p0);
  float med[kQryCells];
  if (room <= 0) {
#pragma unroll
    for (int k = 0; k < kQryCells; ++k) med[k] = 0.0f;
  } else {
    float v[kQryCells][R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      int c = p0 + s_m[j];
      if (c >= c_pad) c -= c_pad;
      const float* row = table + static_cast<int64_t>(j) * c_pad;
      if (c + kQrySpan - 32 < c_pad) {  // the common case: no wrap
#pragma unroll
        for (int k = 0; k < kQryCells; ++k) v[k][j] = __ldg(row + c + 32 * k);
      } else {
#pragma unroll
        for (int k = 0; k < kQryCells; ++k) {
          int ck = c + 32 * k;
          if (ck >= c_pad) ck -= c_pad;
          v[k][j] = k < cells ? __ldg(row + ck) : 0.0f;
        }
      }
    }
    // the sign hash reads the low 32 bits of the coordinate
    const uint32_t idx0 = static_cast<uint32_t>(t0 + t) *
                              static_cast<uint32_t>(c_pad) +
                          static_cast<uint32_t>(p0);
#pragma unroll
    for (int k = 0; k < kQryCells; ++k) {
      const uint32_t h = fold16(idx0 + 32 * k);
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[k][j] = signed_by_word(v[k][j], sign_word(h ^ s_key[j]));
      med[k] = median_of<R>(v[k]);
    }
    // the cells at or past n_valid (in the one warp that straddles it);
    // selected after the medians, so that no cell's arithmetic sits behind
    // a branch of its own
#pragma unroll
    for (int k = 0; k < kQryCells; ++k)
      if (32 * k >= room) med[k] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < kQryCells; ++k)
    if (k < cells) out[32 * k] = med[k];
}

// ---------------------------------------------------------------------------
// topk_count_ge
//
// Replaces commefficient_tpu/ops/topk.py::_count_ge_pallas.
//   counts[j] = #{i : mag(bits_i) >= ts[j]},  j < 16,
//   mag = bits & 0x7FFFFFFF, NaN patterns (> 0x7F800000) counted as 0,
// for any 16 int32 thresholds: unsorted, repeated and negative ones too
// (the descent's are p + (j << shift), but the sharded server counts
// others).
// Bound: device-memory bytes, each pattern read once (28 MB, 0.0084 ms at
// the headline's 7,001,344 patterns).
// Design. The first form (one dependent 4-byte load a thread per
// iteration, 64-bit indices, no unrolling, a memset launch before every
// launch, and 16 compare-adds a pattern, which the compiler made 48
// instructions) took 0.035 ms flushed, 4.2x the bound (PERF.md). This
// form:
//  - reads 16-byte vectors, kCountUnroll of them a thread per iteration,
//    over a persistent grid of as many blocks as fit on the card at once,
//    with 32-bit indices; block 0's first threads take the at most 3
//    patterns before the first 16-byte boundary and the at most 3 after
//    the last whole vector, so a view at any 4-byte offset is read whole;
//  - counts by bucket: each block sorts the 16 thresholds once (stable
//    ranks) into shared memory, padded with 16 sentinels no magnitude
//    reaches; a pattern's bucket b = #{i : sorted[i] <= mag} takes a
//    5-step binary search (the first pivot in a register, 4 shared loads)
//    and one shared atomic increment of the thread's own histogram column.
//    The columns keep the lanes apart: in the descent's first passes
//    nearly every pattern falls into one bucket, which on one shared
//    counter would be a 32-way conflict. Count j is then the sum of the
//    buckets above threshold j's rank. On an H100 this took 0.0196-0.0199
//    ms against 0.0225-0.0227 for 16 compare-adds in registers and
//    0.0166 for the loads alone (PERF.md);
//  - needs no memset launch: each block adds its 16 counts into the
//    wrapper's scratch totals (one atomicAdd each), and the last block to
//    finish (a __threadfence and an atomic ticket) moves the totals into
//    counts with atomicExch, which leaves them zero, and resets the
//    ticket, so counts is written once and the scratch is zero again for
//    the next launch on the stream. This set-up and publication cost
//    about 0.0096 ms on their own, half of the whole.
// Integer sums are exact in any order, so the counts are the plain
// version's.
// ---------------------------------------------------------------------------
constexpr int kCountThreads = 256;
constexpr int kCountUnroll = 4;
constexpr int kBuckets = kCandidates + 1;
constexpr int32_t kNoMagnitude = 0x7FFFFFFF;  // above every magnitude

// Adds one pattern to this thread's histogram column. The search keeps an
// index: the same search as a pointer walked down s_sorted compiled (CUDA
// 12.8) to one 8-byte load that tested the wrong element (PERF.md).
__device__ __forceinline__ void count_pattern(int32_t bits, int32_t pivot,
                                              const int32_t* s_sorted,
                                              int32_t* column) {
  const int32_t m = magnitude(bits);
  int b = pivot <= m ? 16 : 0;
#pragma unroll
  for (int step = 8; step > 0; step >>= 1)
    if (s_sorted[b + step - 1] <= m) b += step;
  atomicAdd(column + b * kCountThreads, 1);
}

__device__ __forceinline__ void count_vec(const int4& x, int32_t pivot,
                                          const int32_t* s_sorted,
                                          int32_t* column) {
  count_pattern(x.x, pivot, s_sorted, column);
  count_pattern(x.y, pivot, s_sorted, column);
  count_pattern(x.z, pivot, s_sorted, column);
  count_pattern(x.w, pivot, s_sorted, column);
}

// scratch: kCandidates running totals, then the ticket; all zero between
// launches.
__global__ void __launch_bounds__(kCountThreads)
    topk_count_ge_kernel(const int32_t* __restrict__ bits, int n,
                         const int32_t* __restrict__ ts,
                         int32_t* __restrict__ counts, int32_t* scratch) {
  __shared__ int32_t s_sorted[2 * kCandidates];
  __shared__ int32_t s_rank[kCandidates];
  __shared__ int32_t s_hist[kBuckets * kCountThreads];  // [bucket][thread]
  __shared__ int32_t s_total[kBuckets];
  __shared__ bool s_last;
  const int t = threadIdx.x;
  if (t < kCandidates) {
    const int32_t x = __ldg(ts + t);
    int rank = 0;  // ties keep the caller's order
#pragma unroll
    for (int i = 0; i < kCandidates; ++i) {
      const int32_t y = __ldg(ts + i);
      rank += (y < x || (y == x && i < t)) ? 1 : 0;
    }
    s_sorted[rank] = x;
    s_rank[t] = rank;
  } else if (t < 2 * kCandidates) {
    s_sorted[t] = kNoMagnitude;
  }
#pragma unroll
  for (int b = 0; b < kBuckets; ++b) s_hist[b * kCountThreads + t] = 0;
  __syncthreads();
  const int32_t pivot = s_sorted[15];
  int32_t* column = s_hist + t;

  // patterns before the first 16-byte boundary, whole vectors, the rest
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(bits) & 15)) & 15) / 4);
  if (head > n) head = n;
  const int4* vec = reinterpret_cast<const int4*>(bits + head);
  const uint32_t nvec = static_cast<uint32_t>(n - head) / 4;
  const uint32_t stride = gridDim.x * kCountThreads;
  uint32_t i = blockIdx.x * kCountThreads + t;
  for (; i + (kCountUnroll - 1) * stride < nvec; i += kCountUnroll * stride) {
    int4 x[kCountUnroll];
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u) x[u] = __ldg(vec + i + u * stride);
#pragma unroll
    for (int u = 0; u < kCountUnroll; ++u)
      count_vec(x[u], pivot, s_sorted, column);
  }
  for (; i < nvec; i += stride)
    count_vec(__ldg(vec + i), pivot, s_sorted, column);
  if (blockIdx.x == 0 && t < 8) {
    const int k = t < head ? t : head + 4 * static_cast<int>(nvec) + t - head;
    if (t < head || k < n) count_pattern(bits[k], pivot, s_sorted, column);
  }
  __syncthreads();

  // the block's bucket totals, a warp a bucket at a time
  const int lane = t & 31;
  for (int b = t >> 5; b < kBuckets; b += kCountThreads / 32) {
    int32_t x = 0;
#pragma unroll
    for (int k = lane; k < kCountThreads; k += 32)
      x += s_hist[b * kCountThreads + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_total[b] = x;
  }
  __syncthreads();
  if (t < kCandidates) {
    int32_t total = 0;  // the patterns in the buckets above t's rank
    for (int b = s_rank[t] + 1; b < kBuckets; ++b) total += s_total[b];
    if (total) atomicAdd(&scratch[t], total);
  }
  __threadfence();  // this block's totals before its ticket
  __syncthreads();
  if (t == 0)
    s_last = atomicAdd(&scratch[kCandidates], 1) ==
             static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (s_last && t < kCandidates) {
    counts[t] = atomicExch(&scratch[t], 0);
    if (t == 0) atomicExch(&scratch[kCandidates], 0);
  }
}

template <int R>
void launch_estimates(const float* table, const int32_t* q, const int32_t* w,
                      const int32_t* keys, float* est, int Tn, int c_pad,
                      int t0, int64_t n_valid, cudaStream_t stream) {
  const dim3 grid((c_pad + kQryTile - 1) / kQryTile, Tn);
  sketch_estimates_kernel<R><<<grid, kQryThreads, 0, stream>>>(
      table, q, w, keys, est, Tn, c_pad, t0, n_valid);
}

}  // namespace

extern "C" {

// table = the sketch of the (Tn, S, 128) plane v3.
int sketch_accumulate(const float* v3, const int32_t* shift_q,
                      const int32_t* shift_w, const int32_t* keys,
                      float* table, int r, int Tn, int c_pad, int t0,
                      cudaStream_t stream) {
  if (Tn < 0 || static_cast<int64_t>(Tn) * c_pad >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_accumulate(false, nullptr, v3, 0, Tn * c_pad, shift_q,
                           shift_w, keys, table, r, Tn, c_pad, t0, stream);
}

// table_out = table_in + the sketch of the n coordinates of v, which start
// at position lpad of chunk t0 (a full range: lpad = 0, n = Tn * c_pad);
// table_out may be table_in.
int sketch_accumulate_into(const float* table_in, const float* v, int lpad,
                           int n, const int32_t* shift_q,
                           const int32_t* shift_w, const int32_t* keys,
                           float* table_out, int r, int Tn, int c_pad, int t0,
                           cudaStream_t stream) {
  return launch_accumulate(true, table_in, v, lpad, n, shift_q, shift_w, keys,
                           table_out, r, Tn, c_pad, t0, stream);
}

// update = est masked at the threshold pattern *p_bits (tie-inclusive,
// NaN passes through), table = the sketch of update.
int fused_epilogue(const float* est, const int32_t* p_bits,
                   const int32_t* shift_q, const int32_t* shift_w,
                   const int32_t* keys, float* update, float* table, int r,
                   int Tn, int c_pad, int t0, cudaStream_t stream) {
  if (r <= 0 || c_pad <= 0 || Tn < 0 ||
      static_cast<int64_t>(Tn) * c_pad >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c_pad + kAccTile - 1) / kAccTile, r);
  fused_epilogue_kernel<<<grid, kAccThreads, 0, stream>>>(
      est, p_bits, shift_q, shift_w, keys, update, table, Tn, c_pad, t0);
  return static_cast<int>(cudaGetLastError());
}

// Largest row count the query is instantiated for.
int sketch_estimates_max_rows() { return 8; }

// est = the median-of-rows estimates of the Tn chunks from chunk t0, +0.0
// at every global coordinate >= n_valid.
int sketch_estimates(const float* table, const int32_t* shift_q,
                     const int32_t* shift_w, const int32_t* keys, float* est,
                     int r, int Tn, int c_pad, int t0, int64_t n_valid,
                     cudaStream_t stream) {
  if (Tn <= 0 || Tn > 65535 || c_pad <= 0 || c_pad % 128 ||
      c_pad >= (1 << 30) || t0 < 0 || n_valid < 0 ||
      static_cast<int64_t>(r) * c_pad >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (r) {
    case 1: launch_estimates<1>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    case 2: launch_estimates<2>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    case 3: launch_estimates<3>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    case 4: launch_estimates<4>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    case 5: launch_estimates<5>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    case 6: launch_estimates<6>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    case 7: launch_estimates<7>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    case 8: launch_estimates<8>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, n_valid, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// scratch: kCandidates + 1 int32, zero before the first launch on a
// stream; the kernel leaves it zero.
int topk_count_ge(const int32_t* bits, int64_t n, const int32_t* ts,
                  int32_t* counts, int32_t* scratch, int num_sms,
                  cudaStream_t stream) {
  if (n < 0 || n >= (int64_t{1} << 31) || num_sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int per_sm = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, topk_count_ge_kernel,
                                                  kCountThreads, 0);
    return b;
  }();
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int64_t per_block = int64_t{kCountThreads} * kCountUnroll * 4;
  int64_t blocks = (n + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(per_sm) * num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // n = 0 still writes counts
  topk_count_ge_kernel<<<static_cast<int>(blocks), kCountThreads, 0,
                         stream>>>(bits, static_cast<int>(n), ts, counts,
                                   scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
