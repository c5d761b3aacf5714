// Hand-written Hopper (sm_90a) kernels of the sketched FetchSGD round: the
// accumulate (from a zero table or from an incoming one), the median query
// and the top-k count pass. The fused server epilogue and the one-launch
// top-k descent live in fused_epilogue.cu and topk_descent.cu.
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
// sketch_accumulate (kFromTable = false) and sketch_accumulate_into
// (kFromTable = true): one loop body, so the two cannot drift bit-wise.
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
//
// The chunk range [t0, t0 + Tn) is read from a flat vector v in place:
// x[t, p] = v[t*c_pad + p - lpad] where 0 <= t*c_pad + p - lpad < n, else
// 0.0f. A full-range launch is lpad = 0, n = Tn*c_pad (v is the (Tn, S,
// 128) plane). A streamed group passes its concatenated leaves, its first
// coordinate's offset lpad in chunk t0 and its length n, so no zero-padded
// copy of the covering chunks is made. Positions outside the group still
// add sign * 0.0f, as the padded plain version does: skipping them would
// change the sign of an all-zero cell.
//
// Bound: the sign hashes, or the bytes, whichever is larger. The function
// needs one fmix32 per (row, coordinate), r*Tn*c_pad of them, about 12
// instructions each with its index, its use and the add. At least 6 of
// them (the right shifts and the xors) run only on the ALU pipe, 64 lanes
// per SM, and the SM issues 128 lanes a clock in all; so at the headline
// geometry 35 M hashes take at least 0.0126 ms on an H100 (16.7 T ALU
// op/s), against 0.011 ms (zero table) and 0.014 ms (incoming table) to
// move the plane and the tables once (chip_smoke.py::HASH_ALU_OPS).
// Design: output-stationary. A block owns kAccTile consecutive cells of
// one row, a thread kAccCells consecutive ones. For chunk t the thread's
// sources are kAccCells consecutive positions p0 .. p0 + 3, p0 = (c - m)
// mod c_pad, so one wrap test, one range test and one index per kAccCells
// elements cover the common case, and its loads are in flight together
// while it hashes; a warp reads one contiguous 512-byte window. Only the
// groups that wrap at c_pad or cross the ends of v take the per-element
// path. The row's shifts go through shared memory once per block,
// kShiftTile at a time; the index arithmetic is uint32 (the sign hash
// reads the low 32 bits of the coordinate, as the int64 product's cast
// did), and the sign flips the value's sign bit (signed_by) rather than
// multiplying it. On an H100, in an earlier form of this design (cells
// kAccThreads apart, a wrap and range test per element), the hashes alone
// took 0.041-0.045 ms and the loads alone 0.032-0.038 ms of the whole's
// 0.044-0.048 ms at the headline geometry (PERF.md): the int32 work
// sets the time, which is why the index work is shared by kAccCells
// elements. There are no atomics, and each cell's adds come in chunk
// order, which is the JAX scan's fold, so the table is bit-identical to
// the plain version. Each chunk element is read once per row (r times in
// all); the rows of one range are launched together (blockIdx.y = row) so
// the rereads mostly hit the 50 MB L2 (5 rows took 1.9x one row's time in
// the old design).
// table_in and table_out may be the same buffer: each thread reads its own
// cells once, before its one write of each, and touches no other cell
// (hence no __restrict__ on the two).
// ---------------------------------------------------------------------------
constexpr int kAccThreads = 256;
constexpr int kAccCells = 4;
constexpr int kAccTile = kAccThreads * kAccCells;
constexpr int kShiftTile = 256;

template <bool kFromTable>
__global__ void __launch_bounds__(kAccThreads)
    sketch_accumulate_kernel(const float* __restrict__ v, int lpad, int n,
                             const int32_t* __restrict__ shift_q,
                             const int32_t* __restrict__ shift_w,
                             const int32_t* __restrict__ keys,
                             const float* table_in, float* table_out, int Tn,
                             int c_pad, int t0) {
  __shared__ int s_m[kShiftTile];
  const int j = blockIdx.y;
  // this thread's cells c .. c + 3; c_pad is a multiple of 128, so they are
  // all in the row or all past it
  const int c = blockIdx.x * kAccTile + threadIdx.x * kAccCells;
  const bool active = c < c_pad;
  const int64_t row = static_cast<int64_t>(j) * c_pad;
  const uint32_t key = static_cast<uint32_t>(keys[j]);
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
      if (p0 + kAccCells <= c_pad && l0 >= 0 && l0 + kAccCells <= n) {
        // the common case: the 4 positions neither wrap nor leave v
        const float* src = v + l0;
        const uint32_t i0 = idx0 + static_cast<uint32_t>(p0);
#pragma unroll
        for (int k = 0; k < kAccCells; ++k)
          acc[k] += signed_by(__ldg(src + k), i0 + k, key);
      } else {
#pragma unroll
        for (int k = 0; k < kAccCells; ++k) {
          int p = p0 + k;
          if (p >= c_pad) p -= c_pad;
          const int l = base + p;
          const float x = static_cast<unsigned>(l) < static_cast<unsigned>(n)
                              ? __ldg(v + l)
                              : 0.0f;
          acc[k] += signed_by(x, idx0 + static_cast<uint32_t>(p), key);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int k = 0; k < kAccCells; ++k) table_out[row + c + k] = acc[k];
  }
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
// Replaces commefficient_tpu/ops/sketch.py::_estimates_pallas.
//   est[t, p] = median_j( sign_j((t0+t)*c_pad + p) * row_j[(p + m[j,t]) mod c_pad] )
// with the bubble min/max network of _median_small (even R averages the
// middle two). Bound: device-memory bytes (the table read once, the
// estimates written once). Design: one thread per output cell gathers its
// R values by modular index; that replaces the TPU's doubled table and DMA
// windows. The table (10 MB at the headline geometry) stays in L2 across
// the Tn chunks. R is a template parameter so the network unrolls in
// registers.
//
// min/max propagate NaN like torch.minimum/maximum and jnp.minimum/maximum
// (CUDA's fminf/fmaxf would drop it): a NaN table cell must reach the top-k's
// NaN passthrough and the train loop's NaN abort.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <int R>
__global__ void sketch_estimates_kernel(const float* __restrict__ table,
                                        const int32_t* __restrict__ shift_q,
                                        const int32_t* __restrict__ shift_w,
                                        const int32_t* __restrict__ keys,
                                        float* __restrict__ est, int Tn,
                                        int c_pad, int t0) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const int t = blockIdx.y;
  if (p >= c_pad) return;
  const uint32_t idx =
      static_cast<uint32_t>(static_cast<int64_t>(t0 + t) * c_pad + p);
  float v[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int m = shift_q[j * Tn + t] * 128 + shift_w[j * Tn + t];
    int c = p + m;
    if (c >= c_pad) c -= c_pad;
    v[j] = table[static_cast<int64_t>(j) * c_pad + c] *
           sign_of(idx, static_cast<uint32_t>(keys[j]));
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R - 1 - i; ++j) {
      const float a = v[j], b = v[j + 1];
      v[j] = nan_min(a, b);
      v[j + 1] = nan_max(a, b);
    }
  }
  float med;
  if constexpr (R % 2) {
    med = v[R / 2];
  } else {
    med = 0.5f * (v[R / 2 - 1] + v[R / 2]);
  }
  est[static_cast<int64_t>(t) * c_pad + p] = med;
}

// ---------------------------------------------------------------------------
// topk_count_ge
//
// Replaces commefficient_tpu/ops/topk.py::_count_ge_pallas.
//   counts[j] = #{i : mag(bits_i) >= ts[j]},  j < 16,
//   mag = bits & 0x7FFFFFFF, NaN patterns (> 0x7F800000) counted as 0.
// Bound: device-memory bytes (each pattern read once). The function needs
// fewer integer operations than those bytes take: a bucket search over the
// 16 sorted thresholds (sign mask, 4 compare-and-select steps, one
// shared-memory increment) is 10 int32 ops per element; this kernel does
// 16 compares and 16 adds. Design: a grid-stride loop over the patterns (no padding to
// whole blocks), 16 counters per thread in registers, a warp then block
// reduction, and one atomicAdd per block per candidate into the zeroed
// output. Integer counts are exact in any order.
// ---------------------------------------------------------------------------
constexpr int kCountThreads = 256;

__global__ void __launch_bounds__(kCountThreads)
    topk_count_ge_kernel(const int32_t* __restrict__ bits, int64_t n,
                         const int32_t* __restrict__ ts,
                         int32_t* __restrict__ counts) {
  int32_t th[kCandidates];
  int32_t cnt[kCandidates];
#pragma unroll
  for (int j = 0; j < kCandidates; ++j) {
    th[j] = ts[j];
    cnt[j] = 0;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t m = magnitude(bits[i]);
#pragma unroll
    for (int j = 0; j < kCandidates; ++j) cnt[j] += (m >= th[j]) ? 1 : 0;
  }
  block_add_counts<kCountThreads>(cnt, counts);
}

template <int R>
void launch_estimates(const float* table, const int32_t* q, const int32_t* w,
                      const int32_t* keys, float* est, int Tn, int c_pad,
                      int t0, cudaStream_t stream) {
  const dim3 grid((c_pad + 255) / 256, Tn);
  sketch_estimates_kernel<R>
      <<<grid, 256, 0, stream>>>(table, q, w, keys, est, Tn, c_pad, t0);
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

// Largest row count the query is instantiated for.
int sketch_estimates_max_rows() { return 8; }

int sketch_estimates(const float* table, const int32_t* shift_q,
                     const int32_t* shift_w, const int32_t* keys, float* est,
                     int r, int Tn, int c_pad, int t0, cudaStream_t stream) {
  if (Tn <= 0 || c_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (r) {
    case 1: launch_estimates<1>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    case 2: launch_estimates<2>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    case 3: launch_estimates<3>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    case 4: launch_estimates<4>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    case 5: launch_estimates<5>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    case 6: launch_estimates<6>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    case 7: launch_estimates<7>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    case 8: launch_estimates<8>(table, shift_q, shift_w, keys, est, Tn, c_pad, t0, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int topk_count_ge(const int32_t* bits, int64_t n, const int32_t* ts,
                  int32_t* counts, int num_sms, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(counts, 0, kCandidates * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int64_t blocks = (n + kCountThreads - 1) / kCountThreads;
  const int64_t cap = static_cast<int64_t>(num_sms > 0 ? num_sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  topk_count_ge_kernel<<<static_cast<int>(blocks), kCountThreads, 0, stream>>>(
      bits, n, ts, counts);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
