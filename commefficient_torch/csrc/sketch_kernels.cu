// Hand-written Hopper (sm_90a) kernels of the sketched FetchSGD round.
//
// Built by commefficient_torch/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC
// and loaded with ctypes: every entry point is a plain extern "C" function
// that launches on the caller's stream and returns cudaGetLastError().
// Never build with --use_fast_math: it flushes denormals to zero, and the
// sketch and the top-k must keep denormal values exactly.
//
// Shared conventions (identical to commefficient_tpu/ops/sketch.py):
//   - a chunk plane is (Tn, S, 128) float32, c_pad = S * 128 coordinates per
//     chunk; chunk t starts at global coordinate (t0 + t) * c_pad;
//   - row j shifts chunk t cyclically by m = 128 * q[j, t] + w[j, t];
//   - the sign of coordinate idx in row j is bit 0 of fmix32(idx ^ key_j):
//     1 -> +1, 0 -> -1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float sign_of(uint32_t idx, uint32_t key) {
  return (mix32(idx ^ key) & 1u) ? 1.0f : -1.0f;
}

// ---------------------------------------------------------------------------
// sketch_accumulate
//
// Replaces commefficient_tpu/ops/sketch.py::_sketch_vec_pallas.
//   table[j, c] = sum_t sign_j((t0+t)*c_pad + p) * v3[t, p],
//   p = (c - m[j, t]) mod c_pad, chunks added in t order from 0.
// Bound: device-memory bytes (the chunk plane read once, the table written
// once; about 4 integer ops and one add per element). Design: output-
// stationary, one thread per table cell, a loop over the Tn chunks. There
// are no atomics, and each cell's adds come in chunk order, which is the
// JAX scan's fold, so the table is bit-identical to the plain version.
// Neighbouring threads read neighbouring p (one wrap per row), so the reads
// coalesce. Each chunk element is read once per row (r times in all); the
// rows of one chunk range are launched together (blockIdx.y = row) so the
// plane is reread mostly from the 50 MB L2.
// ---------------------------------------------------------------------------
__global__ void sketch_accumulate_kernel(const float* __restrict__ v3,
                                         const int32_t* __restrict__ shift_q,
                                         const int32_t* __restrict__ shift_w,
                                         const int32_t* __restrict__ keys,
                                         float* __restrict__ table, int Tn,
                                         int c_pad, int t0) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (c >= c_pad) return;
  const uint32_t key = static_cast<uint32_t>(keys[j]);
  float acc = 0.0f;
  for (int t = 0; t < Tn; ++t) {
    const int m = shift_q[j * Tn + t] * 128 + shift_w[j * Tn + t];
    int p = c - m;
    if (p < 0) p += c_pad;
    const uint32_t idx =
        static_cast<uint32_t>(static_cast<int64_t>(t0 + t) * c_pad + p);
    acc += sign_of(idx, key) * v3[static_cast<int64_t>(t) * c_pad + p];
  }
  table[static_cast<int64_t>(j) * c_pad + c] = acc;
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
// Bound: device-memory bytes (each pattern read once; 16 compares per
// element). Design: a grid-stride loop over the patterns (no padding to
// whole blocks), 16 counters per thread in registers, a warp then block
// reduction, and one atomicAdd per block per candidate into the zeroed
// output. Integer counts are exact in any order.
// ---------------------------------------------------------------------------
constexpr int kCandidates = 16;
constexpr int kCountThreads = 256;

__global__ void __launch_bounds__(kCountThreads)
    topk_count_ge_kernel(const int32_t* __restrict__ bits, int64_t n,
                         const int32_t* __restrict__ ts,
                         int32_t* __restrict__ counts) {
  __shared__ int32_t s_part[kCandidates][kCountThreads / 32];
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
    int32_t m = bits[i] & 0x7FFFFFFF;
    if (m > 0x7F800000) m = 0;
#pragma unroll
    for (int j = 0; j < kCandidates; ++j) cnt[j] += (m >= th[j]) ? 1 : 0;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kCandidates; ++j) {
    int32_t x = cnt[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_part[j][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < kCandidates) {
    int32_t total = 0;
#pragma unroll
    for (int w = 0; w < kCountThreads / 32; ++w)
      total += s_part[threadIdx.x][w];
    if (total) atomicAdd(&counts[threadIdx.x], total);
  }
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

int sketch_accumulate(const float* v3, const int32_t* shift_q,
                      const int32_t* shift_w, const int32_t* keys,
                      float* table, int r, int Tn, int c_pad, int t0,
                      cudaStream_t stream) {
  if (r <= 0 || c_pad <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c_pad + 255) / 256, r);
  sketch_accumulate_kernel<<<grid, 256, 0, stream>>>(
      v3, shift_q, shift_w, keys, table, Tn, c_pad, t0);
  return static_cast<int>(cudaGetLastError());
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
