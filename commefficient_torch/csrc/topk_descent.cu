// The whole top-k threshold search in one launch, hand-written for Hopper
// (sm_90a). Built and linked like sketch_kernels.cu (see there); plain
// extern "C" entry point, launched on the caller's stream.
//
// Replaces commefficient_tpu/ops/topk.py::_descent_pallas. Over n int32 bit
// patterns it finds the k-th largest magnitude's pattern p, mag = bits &
// 0x7FFFFFFF with NaN patterns counted as 0: the largest p in [0, 2^31)
// with #{i : mag_i >= p} >= k, or 0 when n < k. That is what the 8-pass
// nibble descent of ops/topk._descent_plain returns on every input.
//
// Algorithm: a histogram radix select over the 31 magnitude bits in 3
// digits, 11 + 10 + 10 bits from the top. Pass s builds the histogram of
// digit s over the patterns whose higher digits equal the prefix chosen so
// far, walks its bins from the top summing counts, picks the bin where the
// running count first reaches the remaining rank k, appends that digit to
// the prefix and takes the count of the bins above it off k. If pass 0's
// total is below k (n < k), p is 0. Counts are exact integers, so p is the
// descent's p.
//
// Bound: device-memory bytes. The function needs each pattern read once
// (28 MB, 0.0084 ms at the headline's 7,001,344 patterns) and about 6
// int32 ops per pattern and pass, less than those bytes take at 16.7 T
// int32 op/s. Passes 1 and 2 reread the patterns, mostly from the 50 MB
// L2, and histogram only the few that match the prefix.
//
// Design. CUDA blocks run in no order, so this is a cooperative launch (at
// most as many blocks as can be resident at once) with cooperative_groups'
// grid-wide sync between the passes. Each block builds its histogram in
// shared memory, one atomicAdd per matching pattern. Magnitudes crowd into
// few bins (pass 0's digit is the exponent and 3 mantissa bits), but a
// warp's 32 patterns still spread over many of them, so grouping the lanes
// by bin first (__match_any_sync, one atomic per distinct bin) cost more
// than the collisions it saved: 0.089-0.099 ms against 0.045 ms on an H100
// (PERF.md). Each block then adds its nonzero bins into that pass's
// global histogram (zeroed by the wrapper's cudaMemsetAsync before the
// launch, so nothing is re-zeroed between passes and no block can race a
// reset). After the sync every block reads the same totals through L2
// (__ldcg) and runs the same block-wide suffix scan, so all blocks pick
// the same digit. Loads are
// 16-byte vectors from the first 16-byte-aligned pattern on (the wrapper
// may be handed a view at any 4-byte offset); the few patterns before it
// and after the last whole vector go through block 0's first threads.
// Block 0 writes p.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>

#include "sketch_common.cuh"

namespace cg = cooperative_groups;

namespace {

// digits of 11, 10 and 10 bits at shifts 20, 10 and 0; their histograms
// lie at offsets 0, 2048 and 3072 of the wrapper's scratch
constexpr int kPasses = 3;
constexpr int kHistTotal = 4096;
constexpr int kMaxBins = 2048;
constexpr int kDescentThreads = 512;
constexpr int kWarps = kDescentThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Counts one pattern into the block histogram: bin = digit of mag at
// `shift`, when mag's bits above `top` equal `prefix`.
__device__ __forceinline__ void count(int32_t bits, int top, int32_t prefix,
                                      int shift, int mask, int32_t* s_hist) {
  const int32_t m = magnitude(bits);
  if ((m >> top) == prefix) atomicAdd(&s_hist[(m >> shift) & mask], 1);
}

__global__ void __launch_bounds__(kDescentThreads)
    topk_descent_kernel(const int32_t* __restrict__ bits, int64_t n,
                        int32_t k, int32_t* hist, int32_t* out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int32_t s_hist[kMaxBins];
  __shared__ int32_t s_warp[kWarps];
  __shared__ int32_t s_pick[2];  // digit, count of the bins above it

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // patterns before the first 16-byte boundary, whole vectors, the rest
  int64_t head = ((16 - (reinterpret_cast<uintptr_t>(bits) & 15)) & 15) / 4;
  if (head > n) head = n;
  const int4* vec = reinterpret_cast<const int4*>(bits + head);
  const int64_t nvec = (n - head) / 4;
  const int64_t tail0 = head + 4 * nvec;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kDescentThreads;

  int32_t prefix = 0;  // the digits chosen so far, in place
  int32_t rank = k;    // the rank still to find among the matching patterns
  for (int s = 0; s < kPasses; ++s) {
    const int shift = 20 - 10 * s;
    const int nbins = s == 0 ? 2048 : 1024;
    const int mask = nbins - 1;
    const int top = s == 0 ? 31 : shift + 10;  // 31 in pass 0: all match
    const int32_t want = prefix >> top;
    for (int b = threadIdx.x; b < nbins; b += kDescentThreads) s_hist[b] = 0;
    __syncthreads();

    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kDescentThreads +
                     threadIdx.x;
         i < nvec; i += stride) {
      const int4 x = __ldg(vec + i);
      count(x.x, top, want, shift, mask, s_hist);
      count(x.y, top, want, shift, mask, s_hist);
      count(x.z, top, want, shift, mask, s_hist);
      count(x.w, top, want, shift, mask, s_hist);
    }
    if (blockIdx.x == 0 && threadIdx.x < 8) {
      // at most 3 head and 3 tail patterns
      const int64_t i = threadIdx.x < head ? threadIdx.x
                                           : tail0 + (threadIdx.x - head);
      if (threadIdx.x < head || i < n)
        count(bits[i], top, want, shift, mask, s_hist);
    }
    __syncthreads();
    int32_t* g_hist = hist + (s == 0 ? 0 : 1024 + 1024 * s);
    for (int b = threadIdx.x; b < nbins; b += kDescentThreads)
      if (s_hist[b]) atomicAdd(&g_hist[b], s_hist[b]);
    grid.sync();

    // the bins from the top: thread t owns bins hi - per*t - [0, per), with
    // hi = nbins - 1; an inclusive scan over the threads gives each its
    // count above and lets the one whose bins cross `rank` pick the digit
    const int per = nbins / kDescentThreads;  // 4 or 2
    int32_t mine[4] = {0, 0, 0, 0};
    int32_t sum = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q < per) {
        mine[q] = __ldcg(&g_hist[nbins - 1 - (per * threadIdx.x + q)]);
        sum += mine[q];
      }
    }
    int32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    if (threadIdx.x == 0) s_pick[0] = -1;
    __syncthreads();
    int32_t above = incl - sum;  // this thread's bins' count above
    for (int w = 0; w < warp; ++w) above += s_warp[w];
    if (above < rank && above + sum >= rank) {
      bool picked = false;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!picked && q < per && above + mine[q] >= rank) {
          s_pick[0] = nbins - 1 - (per * threadIdx.x + q);
          s_pick[1] = above;
          picked = true;
        }
        if (!picked) above += mine[q];
      }
    }
    __syncthreads();
    const int32_t digit = s_pick[0];
    if (digit < 0) {  // pass 0 and fewer than k patterns
      prefix = 0;
      break;
    }
    prefix |= digit << shift;
    rank -= s_pick[1];
    __syncthreads();  // s_pick and s_hist are rewritten by the next pass
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = prefix;
}

}  // namespace

extern "C" {

// hist: kHistTotal (4096) int32 of scratch; out: 1 int32.
int topk_descent(const int32_t* bits, int64_t n, int32_t k, int32_t* hist,
                 int32_t* out, int num_sms, cudaStream_t stream) {
  if (n < 0 || k < 1 || num_sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(hist, 0, kHistTotal * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, topk_descent_kernel, kDescentThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int64_t blocks = (n / 4 + kDescentThreads - 1) / kDescentThreads;
  const int64_t cap = static_cast<int64_t>(per_sm) * num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  void* args[] = {&bits, &n, &k, &hist, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(topk_descent_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(kDescentThreads), args, 0,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
