// The whole top-k threshold descent in one launch, hand-written for Hopper
// (sm_90a). Built and linked like sketch_kernels.cu (see there); plain
// extern "C" entry point, launched on the caller's stream.
//
// Replaces commefficient_tpu/ops/topk.py::_descent_pallas. Over n int32 bit
// patterns it finds the k-th largest magnitude's pattern p by an 8-pass
// radix descent, 4 bits a pass from the top:
//   pass s (shift = 28 - 4 s): counts[j] = #{i : mag_i >= prefix + (j+1) << shift}
//   for j < 15 (j < 7 in pass 0: the top nibble of a finite |float| is at
//   most 7; the other candidates are pinned to 0x7FFFFFFF, which no
//   magnitude reaches), then prefix += #{j : counts[j] >= k} << shift.
// The candidates are those of ops/topk._pass_thresholds and the counts are
// exact integers, so p equals the per-pass descent's (topk_count_ge) on
// every input.
//
// Bound: device-memory bytes (each pattern read once). The function needs
// fewer integer operations than those bytes take: a histogram radix select
// in 3 passes of 11-bit digits does 6 int32 ops per element and pass (sign
// mask, prefix shift and compare, digit shift and mask, one shared-memory
// increment), 18 in all. This kernel's 8 passes of 15 counted candidates
// do 224 per element, so its operations, not its bytes, set its time.
//
// Design. The TPU grid (8 passes x blocks) runs in order and carries the
// prefix and the counts in scalar memory; CUDA blocks run in no order. So
// this is a cooperative launch: at most as many blocks as can be resident
// at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each a
// grid-stride loop with 16 register counters per thread, reduced in the
// warp and the block, then one atomicAdd per block and candidate into that
// pass's own 16 counters. cooperative_groups' grid-wide sync then separates
// the passes: after it every block reads the same 16 totals (through L2,
// where the atomics landed), computes the same selected nibble and extends
// the same prefix in registers. Each pass has its own counters, zeroed by
// the wrapper's cudaMemsetAsync before the launch, so nothing is re-zeroed
// between passes and no block can race a reset. Block 0 writes p.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>

#include "sketch_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPasses = 8;
constexpr int kDescentThreads = 256;

__global__ void __launch_bounds__(kDescentThreads)
    topk_descent_kernel(const int32_t* __restrict__ bits, int64_t n,
                        int32_t k, int32_t* counts, int32_t* out) {
  cg::grid_group grid = cg::this_grid();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int32_t prefix = 0;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 28 - 4 * pass;
    const int live = pass == 0 ? 7 : 15;  // real candidates this pass
    int32_t th[kCandidates];
    int32_t cnt[kCandidates];
#pragma unroll
    for (int j = 0; j < kCandidates; ++j) {
      th[j] = j < live ? prefix + ((j + 1) << shift) : kAbsMask;
      cnt[j] = 0;
    }
    for (int64_t i = first; i < n; i += stride) {
      const int32_t m = magnitude(bits[i]);
#pragma unroll
      for (int j = 0; j < kCandidates; ++j) cnt[j] += (m >= th[j]) ? 1 : 0;
    }
    int32_t* pass_counts = counts + pass * kCandidates;
    block_add_counts<kDescentThreads>(cnt, pass_counts);
    grid.sync();
    int32_t sel = 0;
#pragma unroll
    for (int j = 0; j < kCandidates; ++j)
      sel += (__ldcg(&pass_counts[j]) >= k) ? 1 : 0;
    prefix += sel << shift;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = prefix;
}

}  // namespace

extern "C" {

// counts: kPasses * 16 int32 of scratch; out: 1 int32.
int topk_descent(const int32_t* bits, int64_t n, int32_t k, int32_t* counts,
                 int32_t* out, int num_sms, cudaStream_t stream) {
  if (n < 0 || num_sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(
      counts, 0, kPasses * kCandidates * sizeof(int32_t), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, topk_descent_kernel, kDescentThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int64_t blocks = (n + kDescentThreads - 1) / kDescentThreads;
  const int64_t cap = static_cast<int64_t>(per_sm) * num_sms;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  void* args[] = {&bits, &n, &k, &counts, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(topk_descent_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(kDescentThreads), args, 0,
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
