// The fused server epilogue of sketch mode, hand-written for Hopper
// (sm_90a). Built and linked like sketch_kernels.cu (see there); plain
// extern "C" entry point, launched on the caller's stream.
//
// Replaces commefficient_tpu/ops/sketch.py::_fused_epilogue_pallas. Given
// the (Tn, S, 128) median estimates and the top-k threshold p (the k-th
// largest magnitude's int32 bit pattern, from the descent), in one sweep:
//   u[t, p']      = est[t, p'] if mag(est[t, p']) >= p or est is NaN, else 0
//   update[t, p'] = u[t, p']                       (the masked update)
//   table[j, c]   = sum_t sign_j((t0+t)*c_pad + p') * u[t, p'],
//                   p' = (c - m[j, t]) mod c_pad, adds in t order from 0
// which is the composed pair topk_dense_nd(est) + sketch_chunks(update) in
// one launch: the estimates are read once per row and the update plane is
// never read back for the re-sketch.
//
// Bound: device-memory bytes (the estimates read once, the update and the
// table written once; one compare and one multiply-add per element and row).
//
// Design. The TPU kernel keeps an ~11 MB unwrapped accumulator in VMEM
// while chunk blocks stream through; nothing that size stays on an SM.
// This kernel is output-stationary like sketch_accumulate: one thread per
// table cell (row j, cell c) loops over the chunks in order, gathers the
// estimate its cell draws from, masks it on bit patterns exactly like
// ops/topk._apply_threshold (tie-inclusive, NaN passes through) and adds
// sign * u. Masked positions add sign * 0.0, as the composed re-sketch of
// the zeroed update does, so the table is bit-identical to the port's
// composed pair, zero signs included (the TPU kernel adds +0.0 there, so
// against it the table is equal under ==). Row 0's threads also write
// update[t, p']: for a fixed t, c -> p' is a permutation, so every position
// is written exactly once, without atomics. The r rows read each estimate
// (28 MB at the headline geometry) r times, mostly from the 50 MB L2.
// p is read from device memory (the descent's output), so nothing in the
// server phase waits on the host.
// ---------------------------------------------------------------------------

#include "sketch_common.cuh"

namespace {

__global__ void fused_epilogue_kernel(const float* __restrict__ est,
                                      const int32_t* __restrict__ p_bits,
                                      const int32_t* __restrict__ shift_q,
                                      const int32_t* __restrict__ shift_w,
                                      const int32_t* __restrict__ keys,
                                      float* __restrict__ update,
                                      float* __restrict__ table, int Tn,
                                      int c_pad, int t0) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y;
  if (c >= c_pad) return;
  const int32_t thresh = *p_bits;
  const uint32_t key = static_cast<uint32_t>(keys[j]);
  float acc = 0.0f;
  for (int t = 0; t < Tn; ++t) {
    const int m = shift_q[j * Tn + t] * 128 + shift_w[j * Tn + t];
    int p = c - m;
    if (p < 0) p += c_pad;
    const int64_t off = static_cast<int64_t>(t) * c_pad + p;
    const float e = est[off];
    const int32_t raw_abs = __float_as_int(e) & kAbsMask;
    const bool is_nan = raw_abs > kInfBits;
    const float u = (is_nan || raw_abs >= thresh) ? e : 0.0f;
    if (j == 0) update[off] = u;
    const uint32_t idx =
        static_cast<uint32_t>(static_cast<int64_t>(t0 + t) * c_pad + p);
    acc += sign_of(idx, key) * u;
  }
  table[static_cast<int64_t>(j) * c_pad + c] = acc;
}

}  // namespace

extern "C" {

int fused_epilogue(const float* est, const int32_t* p_bits,
                   const int32_t* shift_q, const int32_t* shift_w,
                   const int32_t* keys, float* update, float* table, int r,
                   int Tn, int c_pad, int t0, cudaStream_t stream) {
  if (r <= 0 || c_pad <= 0 || Tn < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c_pad + 255) / 256, r);
  fused_epilogue_kernel<<<grid, 256, 0, stream>>>(
      est, p_bits, shift_q, shift_w, keys, update, table, Tn, c_pad, t0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
