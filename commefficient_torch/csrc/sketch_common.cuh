// Helpers shared by the port's kernel sources (sketch_kernels.cu,
// topk_descent.cu). Each source is its own translation unit; everything
// here is internal to the one that includes it.
//
// Shared conventions (identical to commefficient_tpu/ops/sketch.py and
// ops/topk.py):
//   - a chunk plane is (Tn, S, 128) float32, c_pad = S * 128 coordinates per
//     chunk; chunk t starts at global coordinate (t0 + t) * c_pad;
//   - row j shifts chunk t cyclically by m = 128 * q[j, t] + w[j, t];
//   - the sign of coordinate idx in row j is bit 0 of fmix32(idx ^ key_j):
//     1 -> +1, 0 -> -1;
//   - the top-k works on int32 bit patterns: mag = bits & 0x7FFFFFFF, and a
//     NaN pattern (mag > 0x7F800000) counts as magnitude 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t kAbsMask = 0x7FFFFFFF;
constexpr int32_t kInfBits = 0x7F800000;
constexpr int kCandidates = 16;

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

// sign_of(idx, key) * x, by flipping x's sign bit where the sign is -1:
// the same bits for every x but NaN, which stays a NaN (a product with a
// NaN gives the canonical NaN instead). Two int32 ops in place of a
// select and a multiply.
__device__ __forceinline__ float signed_by(float x, uint32_t idx,
                                          uint32_t key) {
  return __int_as_float(__float_as_int(x) ^
                        static_cast<int>((~mix32(idx ^ key) & 1u) << 31));
}

// Magnitude of an int32 bit pattern for the top-k (NaN -> 0).
__device__ __forceinline__ int32_t magnitude(int32_t bits) {
  const int32_t m = bits & kAbsMask;
  return m > kInfBits ? 0 : m;
}

}  // namespace
