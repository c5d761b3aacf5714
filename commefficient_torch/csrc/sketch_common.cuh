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

// The sign of coordinate idx in the row of key times x, by flipping x's
// sign bit where the sign is -1: the same bits for every x but NaN, which
// stays a NaN (a product with a NaN gives the canonical NaN instead). Two
// int32 ops in place of a select and a multiply.
__device__ __forceinline__ float signed_by(float x, uint32_t idx,
                                          uint32_t key) {
  return __int_as_float(__float_as_int(x) ^
                        static_cast<int>((~mix32(idx ^ key) & 1u) << 31));
}

// The sign hash in fewer ALU-pipe ops, for a kernel that hashes one
// coordinate in several rows (the query):
//  - fmix32's first step, x ^ (x >> 16), distributes over xor, so for
//    x = idx ^ key it is fold16(idx) ^ fold16(key): a coordinate's half is
//    taken once and shared by the rows, a row's once a block;
//  - the sign is bit 0 of fmix32, bit 0 ^ bit 16 of z = y * M2, y the
//    value after the second xor-shift. z * 0x80008000 adds z << 31 and
//    z << 15, whose bit 31 is that xor (the addends share no lower bit, so
//    no carry reaches it), and y * (M2 * 0x80008000) is that product: one
//    multiply, on the FMA pipe, in place of a multiply, a shift, an xor
//    and the bit's move to the sign.
__device__ __forceinline__ uint32_t fold16(uint32_t x) { return x ^ (x >> 16); }

// Bit 31: bit 0 of mix32(x), given folded = fold16(x).
__device__ __forceinline__ uint32_t sign_word(uint32_t folded) {
  constexpr uint32_t kSignMul = 0xC2B2AE35u * 0x80008000u;  // mod 2^32
  uint32_t y = folded * 0x85EBCA6Bu;
  y ^= y >> 13;
  return y * kSignMul;
}

// signed_by(x, idx, key) from sign_word(fold16(idx ^ key)): one LOP3.
__device__ __forceinline__ float signed_by_word(float x, uint32_t word) {
  return __uint_as_float(__float_as_uint(x) ^ (~word & 0x80000000u));
}

// Magnitude of an int32 bit pattern for the top-k (NaN -> 0).
__device__ __forceinline__ int32_t magnitude(int32_t bits) {
  const int32_t m = bits & kAbsMask;
  return m > kInfBits ? 0 : m;
}

}  // namespace
