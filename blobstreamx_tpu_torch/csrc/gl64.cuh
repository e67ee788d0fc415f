// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on native u64 lanes.
//
// Shared by the NTT and Poseidon kernels. Every function takes and returns
// canonical values in [0, p). Reduction uses 2^64 ≡ EPS = 2^32 - 1 and
// 2^96 ≡ -1 (mod p); the 128-bit product comes from a*b and __umul64hi.
#pragma once

#include <stdint.h>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  // on a wrap s = a + b - 2^64 < 2^64 - 2^33, so s + EPS < p
  if (s < a) return s + GL_EPS;
  return s >= GL_P ? s - GL_P : s;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  // on a borrow d = a - b + 2^64, and a - b + p = d - EPS
  return a < b ? d - GL_EPS : d;
}

__device__ __forceinline__ uint64_t gl_reduce128(uint64_t lo, uint64_t hi) {
  // lo + hi*2^64 = lo + hl*2^64 + hh*2^96 ≡ lo + hl*EPS - hh
  uint64_t hh = hi >> 32;
  uint64_t hl = hi & GL_EPS;
  uint64_t t0 = lo - hh;
  if (lo < hh) t0 -= GL_EPS;
  uint64_t t1 = hl * GL_EPS;
  uint64_t r = t0 + t1;
  if (r < t1) r += GL_EPS;
  return r >= GL_P ? r - GL_P : r;
}

__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  return gl_reduce128(a * b, __umul64hi(a, b));
}

// (lo, hi) int64 words of the PyTorch layout <-> one u64 value
__device__ __forceinline__ uint64_t gl_join(int64_t lo, int64_t hi) {
  return ((uint64_t)hi << 32) | ((uint64_t)lo & GL_EPS);
}
