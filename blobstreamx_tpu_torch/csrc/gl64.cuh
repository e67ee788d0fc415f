// Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on native u64 lanes.
//
// Shared by the NTT and Poseidon kernels. gl_add, gl_sub and gl_mul take and
// return canonical values in [0, p); gl_reduce128_nc returns a u64 that is
// only congruent mod p, for callers that take any u64 (gl_mul's inputs are
// any u64), and so does gl_add_nc for any a and b < p (as gl_sub does for
// such operands). Reduction uses 2^64 ≡ EPS = 2^32 - 1 and 2^96 ≡ -1 (mod p).
//
// The carries are taken from the hardware's carry flag (PTX add.cc / addc,
// sub.cc / subc on the 32-bit halves) instead of 64-bit compares, each of
// which costs two ISETP and two SEL in SASS: gl_add is 9 PTX instructions,
// gl_sub 5 and gl_reduce128_nc 11 (plus one 32x32 multiply). gl_mul (the
// NTT kernels' multiply) is one PTX block: the 128-bit product on one carry
// chain, the same reduction and the canonical step on the carry flag.
#pragma once

#include <stdint.h>

#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL

__device__ __forceinline__ uint64_t gl_add(uint64_t a, uint64_t b) {
  // s = a + b; the result is s + EPS (= s - p mod 2^64) when a + b carries
  // out of 64 bits or s + EPS does (s >= p); both cannot carry
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, t0, t1, c;\n\t"
      ".reg .pred q;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "add.cc.u32 t0, a0, 0xffffffff;\n\t"
      "addc.cc.u32 t1, a1, 0;\n\t"
      "addc.u32 c, c, 0;\n\t"
      "setp.ne.u32 q, c, 0;\n\t"
      "selp.b32 a0, t0, a0, q;\n\t"
      "selp.b32 a1, t1, a1, q;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

// a + b mod p as a u64, not reduced to [0, p), for any a and b < p: the
// sum s, plus EPS when it carries out of 64 bits (then s < p, so s + EPS
// does not carry again); 6 PTX instructions against gl_add's 9. (The
// carry of an add.cc must not feed a subc: ptxas takes the flag of a
// subtraction as "no borrow", so subc.u32 c, 0, 0 after an add.cc gives
// EPS without a carry, not with one, as measured on an H100.)
__device__ __forceinline__ uint64_t gl_add_nc(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, c;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"  // EPS on a carry, else 0
      "add.cc.u32 a0, a0, c;\n\t"
      "addc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

__device__ __forceinline__ uint64_t gl_sub(uint64_t a, uint64_t b) {
  // d = a - b; on a borrow d = a - b + 2^64 > EPS, and a - b + p = d - EPS
  // (for any a and b < p: then the result is only congruent, a u64)
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, c;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "sub.cc.u32 a0, a0, b0;\n\t"
      "subc.cc.u32 a1, a1, b1;\n\t"
      "subc.u32 c, 0, 0;\n\t"  // EPS on a borrow, else 0
      "sub.cc.u32 a0, a0, c;\n\t"
      "subc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

// lo + hi * 2^64 mod p as a u64 (not reduced to [0, p)), for any lo, hi.
__device__ __forceinline__ uint64_t gl_reduce128_nc(uint64_t lo, uint64_t hi) {
  // hi = hh * 2^32 + hl: lo + hi * 2^64 ≡ lo - hh + hl * EPS. On the borrow
  // of lo - hh the value is t = lo - hh + 2^64 >= 2^64 - 2^32, and t - EPS
  // is the residue; on the carry of t + hl * EPS the sum r is below
  // hl * EPS < 2^64 - 2^33, so r + EPS does not carry again
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 l0, l1, h0, h1, u0, u1, c;\n\t"
      ".reg .u64 u;\n\t"
      "mov.b64 {l0, l1}, %1;\n\t"
      "mov.b64 {h0, h1}, %2;\n\t"
      "mul.wide.u32 u, h0, 0xffffffff;\n\t"
      "mov.b64 {u0, u1}, u;\n\t"
      "sub.cc.u32 l0, l0, h1;\n\t"
      "subc.cc.u32 l1, l1, 0;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "sub.cc.u32 l0, l0, c;\n\t"
      "subc.u32 l1, l1, 0;\n\t"
      "add.cc.u32 l0, l0, u0;\n\t"
      "addc.cc.u32 l1, l1, u1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 l0, l0, c;\n\t"
      "addc.u32 l1, l1, 0;\n\t"
      "mov.b64 %0, {l0, l1};\n\t"
      "}"
      : "=l"(r)
      : "l"(lo), "l"(hi));
  return r;
}

__device__ __forceinline__ uint64_t gl_canonical(uint64_t x) {
  return x >= GL_P ? x - GL_P : x;
}

// a * b mod p for any u64 a and b, as a u64 (not reduced to [0, p))
__device__ __forceinline__ uint64_t gl_mul_nc(uint64_t a, uint64_t b) {
  return gl_reduce128_nc(a * b, __umul64hi(a, b));
}

// a * b mod p in [0, p) for any u64 a and b. The product r3:r2:r1:r0 comes
// as four 32x32 products, each one's low and high halves adjacent on one
// carry chain, so that ptxas issues one IMAD.WIDE.U32 with carry in and out
// per product instead of the compiler's 64-bit product and __umul64hi; the
// non-.cc madc never carries out (a word of the product, or hi(a0*b1) + 1).
// Then gl_reduce128_nc's reduction, its r2 * EPS term added by a mad.lo.cc /
// madc.hi.cc pair, which runs on the multiply pipe, not the integer add
// pipe that the rest of a butterfly keeps busy (3 % off the tile kernel at
// (2048, 2048) and 2.4 % off the four-step at 2^22 on an H100,
// kernel_report.py --probe, PERF.md),
// and r - p = r + EPS - 2^64 where r + EPS carries.
__device__ __forceinline__ uint64_t gl_mul(uint64_t a, uint64_t b) {
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, r0, r1, r2, r3, u0, u1, c;\n\t"
      ".reg .pred q;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "mul.lo.u32 r0, a0, b0;\n\t"
      "mul.hi.u32 r1, a0, b0;\n\t"
      "mad.lo.cc.u32 r1, a0, b1, r1;\n\t"
      "madc.hi.u32 r2, a0, b1, 0;\n\t"
      "mad.lo.cc.u32 r1, a1, b0, r1;\n\t"
      "madc.hi.cc.u32 r2, a1, b0, r2;\n\t"
      "addc.u32 r3, 0, 0;\n\t"
      "mad.lo.cc.u32 r2, a1, b1, r2;\n\t"
      "madc.hi.u32 r3, a1, b1, r3;\n\t"
      "sub.cc.u32 r0, r0, r3;\n\t"
      "subc.cc.u32 r1, r1, 0;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "sub.cc.u32 r0, r0, c;\n\t"
      "subc.u32 r1, r1, 0;\n\t"
      "mad.lo.cc.u32 r0, r2, 0xffffffff, r0;\n\t"
      "madc.hi.cc.u32 r1, r2, 0xffffffff, r1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 r0, r0, c;\n\t"
      "addc.u32 r1, r1, 0;\n\t"
      "add.cc.u32 u0, r0, 0xffffffff;\n\t"
      "addc.cc.u32 u1, r1, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "setp.ne.u32 q, c, 0;\n\t"
      "selp.b32 r0, u0, r0, q;\n\t"
      "selp.b32 r1, u1, r1, q;\n\t"
      "mov.b64 %0, {r0, r1};\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

// (lo, hi) int64 words of the PyTorch layout <-> one u64 value
__device__ __forceinline__ uint64_t gl_join(int64_t lo, int64_t hi) {
  return ((uint64_t)hi << 32) | ((uint64_t)lo & GL_EPS);
}
