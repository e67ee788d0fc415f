// Width-12 Goldilocks Poseidon permutation over a batch of states.
//
// Replaces the Pallas kernel permute_pallas (blobstreamx_tpu/ops/poseidon.py,
// _permute_kernel): 4 full rounds, 22 partial rounds, 4 full rounds, x^7
// S-box, and the circulant-plus-diagonal MDS whose entries are all powers of
// two (plonky2's parameters).
//
// Bound: a permutation moves 384 B (12 lo/hi int64 pairs in and out) and
// does 472 64x64-bit modular multiplies (8*12 + 22 S-boxes of 4 each). On
// top of those come the MDS's 30 * 12 * 13 coefficient terms and 360 row
// reductions, which no bound counts; on this card they, and not the bytes,
// set the time: the kernel is bound by integer instruction issue.
//
// Design: one thread per permutation with the 12 u64 states in registers
// for all 30 rounds, 64 threads a block so that config 5's 16384 lanes fill
// all 132 SMs; a ragged N is masked. The MDS is a multiply-accumulate over
// 32-bit halves: row r is sum_i C_i * lo[(i+r)%12] and the same over the
// high halves, each term one 32x32->64 multiply-add (C_i <= 2^16, and row
// 0's diagonal 8 folded into its first coefficient, 1 + 8 = 9), each sum
// below 13 * 2^48 so no carry is tracked; one reduction of lo_sum +
// hi_sum * 2^32 (< 2^82) per row finishes. Between rounds the state is kept
// as u64 values congruent mod p but not reduced to [0, p) (the MDS and the
// S-box take any u64); it is made canonical once, at the store. Carries are
// taken from the carry flag (gl64.cuh). Round constants sit in __constant__
// memory and the three round loops stay rolled, reading them by round index
// through the uniform datapath; with every round unrolled each constant
// becomes an operand of its add, but the straight code then misses the
// instruction cache and ran slower on an H100 (PERF.md). Threads read and
// write the (12, N) layout coalesced along N.
// Built for sm_90a this is 33,233 SASS instructions a permutation at 128
// registers a thread, against 60,805 for the shifted 128-bit adds it
// replaced (kernel_report.py counts them).
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl64.cuh"

#define POS_WIDTH 12
#define POS_HALF_FULL 4
#define POS_PARTIAL 22
#define POS_ROUNDS 30
#define POS_THREADS 64

__constant__ uint64_t POS_RC[POS_ROUNDS * POS_WIDTH];

// a + b mod p for any u64 a and b < p, as a u64 (not reduced to [0, p))
__device__ __forceinline__ uint64_t pos_add(uint64_t a, uint64_t b) {
  // on a carry s = a + b - 2^64 < p, so s + EPS < 2^64
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, c;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a0, a0, b0;\n\t"
      "addc.cc.u32 a1, a1, b1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 a0, a0, c;\n\t"
      "addc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(r)
      : "l"(a), "l"(b));
  return r;
}

// acc + a * b, a 32x32->64 multiply-add, in PTX: written as C with the
// 64-bit product, the front end turns a product by a power of two into
// 64-bit shifts and masks of the source word (5 instructions a term). From
// the PTX, ptxas makes each term a shift pair (IMAD.SHL, IMAD.HI) or a LEA
// pair and a 64-bit add of two terms at a time; with the coefficient read
// from the constant bank instead it makes IMAD.WIDE.U32 and the same adds,
// 1 % fewer instructions but 5 % slower on an H100 (PERF.md)
__device__ __forceinline__ uint64_t mad_wide(uint32_t a, uint32_t b, uint64_t acc) {
  uint64_t d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(acc));
  return d;
}

__device__ __forceinline__ uint64_t pos_sbox(uint64_t x) {
  const uint64_t x2 = gl_mul_nc(x, x);
  const uint64_t x3 = gl_mul_nc(x2, x);
  return gl_mul_nc(gl_mul_nc(x3, x3), x);
}

// al + ah * 2^32 mod p as a u64 (not reduced to [0, p)), for al, ah < 2^49
__device__ __forceinline__ uint64_t pos_fold(uint64_t al, uint64_t ah) {
  // al + ah * 2^32 = t + h * 2^64 ≡ t + h * EPS with h = ah_hi + carry <
  // 2^18; on the carry of t + h * EPS the sum is below 2^51, + EPS is safe
  uint64_t r;
  asm("{\n\t"
      ".reg .u32 a0, a1, b0, b1, h, c;\n\t"
      "mov.b64 {a0, a1}, %1;\n\t"
      "mov.b64 {b0, b1}, %2;\n\t"
      "add.cc.u32 a1, a1, b0;\n\t"
      "addc.u32 h, b1, 0;\n\t"
      "mad.lo.cc.u32 a0, h, 0xffffffff, a0;\n\t"
      "madc.hi.cc.u32 a1, h, 0xffffffff, a1;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "neg.s32 c, c;\n\t"
      "add.cc.u32 a0, a0, c;\n\t"
      "addc.u32 a1, a1, 0;\n\t"
      "mov.b64 %0, {a0, a1};\n\t"
      "}"
      : "=l"(r)
      : "l"(al), "l"(ah));
  return r;
}

__device__ __forceinline__ void pos_mds(uint64_t s[POS_WIDTH]) {
  // the circulant row (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)
  const uint32_t C[POS_WIDTH] = {1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024};
  uint32_t lo[POS_WIDTH], hi[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < POS_WIDTH; i++) {
    lo[i] = (uint32_t)s[i];
    hi[i] = (uint32_t)(s[i] >> 32);
  }
#pragma unroll
  for (int r = 0; r < POS_WIDTH; r++) {
    uint64_t al = 0, ah = 0;
#pragma unroll
    for (int i = 0; i < POS_WIDTH; i++) {
      // row 0's diagonal 8 is folded into its first coefficient
      const uint32_t c = (r == 0 && i == 0) ? C[0] + 8 : C[i];
      al = mad_wide(lo[(i + r) % POS_WIDTH], c, al);
      ah = mad_wide(hi[(i + r) % POS_WIDTH], c, ah);
    }
    s[r] = pos_fold(al, ah);
  }
}

__global__ void __launch_bounds__(POS_THREADS) poseidon_kernel(const int64_t* __restrict__ lo_in,
                                                               const int64_t* __restrict__ hi_in,
                                                               int64_t* __restrict__ lo_out,
                                                               int64_t* __restrict__ hi_out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint64_t s[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < POS_WIDTH; i++) s[i] = gl_join(lo_in[(size_t)i * n + j], hi_in[(size_t)i * n + j]);
#pragma unroll 1
  for (int r = 0; r < POS_HALF_FULL; r++) {
#pragma unroll
    for (int i = 0; i < POS_WIDTH; i++) s[i] = pos_sbox(pos_add(s[i], POS_RC[r * POS_WIDTH + i]));
    pos_mds(s);
  }
#pragma unroll 1
  for (int r = POS_HALF_FULL; r < POS_HALF_FULL + POS_PARTIAL; r++) {
#pragma unroll
    for (int i = 0; i < POS_WIDTH; i++) s[i] = pos_add(s[i], POS_RC[r * POS_WIDTH + i]);
    s[0] = pos_sbox(s[0]);
    pos_mds(s);
  }
#pragma unroll 1
  for (int r = POS_HALF_FULL + POS_PARTIAL; r < POS_ROUNDS; r++) {
#pragma unroll
    for (int i = 0; i < POS_WIDTH; i++) s[i] = pos_sbox(pos_add(s[i], POS_RC[r * POS_WIDTH + i]));
    pos_mds(s);
  }
#pragma unroll
  for (int i = 0; i < POS_WIDTH; i++) {
    const uint64_t v = gl_canonical(s[i]);
    lo_out[(size_t)i * n + j] = (int64_t)(v & GL_EPS);
    hi_out[(size_t)i * n + j] = (int64_t)(v >> 32);
  }
}

// Copies the 30*12 round constants (host u64 array) into __constant__ memory
// of the current device. Returns the CUDA error code.
extern "C" int bsx_poseidon_set_round_constants(const uint64_t* rc) {
  return (int)cudaMemcpyToSymbol(POS_RC, rc, sizeof(POS_RC));
}

extern "C" int bsx_poseidon_permute(const int64_t* lo_in, const int64_t* hi_in,
                                    int64_t* lo_out, int64_t* hi_out, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  poseidon_kernel<<<(n + POS_THREADS - 1) / POS_THREADS, POS_THREADS, 0,
                    (cudaStream_t)stream>>>(lo_in, hi_in, lo_out, hi_out, n);
  return (int)cudaGetLastError();
}
