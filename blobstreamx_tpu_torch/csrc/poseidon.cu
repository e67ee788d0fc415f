// Width-12 Goldilocks Poseidon permutation over a batch of states.
//
// Replaces the Pallas kernel permute_pallas (blobstreamx_tpu/ops/poseidon.py,
// _permute_kernel): 4 full rounds, 22 partial rounds, 4 full rounds, x^7
// S-box, and the circulant-plus-diagonal MDS whose entries are all powers of
// two (plonky2's parameters).
//
// Bound: a permutation moves 384 B (12 lo/hi int64 pairs in and out) and
// does 472 64x64-bit modular multiplies (8*12 + 22 S-boxes of 4 each), 360
// 128-bit reductions and 4,680 shifted 128-bit adds of the MDS. Counting
// only the multiplies, bytes and operations give about the same floor; the
// MDS adds tip it to the integer pipes. At the prover's batch sizes (16 to
// 16384 lanes) launch latency dominates both.
//
// Design: one thread per permutation with the 12 u64 states in registers
// for all 30 rounds; the round constants sit in __constant__ memory (every
// thread of a warp reads the same constant, which the constant cache
// broadcasts). The MDS needs no multiplies: each output row is a sum of the
// state words shifted by the circulant's exponents (plus 8*s0 on row 0),
// accumulated into a 128-bit (lo, hi) pair and reduced once. Threads read
// and write the (12, N) layout coalesced along N.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl64.cuh"

#define POS_WIDTH 12
#define POS_HALF_FULL 4
#define POS_PARTIAL 22
#define POS_ROUNDS 30

__constant__ uint64_t POS_RC[POS_ROUNDS * POS_WIDTH];

__device__ __forceinline__ uint64_t pos_sbox(uint64_t x) {
  const uint64_t x2 = gl_mul(x, x);
  const uint64_t x3 = gl_mul(x2, x);
  return gl_mul(gl_mul(x3, x3), x);
}

__device__ __forceinline__ void acc_shifted(uint64_t& lo, uint64_t& hi,
                                            uint64_t v, int k) {
  const uint64_t vlo = v << k;
  const uint64_t vhi = k ? v >> (64 - k) : 0;
  lo += vlo;
  hi += vhi + (lo < vlo ? 1 : 0);
}

__device__ __forceinline__ void pos_mds(uint64_t s[POS_WIDTH]) {
  // log2 of the circulant row (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)
  const int K[POS_WIDTH] = {0, 0, 1, 0, 3, 5, 1, 8, 12, 3, 16, 10};
  uint64_t out[POS_WIDTH];
#pragma unroll
  for (int r = 0; r < POS_WIDTH; r++) {
    uint64_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < POS_WIDTH; i++) acc_shifted(lo, hi, s[(i + r) % POS_WIDTH], K[i]);
    if (r == 0) acc_shifted(lo, hi, s[0], 3);  // the diagonal 8 on row 0
    out[r] = gl_reduce128(lo, hi);
  }
#pragma unroll
  for (int r = 0; r < POS_WIDTH; r++) s[r] = out[r];
}

__device__ __forceinline__ void pos_full_round(uint64_t s[POS_WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < POS_WIDTH; i++) s[i] = pos_sbox(gl_add(s[i], POS_RC[r * POS_WIDTH + i]));
  pos_mds(s);
}

__device__ __forceinline__ void pos_partial_round(uint64_t s[POS_WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < POS_WIDTH; i++) s[i] = gl_add(s[i], POS_RC[r * POS_WIDTH + i]);
  s[0] = pos_sbox(s[0]);
  pos_mds(s);
}

__global__ void poseidon_kernel(const int64_t* __restrict__ lo_in,
                                const int64_t* __restrict__ hi_in,
                                int64_t* __restrict__ lo_out,
                                int64_t* __restrict__ hi_out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint64_t s[POS_WIDTH];
#pragma unroll
  for (int i = 0; i < POS_WIDTH; i++) s[i] = gl_join(lo_in[(size_t)i * n + j], hi_in[(size_t)i * n + j]);
  int r = 0;
  for (; r < POS_HALF_FULL; r++) pos_full_round(s, r);
  for (; r < POS_HALF_FULL + POS_PARTIAL; r++) pos_partial_round(s, r);
  for (; r < POS_ROUNDS; r++) pos_full_round(s, r);
#pragma unroll
  for (int i = 0; i < POS_WIDTH; i++) {
    lo_out[(size_t)i * n + j] = (int64_t)(s[i] & GL_EPS);
    hi_out[(size_t)i * n + j] = (int64_t)(s[i] >> 32);
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
  const int threads = 128;
  poseidon_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(lo_in, hi_in, lo_out, hi_out, n);
  return (int)cudaGetLastError();
}
