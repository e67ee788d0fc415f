// Batched radix-2 DIT Goldilocks NTT along axis 0 of an (n, C) matrix.
//
// Replaces the Pallas kernels ntt_cols_pallas (blobstreamx_tpu/ops/ntt.py,
// _pallas_ntt_kernel and _roll_stages) and ntt_cols_pallas_split
// (_split_stages): both compute ntt_cols, all log n stages on one resident
// column tile, bit reversal on the way in and the n^-1 scale of the inverse
// on the way out.
//
// Bound: at the prover's shapes (n <= 256, C <= 8) a call moves a few KB and
// does a few thousand 64-bit multiplies, so launch latency dominates; at
// large n the transform is bound by the bytes it moves (16 B per element in
// and out), with log n butterfly stages of operations over them.
//
// Design: one block per column. The column is read once from device memory,
// bit-reversed into shared memory, runs every stage there with
// __syncthreads() between stages, and is written once. Columns longer than
// NTT_SMEM_MAX_N (whose 8 n bytes pass ~128 KB) take the same transform
// through device memory, one launch per stage with one thread per
// (butterfly, column) pair, so neighbouring threads touch neighbouring
// columns.
//
// Layout: lo/hi are int64 tensors holding u32 words, row-major (n, C).
// Twiddles: tw[k] = w^k for k < n/2 (w^-k for the inverse), as u64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl64.cuh"

#define NTT_SMEM_MAX_N (1 << 14)

__device__ __forceinline__ int bitrev(int i, int log_n) {
  return log_n == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - log_n));
}

__global__ void ntt_smem_kernel(const int64_t* __restrict__ lo_in,
                                const int64_t* __restrict__ hi_in,
                                int64_t* __restrict__ lo_out,
                                int64_t* __restrict__ hi_out,
                                const uint64_t* __restrict__ tw, int log_n,
                                int c, int inverse, uint64_t n_inv) {
  extern __shared__ uint64_t s[];
  const int col = blockIdx.x;
  const int n = 1 << log_n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    size_t src = (size_t)bitrev(i, log_n) * c + col;
    s[i] = gl_join(lo_in[src], hi_in[src]);
  }
  __syncthreads();
  for (int st = 0; st < log_n; st++) {
    const int half = 1 << st;
    for (int b = threadIdx.x; b < n / 2; b += blockDim.x) {
      const int k = b & (half - 1);
      const int i0 = ((b >> st) << (st + 1)) + k;
      const int i1 = i0 + half;
      const uint64_t t = gl_mul(s[i1], __ldg(&tw[(size_t)k << (log_n - 1 - st)]));
      const uint64_t x0 = s[i0];
      s[i0] = gl_add(x0, t);
      s[i1] = gl_sub(x0, t);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint64_t v = inverse ? gl_mul(s[i], n_inv) : s[i];
    size_t dst = (size_t)i * c + col;
    lo_out[dst] = (int64_t)(v & GL_EPS);
    hi_out[dst] = (int64_t)(v >> 32);
  }
}

__global__ void ntt_bitrev_kernel(const int64_t* __restrict__ lo_in,
                                  const int64_t* __restrict__ hi_in,
                                  uint64_t* __restrict__ buf, int log_n,
                                  int c) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = ((size_t)1 << log_n) * c;
  if (idx >= total) return;
  int row = (int)(idx / c);
  int col = (int)(idx % c);
  size_t src = (size_t)bitrev(row, log_n) * c + col;
  buf[idx] = gl_join(lo_in[src], hi_in[src]);
}

__global__ void ntt_stage_kernel(uint64_t* __restrict__ buf,
                                 const uint64_t* __restrict__ tw, int log_n,
                                 int c, int st) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  size_t total = ((size_t)1 << (log_n - 1)) * c;
  if (idx >= total) return;
  int b = (int)(idx / c);
  int col = (int)(idx % c);
  const int half = 1 << st;
  const int k = b & (half - 1);
  const size_t i0 = (size_t)(((b >> st) << (st + 1)) + k) * c + col;
  const size_t i1 = i0 + (size_t)half * c;
  const uint64_t t = gl_mul(buf[i1], __ldg(&tw[(size_t)k << (log_n - 1 - st)]));
  const uint64_t x0 = buf[i0];
  buf[i0] = gl_add(x0, t);
  buf[i1] = gl_sub(x0, t);
}

__global__ void ntt_store_kernel(const uint64_t* __restrict__ buf,
                                 int64_t* __restrict__ lo_out,
                                 int64_t* __restrict__ hi_out, size_t total,
                                 int inverse, uint64_t n_inv) {
  size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  uint64_t v = inverse ? gl_mul(buf[idx], n_inv) : buf[idx];
  lo_out[idx] = (int64_t)(v & GL_EPS);
  hi_out[idx] = (int64_t)(v >> 32);
}

static inline unsigned blocks_for(size_t total, unsigned threads) {
  return (unsigned)((total + threads - 1) / threads);
}

// Returns the CUDA error code of the launches (0 on success). `scratch` must
// hold n*C u64 when n > bsx_ntt_smem_max_n(), and may be null otherwise.
extern "C" int bsx_ntt_cols(const int64_t* lo_in, const int64_t* hi_in,
                            int64_t* lo_out, int64_t* hi_out,
                            const uint64_t* tw, int log_n, int c, int inverse,
                            uint64_t n_inv, uint64_t* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 1 << log_n;
  if (c <= 0) return 0;
  if (n <= NTT_SMEM_MAX_N) {
    size_t smem = (size_t)n * sizeof(uint64_t);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          ntt_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    int threads = n / 2 < 1 ? 1 : (n / 2 > 1024 ? 1024 : n / 2);
    ntt_smem_kernel<<<c, threads, smem, st>>>(lo_in, hi_in, lo_out, hi_out, tw,
                                              log_n, c, inverse, n_inv);
    return (int)cudaGetLastError();
  }
  const unsigned threads = 256;
  const size_t total = (size_t)n * c;
  ntt_bitrev_kernel<<<blocks_for(total, threads), threads, 0, st>>>(
      lo_in, hi_in, scratch, log_n, c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  for (int s = 0; s < log_n; s++) {
    ntt_stage_kernel<<<blocks_for(total / 2, threads), threads, 0, st>>>(
        scratch, tw, log_n, c, s);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  ntt_store_kernel<<<blocks_for(total, threads), threads, 0, st>>>(
      scratch, lo_out, hi_out, total, inverse, n_inv);
  return (int)cudaGetLastError();
}

extern "C" int bsx_ntt_smem_max_n(void) { return NTT_SMEM_MAX_N; }

// ---------------------------------------------------------------------------
// Four-step twiddle multiply fused with the transpose.
//
// Replaces the middle step of ntt_four_step, ntt_four_step_pallas and
// ntt_four_step_pallas_split (blobstreamx_tpu/ops/ntt.py, lines 469-472,
// 387-388 and 301-302): gl_mul by W[k1, i2] = w^(+-k1*i2) and `.T`, which XLA
// fused on the TPU. out[i2, k1] = in[k1, i2] * w^(k1*i2), from an (n1, n2)
// matrix to an (n2, n1) one, both row-major in the (lo, hi) layout.
//
// Bound: bytes. Each element is read once and written once (32 B in the
// (lo, hi) int64 layout) and takes one multiply; at n = 2^22 that is 134 MB,
// 0.040 ms at 3.35 TB/s. The twiddle reads come on top as this design's
// cost: at most the 16 MB power table (only the distinct k1*i2 are read),
// 0.005 ms more if all of it came from HBM.
//
// Design: a 32x32 tile per block of 32x8 threads, staged through shared
// memory as joined u64 values, so that the read along i2 and the write along
// k1 are both coalesced; the tile has 33 columns so a column read hits
// distinct banks. The twiddle comes from the NTT's power table tw[j] = w^j,
// j < n/2 (n/2 u64, held in L2): w^e = p - w^(e - n/2) for e >= n/2, since
// w^(n/2) = -1. Offsets and k1*i2 are 64-bit.
// ---------------------------------------------------------------------------

#define TT_TILE 32
#define TT_ROWS 8

__global__ void twiddle_transpose_kernel(const int64_t* __restrict__ lo_in,
                                         const int64_t* __restrict__ hi_in,
                                         int64_t* __restrict__ lo_out,
                                         int64_t* __restrict__ hi_out,
                                         const uint64_t* __restrict__ tw,
                                         int log_n1, int log_n2) {
  __shared__ uint64_t tile[TT_TILE][TT_TILE + 1];
  const size_t n1 = (size_t)1 << log_n1;
  const size_t n2 = (size_t)1 << log_n2;
  size_t half = (n1 * n2) >> 1;
  if (half == 0) half = 1;  // n = 1: the table is [w^0]
  const size_t k1_0 = (size_t)blockIdx.y * TT_TILE;
  const size_t i2_0 = (size_t)blockIdx.x * TT_TILE;
  for (int r = threadIdx.y; r < TT_TILE; r += TT_ROWS) {
    const size_t k1 = k1_0 + r;
    const size_t i2 = i2_0 + threadIdx.x;
    if (k1 < n1 && i2 < n2) {
      const size_t src = k1 * n2 + i2;
      const size_t e = k1 * i2;
      const uint64_t w = e < half ? __ldg(&tw[e]) : GL_P - __ldg(&tw[e - half]);
      tile[r][threadIdx.x] = gl_mul(gl_join(lo_in[src], hi_in[src]), w);
    }
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TT_TILE; r += TT_ROWS) {
    const size_t i2 = i2_0 + r;
    const size_t k1 = k1_0 + threadIdx.x;
    if (i2 < n2 && k1 < n1) {
      const uint64_t v = tile[threadIdx.x][r];
      const size_t dst = i2 * n1 + k1;
      lo_out[dst] = (int64_t)(v & GL_EPS);
      hi_out[dst] = (int64_t)(v >> 32);
    }
  }
}

// Returns the CUDA error code of the launch (0 on success). `tw` is the
// forward or inverse power table of length max(n/2, 1), n = n1 * n2.
extern "C" int bsx_twiddle_transpose(const int64_t* lo_in, const int64_t* hi_in,
                                     int64_t* lo_out, int64_t* hi_out,
                                     const uint64_t* tw, int log_n1, int log_n2,
                                     void* stream) {
  const unsigned gx = (unsigned)((((size_t)1 << log_n2) + TT_TILE - 1) / TT_TILE);
  const unsigned gy = (unsigned)((((size_t)1 << log_n1) + TT_TILE - 1) / TT_TILE);
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  twiddle_transpose_kernel<<<dim3(gx, gy), dim3(TT_TILE, TT_ROWS), 0,
                             (cudaStream_t)stream>>>(lo_in, hi_in, lo_out,
                                                     hi_out, tw, log_n1, log_n2);
  return (int)cudaGetLastError();
}
