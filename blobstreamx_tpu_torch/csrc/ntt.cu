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
