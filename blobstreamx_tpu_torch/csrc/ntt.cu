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
// and out, 32 B in the (lo, hi) int64 layout), with log n butterfly stages
// of operations over them. At the four-step's (2048, 2048) passes that is
// 0.040 ms on an H100; what stands in its way is the access pattern (a
// column's words are a row apart) and the stage-by-stage barriers.
//
// Design (columns of n <= NTT_SMEM_MAX_N): one block per tile of CT
// adjacent columns (CT a power of two <= NTT_TILE_COLS, cut until the tile
// fits shared memory; a ragged last tile is masked), so that each row's CT
// words of lo, and of hi, are one contiguous read or write: with CT = 4
// that is a whole 32 B sector. The log n stages run in passes of three
// (radix 8) in registers: a thread holds the 8 elements of one butterfly
// group of one column, x[base + j * 2^st], runs stages st, st+1, st+2 on
// them and writes them back, so that 11 stages take 4 passes and 3
// barriers between them instead of 11. The first pass reads its group
// straight from device memory (the bit reversal is in the row index; its
// twiddles of 1 are not multiplied), the last writes straight to device
// memory (with the n^-1 of the inverse); only the passes between go through
// shared memory, laid out [i + i/8][CT] so that neither the first pass's
// stride-8 writes nor the later passes' contiguous accesses conflict on
// banks. Twiddles come from the power table in device memory through the
// read-only cache (8 KB at n = 2048). At (2048, 2048) a block holds 72 KB,
// so two fit on an SM; 512 threads a block keep 32 warps there to hide the
// latency of the first pass's loads. Carries of the field arithmetic come
// from the carry flag (gl64.cuh). Other choices were timed on an H100 at
// the shapes of chip_smoke.py's phase 3 (PERF.md): tiles of 2 columns take
// twice as long at (2048, 2048) (half of every 32 B sector is wasted),
// tiles of 8 columns and 256 threads a block a few per cent longer, and the
// power table staged in shared memory once per block was within 2 % at
// (2048, 2048) but 18 % slower at (16384, 3). Built for sm_90a the whole
// kernel at (2048, 2048) forward is at most 62.7 SASS instructions a
// butterfly at 64 registers a thread, against 112.9 for the
// column-per-block kernel it replaced (kernel_report.py counts them).
// Columns longer than NTT_SMEM_MAX_N take the same transform through device
// memory, one launch per stage with one thread per (butterfly, column)
// pair, so neighbouring threads touch neighbouring columns.
//
// Layout: lo/hi are int64 tensors holding u32 words, row-major (n, C).
// Twiddles: tw[k] = w^k for k < n/2 (w^-k for the inverse), as u64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl64.cuh"

#define NTT_SMEM_MAX_N (1 << 14)
#define NTT_THREADS 512
#define NTT_TILE_COLS 4

__device__ __forceinline__ int bitrev(int i, int log_n) {
  return log_n == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - log_n));
}

// shared-memory row of element i: one padding row after every 8
__host__ __device__ __forceinline__ int ntt_pad(int i) { return i + (i >> 3); }

// the tile's columns, [i + i/8][CT]
extern __shared__ uint64_t ntt_smem[];

struct NttTile {
  const int64_t* lo_in;
  const int64_t* hi_in;
  int64_t* lo_out;
  int64_t* hi_out;
  const uint64_t* tw;  // the power table
  int log_n, c, col0, log_ct, cw, inverse;
  uint64_t n_inv;
};

// DIT stages st .. st+R-1 on the 2^R elements v[j] = x[base + j * 2^st] of
// one group, k = base mod 2^st. FIRST (st = 0, so k = 0) skips the
// multiplies by w^0 = 1.
template <int R, bool FIRST>
__device__ __forceinline__ void ntt_radix(uint64_t v[8], const NttTile& t, int st, int k) {
  const int log_n = t.log_n;
#pragma unroll
  for (int q = 0; q < R; q++) {
    const int h = 1 << q;
    uint64_t w[4];
#pragma unroll
    for (int m = 0; m < h; m++) {
      const int e = (k + (m << st)) << (log_n - 1 - st - q);
      w[m] = FIRST && m == 0 ? 1 : __ldg(&t.tw[e]);
    }
#pragma unroll
    for (int j = 0; j < (1 << R); j++) {
      if (j & h) continue;
      const int m = j & (h - 1);
      const uint64_t u = FIRST && m == 0 ? v[j + h] : gl_mul(v[j + h], w[m]);
      const uint64_t x0 = v[j];
      v[j] = gl_add(x0, u);
      v[j + h] = gl_sub(x0, u);
    }
  }
}

// One pass: stages st .. st+R-1 for every group of the tile. The first pass
// reads device memory (rows bit-reversed), the last writes it; the others
// read and write shared memory in place (groups are disjoint).
template <int R, bool FROM_GLOBAL, bool TO_GLOBAL>
__device__ __forceinline__ void ntt_pass(const NttTile& t, int st) {
  const int ct = 1 << t.log_ct;
  const int groups = ct << (t.log_n - R);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int col = g & (ct - 1);
    if (col >= t.cw) continue;
    const int gi = g >> t.log_ct;
    const int k = gi & ((1 << st) - 1);
    const int base = ((gi >> st) << (st + R)) | k;
    uint64_t v[8];
#pragma unroll
    for (int j = 0; j < (1 << R); j++) {
      const int i = base + (j << st);
      if (FROM_GLOBAL) {
        const size_t src = (size_t)bitrev(i, t.log_n) * t.c + t.col0 + col;
        v[j] = gl_join(t.lo_in[src], t.hi_in[src]);
      } else {
        v[j] = ntt_smem[ntt_pad(i) * ct + col];
      }
    }
    ntt_radix<R, FROM_GLOBAL>(v, t, st, k);
#pragma unroll
    for (int j = 0; j < (1 << R); j++) {
      const int i = base + (j << st);
      if (TO_GLOBAL) {
        const uint64_t x = t.inverse ? gl_mul(v[j], t.n_inv) : v[j];
        const size_t dst = (size_t)i * t.c + t.col0 + col;
        t.lo_out[dst] = (int64_t)(x & GL_EPS);
        t.hi_out[dst] = (int64_t)(x >> 32);
      } else {
        ntt_smem[ntt_pad(i) * ct + col] = v[j];
      }
    }
  }
}

__host__ __device__ __forceinline__ int ntt_passes(int log_n) {
  return log_n <= 3 ? 1 : (log_n + 2) / 3;
}

__global__ void __launch_bounds__(NTT_THREADS) ntt_tile_kernel(
    const int64_t* __restrict__ lo_in, const int64_t* __restrict__ hi_in,
    int64_t* __restrict__ lo_out, int64_t* __restrict__ hi_out,
    const uint64_t* __restrict__ tw, int log_n, int c, int log_ct, int inverse,
    uint64_t n_inv) {
  const int col0 = blockIdx.x << log_ct;
  const int passes = ntt_passes(log_n);
  const NttTile t{lo_in, hi_in, lo_out, hi_out, tw, log_n, c, col0, log_ct,
                  min(1 << log_ct, c - col0), inverse, n_inv};
  if (passes == 1) {
    switch (log_n) {
      case 0: ntt_pass<0, true, true>(t, 0); break;
      case 1: ntt_pass<1, true, true>(t, 0); break;
      case 2: ntt_pass<2, true, true>(t, 0); break;
      default: ntt_pass<3, true, true>(t, 0); break;
    }
    return;
  }
  ntt_pass<3, true, false>(t, 0);
  __syncthreads();
  int st = 3;
  for (int p = 1; p < passes - 1; p++, st += 3) {
    ntt_pass<3, false, false>(t, st);
    __syncthreads();
  }
  switch (log_n - st) {
    case 1: ntt_pass<1, false, true>(t, st); break;
    case 2: ntt_pass<2, false, true>(t, st); break;
    default: ntt_pass<3, false, true>(t, st); break;
  }
}

static size_t ntt_tile_smem(int log_n, int log_ct) {
  return ntt_passes(log_n) > 1 ? ((size_t)ntt_pad(1 << log_n) << log_ct) * sizeof(uint64_t) : 0;
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
    int dev, max_smem;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    int log_ct = 0;
    while ((2 << log_ct) <= NTT_TILE_COLS && (2 << log_ct) <= c &&
           ntt_tile_smem(log_n, log_ct + 1) <= (size_t)max_smem)
      log_ct++;
    const size_t smem = ntt_tile_smem(log_n, log_ct);
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(ntt_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    // enough threads for the widest radix-8 pass, in whole warps
    const int groups = (1 << log_ct) << (log_n > 3 ? log_n - 3 : 0);
    const int threads = groups >= NTT_THREADS ? NTT_THREADS : (groups + 31) / 32 * 32;
    const unsigned tiles = (unsigned)((c + (1 << log_ct) - 1) >> log_ct);
    ntt_tile_kernel<<<tiles, threads, smem, st>>>(lo_in, hi_in, lo_out, hi_out, tw,
                                                  log_n, c, log_ct, inverse, n_inv);
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
