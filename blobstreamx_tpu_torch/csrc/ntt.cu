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
// kernel at (2048, 2048) forward is at most 59.7 SASS instructions a
// butterfly at 64 registers a thread (62.7 with the compiler's 64-bit
// product in gl_mul), against 112.9 for the column-per-block kernel it
// replaced (kernel_report.py counts them).
//
// Columns longer than NTT_SMEM_MAX_N (the SHA tier's 2^18 and 2^21 column
// chunks) do not fit shared memory whole, so the log n stages run in passes
// of L stages, one launch a pass, with the same machinery: a pass starting at
// stage s0 gives each block a tile of 2^L positions x CT columns that share
// their bits below s0 and above s0 + L and vary over the L bits between, so
// every butterfly of those stages pairs two positions of one tile; the tile
// runs its L stages as above (radix-8 groups in registers, shared memory
// between them), with the whole column's stage and position in the twiddle
// exponent. The first pass reads the (lo, hi) rows bit-reversed straight
// from device memory, the last writes (lo, hi) with the n^-1 of the
// inverse; the passes between read and write one u64 intermediate (the
// caller's scratch, 8 B an element, in place). Two passes (ceil and floor of
// log n / 2 stages) while a pass's tile fits NTT_LONG_SMEM (2^11 positions x
// 4 columns, 72 KB, so two blocks share an SM), three above 2^22. Each
// element is read and written twice: 16 + 8 B in the first pass, 8 + 16 B
// in the last, 48 B against the 32 B of the function itself; at (2^21, 32)
// that is 0.96 ms at 3.35 TB/s against a 0.64 ms bound. Timed on an H100
// (PERF.md, kernel_report.py and its --probe), the passes are held back by
// their device memory accesses more than by the field arithmetic: with the
// arithmetic, and then the twiddle loads, taken out they keep most of their
// time. Wider column tiles (8 columns: three passes at 2^21, or two at one
// block an SM), 256 threads a block at three blocks an SM, and tiles staged
// through shared memory by cp.async into two buffers of persistent blocks
// all took as long or longer.
//
// Layout: lo/hi are int64 tensors holding u32 words, row-major (n, C).
// Twiddles: tw[k] = w^k for k < n/2 (w^-k for the inverse), as u64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gl64.cuh"

#define NTT_SMEM_MAX_N (1 << 14)
#define NTT_THREADS 512
#define NTT_TILE_COLS 4
#define NTT_LONG_COLS 4
#define NTT_LONG_THREADS 512
#define NTT_LONG_BLOCKS_PER_SM 2
#define NTT_LONG_SMEM (112 * 1024)
#define NTT_MAX_PASSES 4

__device__ __forceinline__ int bitrev(int i, int log_n) {
  return log_n == 0 ? 0 : (int)(__brev((unsigned)i) >> (32 - log_n));
}

// shared-memory row of element i: one padding row after every 8
__host__ __device__ __forceinline__ int ntt_pad(int i) { return i + (i >> 3); }

// the tile's columns, [i + i/8][CT]
extern __shared__ uint64_t ntt_smem[];

// where a pass reads and writes: the (lo, hi) rows of device memory (read
// bit-reversed), the tile in shared memory, or the u64 intermediate
enum { NTT_SMEM = 0, NTT_LOHI = 1, NTT_U64 = 2 };

struct NttTile {
  const int64_t* lo_in;
  const int64_t* hi_in;
  int64_t* lo_out;
  int64_t* hi_out;
  uint64_t* buf;       // the u64 intermediate of the long-column passes
  const uint64_t* tw;  // the power table
  int log_n, c, col0, log_ct, cw, inverse;
  int log_tile;        // stages of this pass: the tile holds 2^log_tile positions
  int s0, low, high;   // a long-column pass: first stage, the tile's fixed bits
  uint64_t n_inv;
};

// Device-memory row of tile position i: the tile kernel's tile is the whole
// column; a long-column pass's tile holds rows high | i << s0 | low.
template <bool SPLIT>
__device__ __forceinline__ int ntt_row(const NttTile& t, int i) {
  return SPLIT ? t.high | (i << t.s0) | t.low : i;
}

// DIT stages st .. st+R-1 on the 2^R elements v[j] = x[base + j * 2^st] of
// one group, k = base mod 2^st (st, base and k in the whole column's
// positions). FIRST (st = 0, so k = 0) skips the multiplies by w^0 = 1.
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

// One radix pass: stages st .. st+R-1 of the tile (st counted within the
// tile) for every group of the tile, read from SRC and written to DST. The
// groups are disjoint, so shared memory is read and written in place; so is
// the u64 intermediate, whose tile is read in the first radix pass and
// written in the last, after a barrier.
template <int R, int SRC, int DST, bool SPLIT>
__device__ __forceinline__ void ntt_pass(const NttTile& t, int st) {
  const int ct = 1 << t.log_ct;
  const int groups = ct << (t.log_tile - R);
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
      if (SRC == NTT_LOHI) {
        const size_t src = (size_t)bitrev(ntt_row<SPLIT>(t, i), t.log_n) * t.c + t.col0 + col;
        v[j] = gl_join(t.lo_in[src], t.hi_in[src]);
      } else if (SRC == NTT_U64) {
        v[j] = t.buf[(size_t)ntt_row<SPLIT>(t, i) * t.c + t.col0 + col];
      } else {
        v[j] = ntt_smem[ntt_pad(i) * ct + col];
      }
    }
    if (SPLIT)
      ntt_radix<R, SRC == NTT_LOHI>(v, t, t.s0 + st, (k << t.s0) | t.low);
    else
      ntt_radix<R, SRC == NTT_LOHI>(v, t, st, k);
#pragma unroll
    for (int j = 0; j < (1 << R); j++) {
      const int i = base + (j << st);
      if (DST == NTT_LOHI) {
        const uint64_t x = t.inverse ? gl_mul(v[j], t.n_inv) : v[j];
        const size_t dst = (size_t)ntt_row<SPLIT>(t, i) * t.c + t.col0 + col;
        t.lo_out[dst] = (int64_t)(x & GL_EPS);
        t.hi_out[dst] = (int64_t)(x >> 32);
      } else if (DST == NTT_U64) {
        t.buf[(size_t)ntt_row<SPLIT>(t, i) * t.c + t.col0 + col] = v[j];
      } else {
        ntt_smem[ntt_pad(i) * ct + col] = v[j];
      }
    }
  }
}

__host__ __device__ __forceinline__ int ntt_passes(int log_n) {
  return log_n <= 3 ? 1 : (log_n + 2) / 3;
}

// All log_tile stages of the tile: the first radix pass from SRC, the
// middle ones through shared memory, the last to DST. The passes are
// radix 8 but for the last one or two, which are radix 4 where log_tile is
// not a multiple of 3 (10 stages as 3 + 3 + 2 + 2, not 3 + 3 + 3 + 1: a
// radix-2 pass pays a group's loads, stores and index arithmetic for one
// butterfly).
template <int SRC, int DST, bool SPLIT>
__device__ __forceinline__ void ntt_stages(const NttTile& t) {
  const int passes = ntt_passes(t.log_tile);
  if (!SPLIT && passes == 1) {
    switch (t.log_tile) {
      case 0: ntt_pass<0, SRC, DST, SPLIT>(t, 0); break;
      case 1: ntt_pass<1, SRC, DST, SPLIT>(t, 0); break;
      case 2: ntt_pass<2, SRC, DST, SPLIT>(t, 0); break;
      default: ntt_pass<3, SRC, DST, SPLIT>(t, 0); break;
    }
    return;
  }
  const int radix8 = passes - (3 * passes - t.log_tile);  // the others are radix 4
  int st = radix8 > 0 ? 3 : 2;
  if (radix8 > 0)
    ntt_pass<3, SRC, NTT_SMEM, SPLIT>(t, 0);
  else
    ntt_pass<2, SRC, NTT_SMEM, SPLIT>(t, 0);
  __syncthreads();
  for (int p = 1; p < passes - 1; p++) {
    if (p < radix8) {
      ntt_pass<3, NTT_SMEM, NTT_SMEM, SPLIT>(t, st);
      st += 3;
    } else {
      ntt_pass<2, NTT_SMEM, NTT_SMEM, SPLIT>(t, st);
      st += 2;
    }
    __syncthreads();
  }
  if (t.log_tile - st == 3)
    ntt_pass<3, NTT_SMEM, DST, SPLIT>(t, st);
  else
    ntt_pass<2, NTT_SMEM, DST, SPLIT>(t, st);
}

__global__ void __launch_bounds__(NTT_THREADS) ntt_tile_kernel(
    const int64_t* __restrict__ lo_in, const int64_t* __restrict__ hi_in,
    int64_t* __restrict__ lo_out, int64_t* __restrict__ hi_out,
    const uint64_t* __restrict__ tw, int log_n, int c, int log_ct, int inverse,
    uint64_t n_inv) {
  const int col0 = blockIdx.x << log_ct;
  const NttTile t{lo_in, hi_in, lo_out, hi_out, nullptr, tw, log_n, c, col0, log_ct,
                  min(1 << log_ct, c - col0), inverse, log_n, 0, 0, 0, n_inv};
  ntt_stages<NTT_LOHI, NTT_LOHI, false>(t);
}

static size_t ntt_tile_smem(int log_n, int log_ct) {
  return ntt_passes(log_n) > 1 ? ((size_t)ntt_pad(1 << log_n) << log_ct) * sizeof(uint64_t) : 0;
}

// One pass of a long column: stages s0 .. s0+log_tile-1. A block's column
// tile is blockIdx.x mod (column tiles), its position tile b the quotient,
// bit-reversed in the first pass: there tile b reads the input rows
// r * 2^(log n - log_tile) + bitrev(b), so that blocks running together read
// neighbouring rows (it halves the first pass at (2^21, 2), whose rows are
// 16 B).
template <int SRC, int DST>
__device__ __forceinline__ void ntt_long_pass(const int64_t* lo_in, const int64_t* hi_in,
                                              int64_t* lo_out, int64_t* hi_out, uint64_t* buf,
                                              const uint64_t* tw, int log_n, int c, int log_ct,
                                              int s0, int log_tile, int inverse, uint64_t n_inv) {
  const int tiles_c = (c + (1 << log_ct) - 1) >> log_ct;
  const int col0 = (int)(blockIdx.x % tiles_c) << log_ct;
  const int b = SRC == NTT_LOHI ? bitrev((int)(blockIdx.x / tiles_c), log_n - log_tile)
                                : (int)(blockIdx.x / tiles_c);
  const NttTile t{lo_in, hi_in, lo_out, hi_out, buf, tw, log_n, c, col0, log_ct,
                  min(1 << log_ct, c - col0), inverse, log_tile, s0, b & ((1 << s0) - 1),
                  (b >> s0) << (s0 + log_tile), n_inv};
  ntt_stages<SRC, DST, true>(t);
}

#define NTT_LONG_ARGS                                                                 \
  const int64_t *__restrict__ lo_in, const int64_t *__restrict__ hi_in,               \
      int64_t *__restrict__ lo_out, int64_t *__restrict__ hi_out, uint64_t *buf,      \
      const uint64_t *__restrict__ tw, int log_n, int c, int log_ct, int s0, int log_tile, \
      int inverse, uint64_t n_inv
#define NTT_LONG_CALL lo_in, hi_in, lo_out, hi_out, buf, tw, log_n, c, log_ct, s0, log_tile, inverse, n_inv

// the first pass ((lo, hi) in, bit-reversed; u64 out), a middle one (u64 in
// place) and the last (u64 in; (lo, hi) out, times n^-1 for the inverse);
// two blocks of 512 threads an SM, so at most 64 registers a thread
#define NTT_LONG_BOUNDS __launch_bounds__(NTT_LONG_THREADS, NTT_LONG_BLOCKS_PER_SM)
__global__ void NTT_LONG_BOUNDS ntt_long_first_kernel(NTT_LONG_ARGS) {
  ntt_long_pass<NTT_LOHI, NTT_U64>(NTT_LONG_CALL);
}
__global__ void NTT_LONG_BOUNDS ntt_long_mid_kernel(NTT_LONG_ARGS) {
  ntt_long_pass<NTT_U64, NTT_U64>(NTT_LONG_CALL);
}
__global__ void NTT_LONG_BOUNDS ntt_long_last_kernel(NTT_LONG_ARGS) {
  ntt_long_pass<NTT_U64, NTT_LOHI>(NTT_LONG_CALL);
}

// The long-column plan for (2^log_n, c): the column tile (2^log_ct columns,
// at most NTT_LONG_COLS and no more than c), and the stages of each pass:
// as few passes as keep every pass's tile within NTT_LONG_SMEM, the stages
// split as evenly as they go, the larger shares first. Returns the passes.
static int ntt_long_plan(int log_n, int c, int* log_ct, int stages[NTT_MAX_PASSES]) {
  *log_ct = 0;
  while ((2 << *log_ct) <= NTT_LONG_COLS && (2 << *log_ct) <= c) ++*log_ct;
  int max_tile = 3;
  while (ntt_tile_smem(max_tile + 1, *log_ct) <= NTT_LONG_SMEM) max_tile++;
  const int passes = (log_n + max_tile - 1) / max_tile;
  if (passes > NTT_MAX_PASSES) return 0;
  for (int p = 0; p < passes; p++) stages[p] = log_n / passes + (p < log_n % passes ? 1 : 0);
  return passes;
}

// kernels launched by bsx_ntt_cols so far (bsx_ntt_launch_count)
static int ntt_launches = 0;

// Returns the CUDA error code of the launches (0 on success). `scratch` must
// hold n*C u64 when n > bsx_ntt_smem_max_n(), and may be null otherwise.
extern "C" int bsx_ntt_cols(const int64_t* lo_in, const int64_t* hi_in,
                            int64_t* lo_out, int64_t* hi_out,
                            const uint64_t* tw, int log_n, int c, int inverse,
                            uint64_t n_inv, uint64_t* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n = 1 << log_n;
  if (c <= 0) return 0;
  int dev, max_smem;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (n <= NTT_SMEM_MAX_N) {
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
    e = cudaGetLastError();
    if (e == cudaSuccess) ntt_launches++;
    return (int)e;
  }
  int log_ct, stages[NTT_MAX_PASSES];
  const int passes = ntt_long_plan(log_n, c, &log_ct, stages);
  if (passes < 2 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  const size_t tiles_c = (size_t)((c + (1 << log_ct) - 1) >> log_ct);
  for (int p = 0, s0 = 0; p < passes; s0 += stages[p], p++) {
    const int log_tile = stages[p];
    auto kernel = p == 0 ? ntt_long_first_kernel
                  : p == passes - 1 ? ntt_long_last_kernel : ntt_long_mid_kernel;
    const size_t smem = ntt_tile_smem(log_tile, log_ct);
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int groups = (1 << log_ct) << (log_tile - 3);
    const int threads = groups >= NTT_LONG_THREADS ? NTT_LONG_THREADS : (groups + 31) / 32 * 32;
    const size_t blocks = tiles_c << (log_n - log_tile);
    if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
    kernel<<<(unsigned)blocks, threads, smem, st>>>(lo_in, hi_in, lo_out, hi_out, scratch, tw,
                                                    log_n, c, log_ct, s0, log_tile, inverse,
                                                    n_inv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ntt_launches++;
  }
  return 0;
}

extern "C" int bsx_ntt_smem_max_n(void) { return NTT_SMEM_MAX_N; }

extern "C" int bsx_ntt_launch_count(void) { return ntt_launches; }

// The long-column plan of bsx_ntt_cols at (2^log_n, c): out[0] = log2 of the
// column tile, out[1 ..] = the stages of each pass. Returns the passes (0 if
// the column takes the tile kernel, or no plan fits NTT_MAX_PASSES).
extern "C" int bsx_ntt_long_plan(int log_n, int c, int* out) {
  if ((1 << log_n) <= NTT_SMEM_MAX_N || c <= 0) return 0;
  const int passes = ntt_long_plan(log_n, c, &out[0], &out[1]);
  return passes;
}

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
