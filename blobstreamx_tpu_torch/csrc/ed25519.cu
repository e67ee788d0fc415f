// GF(2^255 - 19) kernels for Ed25519 batch verification: the complete
// twisted-Edwards point addition and the field power chains.
//
// Replaces three Pallas kernels of the JAX package:
//   - add_fused (blobstreamx_tpu/ops/curve25519.py, _add_kernel): complete
//     unified addition in extended coordinates, add-2008-hwcd-3 with k = 2d;
//   - sqn (blobstreamx_tpu/fields/gf25519.py, _sqn_kernel): a^(2^k);
//   - pow22523 (blobstreamx_tpu/fields/gf25519.py, _pow22523_kernel):
//     z^(2^252 - 3), the square-root chain of point decompression.
//
// Bound: a point addition reads 8 coordinates and writes 4, each 16 limbs
// held in int64 (the JAX layout: 128 B per coordinate, 1,536 B per lane),
// around 9 field multiplies of 20 64x64-bit products each, so by bytes; the
// pow22523 chain reads and writes 256 B per lane around 262 field
// multiplies, so by operations. At the prover's lane counts (64 to 4096)
// launch latency dominates both.
//
// Design: one thread per lane. Each coordinate arrives as 16 limbs of 16 bits
// (the JAX layout, (16, N) int64, read coalesced along N), is packed into
// four u64 words (radix 2^64) and kept in registers through the whole add or
// chain. Products are 4x4 schoolbook with __umul64hi, folded with
// 2^256 ≡ 38; values stay below 2^256 ("semi-reduced") in between and are
// canonicalized (< p) once before the store, so every output limb is < 2^16
// and the value is the canonical representative.
#include <cuda_runtime.h>
#include <stdint.h>

struct fe {
  uint64_t v[4];
};

// 2d mod p, d = -121665/121666 (the addition law's constant)
__device__ __constant__ uint64_t FE_K2D[4] = {
    0xebd69b9426b2f159ULL, 0x00e0149a8283b156ULL, 0x198e80f2eef3d130ULL,
    0x2406d9dc56dffce7ULL};
// p = 2^255 - 19
__device__ __constant__ uint64_t FE_P[4] = {
    0xffffffffffffffedULL, 0xffffffffffffffffULL, 0xffffffffffffffffULL,
    0x7fffffffffffffffULL};

__device__ __forceinline__ uint64_t add_carry(uint64_t a, uint64_t b, uint64_t& c) {
  uint64_t s = a + c;
  uint64_t c1 = s < c;
  uint64_t t = s + b;
  c = c1 + (t < b);
  return t;
}

__device__ __forceinline__ uint64_t sub_borrow(uint64_t a, uint64_t b, uint64_t& br) {
  uint64_t d = a - b;
  uint64_t b1 = a < b;
  uint64_t e = d - br;
  br = b1 + (d < br);
  return e;
}

// r + c*2^256 ≡ r + 38c, for c < 2^58; a second wrap leaves r < 38*c, so the
// final +38 cannot carry.
__device__ __forceinline__ void fe_fold(fe& r, uint64_t c) {
  uint64_t carry = 0;
  r.v[0] = add_carry(r.v[0], c * 38, carry);
#pragma unroll
  for (int k = 1; k < 4; k++) r.v[k] = add_carry(r.v[k], 0, carry);
  uint64_t c2 = 0;
  r.v[0] = add_carry(r.v[0], carry * 38, c2);
#pragma unroll
  for (int k = 1; k < 4; k++) r.v[k] = add_carry(r.v[k], 0, c2);
}

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) r.v[k] = add_carry(a.v[k], b.v[k], c);
  fe_fold(r, c);
  return r;
}

// a - b - br*2^256 ≡ a - b - 38*br; a second borrow (only when the first
// result is < 38) takes 38 once more.
__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
  uint64_t br = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) r.v[k] = sub_borrow(a.v[k], b.v[k], br);
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    uint64_t b2 = 0;
    r.v[0] = sub_borrow(r.v[0], br * 38, b2);
#pragma unroll
    for (int k = 1; k < 4; k++) r.v[k] = sub_borrow(r.v[k], 0, b2);
    br = b2;
  }
  return r;
}

__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  uint64_t t[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 4; i++) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < 4; j++) {
      uint64_t lo = a.v[i] * b.v[j];
      uint64_t hi = __umul64hi(a.v[i], b.v[j]);
      uint64_t s = t[i + j] + lo;
      uint64_t c = s < lo;
      s += carry;
      c += s < carry;
      t[i + j] = s;
      carry = hi + c;
    }
    t[i + 4] = carry;
  }
  fe r;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint64_t lo = t[4 + k] * 38;
    uint64_t hi = __umul64hi(t[4 + k], 38);
    uint64_t s = t[k] + lo;
    uint64_t c = s < lo;
    s += carry;
    c += s < carry;
    r.v[k] = s;
    carry = hi + c;
  }
  fe_fold(r, carry);
  return r;
}

__device__ __forceinline__ fe fe_sqn(fe a, int k) {
  for (int i = 0; i < k; i++) a = fe_mul(a, a);
  return a;
}

// subtract p while >= p (a value < 2^256 needs at most two)
__device__ __forceinline__ fe fe_canonical(fe a) {
#pragma unroll
  for (int pass = 0; pass < 2; pass++) {
    fe d;
    uint64_t br = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) d.v[k] = sub_borrow(a.v[k], FE_P[k], br);
    if (!br) a = d;
  }
  return a;
}

__device__ __forceinline__ fe fe_load(const int64_t* __restrict__ limbs, int n, int j) {
  fe r;
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint64_t w = 0;
#pragma unroll
    for (int q = 0; q < 4; q++) w |= ((uint64_t)limbs[(size_t)(4 * k + q) * n + j] & 0xFFFFULL) << (16 * q);
    r.v[k] = w;
  }
  return r;
}

__device__ __forceinline__ void fe_store(int64_t* __restrict__ limbs, int n, int j, fe a) {
  a = fe_canonical(a);
#pragma unroll
  for (int k = 0; k < 4; k++)
#pragma unroll
    for (int q = 0; q < 4; q++) limbs[(size_t)(4 * k + q) * n + j] = (int64_t)((a.v[k] >> (16 * q)) & 0xFFFFULL);
}

__global__ void edwards_add_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
                                   const int64_t* __restrict__ z1, const int64_t* __restrict__ t1,
                                   const int64_t* __restrict__ x2, const int64_t* __restrict__ y2,
                                   const int64_t* __restrict__ z2, const int64_t* __restrict__ t2,
                                   int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                                   int64_t* __restrict__ oz, int64_t* __restrict__ ot, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const fe X1 = fe_load(x1, n, j), Y1 = fe_load(y1, n, j), Z1 = fe_load(z1, n, j), T1 = fe_load(t1, n, j);
  const fe X2 = fe_load(x2, n, j), Y2 = fe_load(y2, n, j), Z2 = fe_load(z2, n, j), T2 = fe_load(t2, n, j);
  fe k2d;
#pragma unroll
  for (int k = 0; k < 4; k++) k2d.v[k] = FE_K2D[k];
  const fe a = fe_mul(fe_sub(Y1, X1), fe_sub(Y2, X2));
  const fe b = fe_mul(fe_add(Y1, X1), fe_add(Y2, X2));
  const fe c = fe_mul(fe_mul(T1, k2d), T2);
  const fe d = fe_mul(fe_add(Z1, Z1), Z2);
  const fe e = fe_sub(b, a);
  const fe f = fe_sub(d, c);
  const fe g = fe_add(d, c);
  const fe h = fe_add(b, a);
  fe_store(ox, n, j, fe_mul(e, f));
  fe_store(oy, n, j, fe_mul(g, h));
  fe_store(oz, n, j, fe_mul(f, g));
  fe_store(ot, n, j, fe_mul(e, h));
}

// z^(2^252 - 3) by the classic curve25519 addition chain
__global__ void pow22523_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const fe z = fe_load(in, n, j);
  const fe z2 = fe_mul(z, z);
  const fe z9 = fe_mul(fe_sqn(z2, 2), z);
  const fe z11 = fe_mul(z9, z2);
  const fe z_5 = fe_mul(fe_mul(z11, z11), z9);
  const fe z_10 = fe_mul(fe_sqn(z_5, 5), z_5);
  const fe z_20 = fe_mul(fe_sqn(z_10, 10), z_10);
  const fe z_40 = fe_mul(fe_sqn(z_20, 20), z_20);
  const fe z_50 = fe_mul(fe_sqn(z_40, 10), z_10);
  const fe z_100 = fe_mul(fe_sqn(z_50, 50), z_50);
  const fe z_200 = fe_mul(fe_sqn(z_100, 100), z_100);
  const fe z_250 = fe_mul(fe_sqn(z_200, 50), z_50);
  fe_store(out, n, j, fe_mul(fe_sqn(z_250, 2), z));
}

__global__ void sqn_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int n, int k) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  fe_store(out, n, j, fe_sqn(fe_load(in, n, j), k));
}

static const int ED_THREADS = 128;

extern "C" int bsx_ed25519_add(const int64_t* x1, const int64_t* y1, const int64_t* z1,
                               const int64_t* t1, const int64_t* x2, const int64_t* y2,
                               const int64_t* z2, const int64_t* t2, int64_t* ox,
                               int64_t* oy, int64_t* oz, int64_t* ot, int n, void* stream) {
  if (n <= 0) return 0;
  edwards_add_kernel<<<(n + ED_THREADS - 1) / ED_THREADS, ED_THREADS, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, t1, x2, y2, z2, t2, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}

extern "C" int bsx_gf25519_pow22523(const int64_t* in, int64_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  pow22523_kernel<<<(n + ED_THREADS - 1) / ED_THREADS, ED_THREADS, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

extern "C" int bsx_gf25519_sqn(const int64_t* in, int64_t* out, int n, int k, void* stream) {
  if (n <= 0) return 0;
  sqn_kernel<<<(n + ED_THREADS - 1) / ED_THREADS, ED_THREADS, 0, (cudaStream_t)stream>>>(in, out, n, k);
  return (int)cudaGetLastError();
}
