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
// around 9 field multiplies, so by bytes; the pow22523 chain reads and
// writes 256 B per lane around 262 field multiplies, so by operations. At
// the prover's lane counts the add takes about one launch's latency below
// 32768 lanes and is held by its bytes at 32768; the chain is a serial run
// of 262 dependent multiplies, so its time is the latency of one multiply
// times 262.
//
// Field arithmetic: an element is 8 u32 words (radix 2^32) in registers.
// Each operation is one inline-PTX block whose carries run on the carry flag
// (add.cc/addc, sub.cc/subc, mad.lo.cc/madc.hi.cc), so no carry is a C
// compare. Products are summed into one 16-word accumulator, and every
// product's low and high halves go into adjacent words on one chain
// (madc.lo.cc into word k, madc.hi.cc into word k+1): ptxas then issues the
// pair as one IMAD.WIDE.U32 with carry in and out. A row of a multiply is
// two such chains, the even and the odd words of a times one word of b
// (products at words i, i+2, ... and i+1, i+3, ...); a squaring does the 28
// cross products a_i a_j (i < j) the same way, doubles them on one chain and
// adds the 8 squares a_i^2 on one more (36 products instead of 64). Both
// fold the upper 256 bits with 2^256 ≡ 38 (mod p) on two more chains.
// Every chain ends where the value bound says no carry can leave it. On the
// H100 this is 162 SASS instructions a multiply and 130 a squaring, against
// 300 and 181 with each row as a chain of low halves and then one of high
// halves (two instructions a product), 300 and 214 with the multiply in C
// over u64, and 400 for the earlier 4x4 u64 multiply (PERF.md).
//
// Ranges: every input and output of fe_add, fe_sub, fe_mul and fe_sq is any
// value below 2^256 ("semi-reduced", congruent mod p); inputs from the
// prover may be semi-reduced too (the MSM's T coordinates come from f.mul).
// fe_canonical brings a value to [0, p) once, at the store, so every output
// limb is < 2^16 and the value is the canonical representative.
//
// Edwards add: a block is 32 adjacent lanes x 4 roles, warp r doing role r
// for all 32 lanes, so loads and stores stay coalesced along N. First the
// four products: a = (Y1-X1)(Y2-X2) (role 0), b = (Y1+X1)(Y2+X2) (role 1),
// c = T1 2d T2 (role 2, two multiplies), d = 2 Z1 Z2 (role 3); they meet in
// shared memory after one barrier; then role r computes its output
// coordinate: X = (b-a)(d-c), Y = (d+c)(b+a), Z = (d-c)(d+c), T = (b-a)(b+a).
// A thread does 2 or 3 multiplies of the lane's 9, on 8-word values; on the
// H100 that took half the device time of one thread a lane doing all 9 on
// the same arithmetic from 64 to 4096 lanes, and the same at 32768, where
// the bytes bound both (PERF.md).
//
// Power chains: one thread per lane, 32-thread blocks (the chain is
// latency-bound; small blocks spread the lanes over SMs), every squaring on
// fe_sq. Four threads a lane (each a 64-bit row of every product, the rows
// summed and their carries resolved through warp shuffles) was slower
// (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

struct fe {
  uint32_t v[8];
};

// 2d mod p, d = -121665/121666 (the addition law's constant), little-endian words
__device__ __constant__ uint32_t FE_K2D[8] = {0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au,
                                              0xeef3d130u, 0x198e80f2u, 0x56dffce7u, 0x2406d9dcu};

#define FE_OUT(r)                                                                                     \
  "=&r"(r.v[0]), "=&r"(r.v[1]), "=&r"(r.v[2]), "=&r"(r.v[3]), "=&r"(r.v[4]), "=&r"(r.v[5]),       \
      "=&r"(r.v[6]), "=&r"(r.v[7])
#define FE_IN(a) \
  "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7])

// a + b: a + b < 2^257; its carry c adds 38c, and when that carries again
// the 256-bit value is below 38, so the last +38 cannot carry.
__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
  fe r;
  asm("{\n\t"
      ".reg .u32 c;\n\t"
      "add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.cc.u32 %7, %15, %23;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mul.lo.u32 c, c, 38;\n\t"
      "add.cc.u32 %0, %0, c;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.u32 %0, c, 38, %0;\n\t"
      "}"
      : FE_OUT(r)
      : FE_IN(a), FE_IN(b));
  return r;
}

// a - b: on a borrow the words hold a - b + 2^256 ≡ a - b + 38, so 38 comes
// off; a second borrow leaves at least 2^256 - 38, so the last -38 cannot
// borrow.
__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
  fe r;
  asm("{\n\t"
      ".reg .u32 c;\n\t"
      "sub.cc.u32 %0, %8, %16;\n\t"
      "subc.cc.u32 %1, %9, %17;\n\t"
      "subc.cc.u32 %2, %10, %18;\n\t"
      "subc.cc.u32 %3, %11, %19;\n\t"
      "subc.cc.u32 %4, %12, %20;\n\t"
      "subc.cc.u32 %5, %13, %21;\n\t"
      "subc.cc.u32 %6, %14, %22;\n\t"
      "subc.cc.u32 %7, %15, %23;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "and.b32 c, c, 38;\n\t"
      "sub.cc.u32 %0, %0, c;\n\t"
      "subc.cc.u32 %1, %1, 0;\n\t"
      "subc.cc.u32 %2, %2, 0;\n\t"
      "subc.cc.u32 %3, %3, 0;\n\t"
      "subc.cc.u32 %4, %4, 0;\n\t"
      "subc.cc.u32 %5, %5, 0;\n\t"
      "subc.cc.u32 %6, %6, 0;\n\t"
      "subc.cc.u32 %7, %7, 0;\n\t"
      "subc.u32 c, 0, 0;\n\t"
      "and.b32 c, c, 38;\n\t"
      "sub.u32 %0, %0, c;\n\t"
      "}"
      : FE_OUT(r)
      : FE_IN(a), FE_IN(b));
  return r;
}

// a * b. Row i adds a * b_i at word i: first the even words of a (products
// at words i, i+2, i+4, i+6: words i..i+7, carry into the new word i+8;
// row 0 writes fresh words and needs no chain), then the odd ones (words
// i+1..i+8); the sum of rows 0..i is below 2^(32(i+9)), so the odd chain's
// carry out of word i+8 is 0. Then the fold: t_0..7 + 38 t_8..15 <
// 39 * 2^256, its top word c <= 38; adding 38c (<= 1444) can carry once,
// and then the 256-bit value is below 1444, so the last +38 cannot carry.
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
  fe r;
  asm("{\n\t"
      ".reg .u32 t<16>;\n\t"
      ".reg .u32 c;\n\t"
      "mul.lo.u32 t0, %8, %16;\n\t"
      "mul.hi.u32 t1, %8, %16;\n\t"
      "mul.lo.u32 t2, %10, %16;\n\t"
      "mul.hi.u32 t3, %10, %16;\n\t"
      "mul.lo.u32 t4, %12, %16;\n\t"
      "mul.hi.u32 t5, %12, %16;\n\t"
      "mul.lo.u32 t6, %14, %16;\n\t"
      "mul.hi.u32 t7, %14, %16;\n\t"
      "mad.lo.cc.u32 t1, %9, %16, t1;\n\t"
      "madc.hi.cc.u32 t2, %9, %16, t2;\n\t"
      "madc.lo.cc.u32 t3, %11, %16, t3;\n\t"
      "madc.hi.cc.u32 t4, %11, %16, t4;\n\t"
      "madc.lo.cc.u32 t5, %13, %16, t5;\n\t"
      "madc.hi.cc.u32 t6, %13, %16, t6;\n\t"
      "madc.lo.cc.u32 t7, %15, %16, t7;\n\t"
      "madc.hi.u32 t8, %15, %16, 0;\n\t"
      "mad.lo.cc.u32 t1, %8, %17, t1;\n\t"
      "madc.hi.cc.u32 t2, %8, %17, t2;\n\t"
      "madc.lo.cc.u32 t3, %10, %17, t3;\n\t"
      "madc.hi.cc.u32 t4, %10, %17, t4;\n\t"
      "madc.lo.cc.u32 t5, %12, %17, t5;\n\t"
      "madc.hi.cc.u32 t6, %12, %17, t6;\n\t"
      "madc.lo.cc.u32 t7, %14, %17, t7;\n\t"
      "madc.hi.cc.u32 t8, %14, %17, t8;\n\t"
      "addc.u32 t9, 0, 0;\n\t"
      "mad.lo.cc.u32 t2, %9, %17, t2;\n\t"
      "madc.hi.cc.u32 t3, %9, %17, t3;\n\t"
      "madc.lo.cc.u32 t4, %11, %17, t4;\n\t"
      "madc.hi.cc.u32 t5, %11, %17, t5;\n\t"
      "madc.lo.cc.u32 t6, %13, %17, t6;\n\t"
      "madc.hi.cc.u32 t7, %13, %17, t7;\n\t"
      "madc.lo.cc.u32 t8, %15, %17, t8;\n\t"
      "madc.hi.u32 t9, %15, %17, t9;\n\t"
      "mad.lo.cc.u32 t2, %8, %18, t2;\n\t"
      "madc.hi.cc.u32 t3, %8, %18, t3;\n\t"
      "madc.lo.cc.u32 t4, %10, %18, t4;\n\t"
      "madc.hi.cc.u32 t5, %10, %18, t5;\n\t"
      "madc.lo.cc.u32 t6, %12, %18, t6;\n\t"
      "madc.hi.cc.u32 t7, %12, %18, t7;\n\t"
      "madc.lo.cc.u32 t8, %14, %18, t8;\n\t"
      "madc.hi.cc.u32 t9, %14, %18, t9;\n\t"
      "addc.u32 t10, 0, 0;\n\t"
      "mad.lo.cc.u32 t3, %9, %18, t3;\n\t"
      "madc.hi.cc.u32 t4, %9, %18, t4;\n\t"
      "madc.lo.cc.u32 t5, %11, %18, t5;\n\t"
      "madc.hi.cc.u32 t6, %11, %18, t6;\n\t"
      "madc.lo.cc.u32 t7, %13, %18, t7;\n\t"
      "madc.hi.cc.u32 t8, %13, %18, t8;\n\t"
      "madc.lo.cc.u32 t9, %15, %18, t9;\n\t"
      "madc.hi.u32 t10, %15, %18, t10;\n\t"
      "mad.lo.cc.u32 t3, %8, %19, t3;\n\t"
      "madc.hi.cc.u32 t4, %8, %19, t4;\n\t"
      "madc.lo.cc.u32 t5, %10, %19, t5;\n\t"
      "madc.hi.cc.u32 t6, %10, %19, t6;\n\t"
      "madc.lo.cc.u32 t7, %12, %19, t7;\n\t"
      "madc.hi.cc.u32 t8, %12, %19, t8;\n\t"
      "madc.lo.cc.u32 t9, %14, %19, t9;\n\t"
      "madc.hi.cc.u32 t10, %14, %19, t10;\n\t"
      "addc.u32 t11, 0, 0;\n\t"
      "mad.lo.cc.u32 t4, %9, %19, t4;\n\t"
      "madc.hi.cc.u32 t5, %9, %19, t5;\n\t"
      "madc.lo.cc.u32 t6, %11, %19, t6;\n\t"
      "madc.hi.cc.u32 t7, %11, %19, t7;\n\t"
      "madc.lo.cc.u32 t8, %13, %19, t8;\n\t"
      "madc.hi.cc.u32 t9, %13, %19, t9;\n\t"
      "madc.lo.cc.u32 t10, %15, %19, t10;\n\t"
      "madc.hi.u32 t11, %15, %19, t11;\n\t"
      "mad.lo.cc.u32 t4, %8, %20, t4;\n\t"
      "madc.hi.cc.u32 t5, %8, %20, t5;\n\t"
      "madc.lo.cc.u32 t6, %10, %20, t6;\n\t"
      "madc.hi.cc.u32 t7, %10, %20, t7;\n\t"
      "madc.lo.cc.u32 t8, %12, %20, t8;\n\t"
      "madc.hi.cc.u32 t9, %12, %20, t9;\n\t"
      "madc.lo.cc.u32 t10, %14, %20, t10;\n\t"
      "madc.hi.cc.u32 t11, %14, %20, t11;\n\t"
      "addc.u32 t12, 0, 0;\n\t"
      "mad.lo.cc.u32 t5, %9, %20, t5;\n\t"
      "madc.hi.cc.u32 t6, %9, %20, t6;\n\t"
      "madc.lo.cc.u32 t7, %11, %20, t7;\n\t"
      "madc.hi.cc.u32 t8, %11, %20, t8;\n\t"
      "madc.lo.cc.u32 t9, %13, %20, t9;\n\t"
      "madc.hi.cc.u32 t10, %13, %20, t10;\n\t"
      "madc.lo.cc.u32 t11, %15, %20, t11;\n\t"
      "madc.hi.u32 t12, %15, %20, t12;\n\t"
      "mad.lo.cc.u32 t5, %8, %21, t5;\n\t"
      "madc.hi.cc.u32 t6, %8, %21, t6;\n\t"
      "madc.lo.cc.u32 t7, %10, %21, t7;\n\t"
      "madc.hi.cc.u32 t8, %10, %21, t8;\n\t"
      "madc.lo.cc.u32 t9, %12, %21, t9;\n\t"
      "madc.hi.cc.u32 t10, %12, %21, t10;\n\t"
      "madc.lo.cc.u32 t11, %14, %21, t11;\n\t"
      "madc.hi.cc.u32 t12, %14, %21, t12;\n\t"
      "addc.u32 t13, 0, 0;\n\t"
      "mad.lo.cc.u32 t6, %9, %21, t6;\n\t"
      "madc.hi.cc.u32 t7, %9, %21, t7;\n\t"
      "madc.lo.cc.u32 t8, %11, %21, t8;\n\t"
      "madc.hi.cc.u32 t9, %11, %21, t9;\n\t"
      "madc.lo.cc.u32 t10, %13, %21, t10;\n\t"
      "madc.hi.cc.u32 t11, %13, %21, t11;\n\t"
      "madc.lo.cc.u32 t12, %15, %21, t12;\n\t"
      "madc.hi.u32 t13, %15, %21, t13;\n\t"
      "mad.lo.cc.u32 t6, %8, %22, t6;\n\t"
      "madc.hi.cc.u32 t7, %8, %22, t7;\n\t"
      "madc.lo.cc.u32 t8, %10, %22, t8;\n\t"
      "madc.hi.cc.u32 t9, %10, %22, t9;\n\t"
      "madc.lo.cc.u32 t10, %12, %22, t10;\n\t"
      "madc.hi.cc.u32 t11, %12, %22, t11;\n\t"
      "madc.lo.cc.u32 t12, %14, %22, t12;\n\t"
      "madc.hi.cc.u32 t13, %14, %22, t13;\n\t"
      "addc.u32 t14, 0, 0;\n\t"
      "mad.lo.cc.u32 t7, %9, %22, t7;\n\t"
      "madc.hi.cc.u32 t8, %9, %22, t8;\n\t"
      "madc.lo.cc.u32 t9, %11, %22, t9;\n\t"
      "madc.hi.cc.u32 t10, %11, %22, t10;\n\t"
      "madc.lo.cc.u32 t11, %13, %22, t11;\n\t"
      "madc.hi.cc.u32 t12, %13, %22, t12;\n\t"
      "madc.lo.cc.u32 t13, %15, %22, t13;\n\t"
      "madc.hi.u32 t14, %15, %22, t14;\n\t"
      "mad.lo.cc.u32 t7, %8, %23, t7;\n\t"
      "madc.hi.cc.u32 t8, %8, %23, t8;\n\t"
      "madc.lo.cc.u32 t9, %10, %23, t9;\n\t"
      "madc.hi.cc.u32 t10, %10, %23, t10;\n\t"
      "madc.lo.cc.u32 t11, %12, %23, t11;\n\t"
      "madc.hi.cc.u32 t12, %12, %23, t12;\n\t"
      "madc.lo.cc.u32 t13, %14, %23, t13;\n\t"
      "madc.hi.cc.u32 t14, %14, %23, t14;\n\t"
      "addc.u32 t15, 0, 0;\n\t"
      "mad.lo.cc.u32 t8, %9, %23, t8;\n\t"
      "madc.hi.cc.u32 t9, %9, %23, t9;\n\t"
      "madc.lo.cc.u32 t10, %11, %23, t10;\n\t"
      "madc.hi.cc.u32 t11, %11, %23, t11;\n\t"
      "madc.lo.cc.u32 t12, %13, %23, t12;\n\t"
      "madc.hi.cc.u32 t13, %13, %23, t13;\n\t"
      "madc.lo.cc.u32 t14, %15, %23, t14;\n\t"
      "madc.hi.u32 t15, %15, %23, t15;\n\t"
      "mad.lo.cc.u32 %0, t8, 38, t0;\n\t"
      "madc.hi.cc.u32 %1, t8, 38, t1;\n\t"
      "madc.lo.cc.u32 %2, t10, 38, t2;\n\t"
      "madc.hi.cc.u32 %3, t10, 38, t3;\n\t"
      "madc.lo.cc.u32 %4, t12, 38, t4;\n\t"
      "madc.hi.cc.u32 %5, t12, 38, t5;\n\t"
      "madc.lo.cc.u32 %6, t14, 38, t6;\n\t"
      "madc.hi.cc.u32 %7, t14, 38, t7;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.cc.u32 %1, t9, 38, %1;\n\t"
      "madc.hi.cc.u32 %2, t9, 38, %2;\n\t"
      "madc.lo.cc.u32 %3, t11, 38, %3;\n\t"
      "madc.hi.cc.u32 %4, t11, 38, %4;\n\t"
      "madc.lo.cc.u32 %5, t13, 38, %5;\n\t"
      "madc.hi.cc.u32 %6, t13, 38, %6;\n\t"
      "madc.lo.cc.u32 %7, t15, 38, %7;\n\t"
      "madc.hi.u32 c, t15, 38, c;\n\t"
      "mad.lo.cc.u32 %0, c, 38, %0;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.u32 %0, c, 38, %0;\n\t"
      "}"
      : FE_OUT(r)
      : FE_IN(a), FE_IN(b));
  return r;
}

// a * a: the cross products a_i a_j (i < j) row by row as in fe_mul, two
// chains a row (j - i odd, j - i even); their sum is below 2^511 (words
// t_1..t_14), doubled into t_1..t_15 on one chain; then the squares a_i^2
// at words 2i, 2i+1 on one chain (a^2 < 2^512 cannot carry out); the same
// fold as fe_mul.
__device__ __forceinline__ fe fe_sq(const fe& a) {
  fe r;
  asm("{\n\t"
      ".reg .u32 t<16>;\n\t"
      ".reg .u32 c;\n\t"
      "mul.lo.u32 t1, %8, %9;\n\t"
      "mul.hi.u32 t2, %8, %9;\n\t"
      "mul.lo.u32 t3, %8, %11;\n\t"
      "mul.hi.u32 t4, %8, %11;\n\t"
      "mul.lo.u32 t5, %8, %13;\n\t"
      "mul.hi.u32 t6, %8, %13;\n\t"
      "mul.lo.u32 t7, %8, %15;\n\t"
      "mul.hi.u32 t8, %8, %15;\n\t"
      "mad.lo.cc.u32 t2, %8, %10, t2;\n\t"
      "madc.hi.cc.u32 t3, %8, %10, t3;\n\t"
      "madc.lo.cc.u32 t4, %8, %12, t4;\n\t"
      "madc.hi.cc.u32 t5, %8, %12, t5;\n\t"
      "madc.lo.cc.u32 t6, %8, %14, t6;\n\t"
      "madc.hi.cc.u32 t7, %8, %14, t7;\n\t"
      "addc.u32 t8, t8, 0;\n\t"
      "mad.lo.cc.u32 t3, %9, %10, t3;\n\t"
      "madc.hi.cc.u32 t4, %9, %10, t4;\n\t"
      "madc.lo.cc.u32 t5, %9, %12, t5;\n\t"
      "madc.hi.cc.u32 t6, %9, %12, t6;\n\t"
      "madc.lo.cc.u32 t7, %9, %14, t7;\n\t"
      "madc.hi.cc.u32 t8, %9, %14, t8;\n\t"
      "addc.u32 t9, 0, 0;\n\t"
      "mad.lo.cc.u32 t4, %9, %11, t4;\n\t"
      "madc.hi.cc.u32 t5, %9, %11, t5;\n\t"
      "madc.lo.cc.u32 t6, %9, %13, t6;\n\t"
      "madc.hi.cc.u32 t7, %9, %13, t7;\n\t"
      "madc.lo.cc.u32 t8, %9, %15, t8;\n\t"
      "madc.hi.u32 t9, %9, %15, t9;\n\t"
      "mad.lo.cc.u32 t5, %10, %11, t5;\n\t"
      "madc.hi.cc.u32 t6, %10, %11, t6;\n\t"
      "madc.lo.cc.u32 t7, %10, %13, t7;\n\t"
      "madc.hi.cc.u32 t8, %10, %13, t8;\n\t"
      "madc.lo.cc.u32 t9, %10, %15, t9;\n\t"
      "madc.hi.u32 t10, %10, %15, 0;\n\t"
      "mad.lo.cc.u32 t6, %10, %12, t6;\n\t"
      "madc.hi.cc.u32 t7, %10, %12, t7;\n\t"
      "madc.lo.cc.u32 t8, %10, %14, t8;\n\t"
      "madc.hi.cc.u32 t9, %10, %14, t9;\n\t"
      "addc.u32 t10, t10, 0;\n\t"
      "mad.lo.cc.u32 t7, %11, %12, t7;\n\t"
      "madc.hi.cc.u32 t8, %11, %12, t8;\n\t"
      "madc.lo.cc.u32 t9, %11, %14, t9;\n\t"
      "madc.hi.cc.u32 t10, %11, %14, t10;\n\t"
      "addc.u32 t11, 0, 0;\n\t"
      "mad.lo.cc.u32 t8, %11, %13, t8;\n\t"
      "madc.hi.cc.u32 t9, %11, %13, t9;\n\t"
      "madc.lo.cc.u32 t10, %11, %15, t10;\n\t"
      "madc.hi.u32 t11, %11, %15, t11;\n\t"
      "mad.lo.cc.u32 t9, %12, %13, t9;\n\t"
      "madc.hi.cc.u32 t10, %12, %13, t10;\n\t"
      "madc.lo.cc.u32 t11, %12, %15, t11;\n\t"
      "madc.hi.u32 t12, %12, %15, 0;\n\t"
      "mad.lo.cc.u32 t10, %12, %14, t10;\n\t"
      "madc.hi.cc.u32 t11, %12, %14, t11;\n\t"
      "addc.u32 t12, t12, 0;\n\t"
      "mad.lo.cc.u32 t11, %13, %14, t11;\n\t"
      "madc.hi.cc.u32 t12, %13, %14, t12;\n\t"
      "addc.u32 t13, 0, 0;\n\t"
      "mad.lo.cc.u32 t12, %13, %15, t12;\n\t"
      "madc.hi.u32 t13, %13, %15, t13;\n\t"
      "mad.lo.cc.u32 t13, %14, %15, t13;\n\t"
      "madc.hi.u32 t14, %14, %15, 0;\n\t"
      "add.cc.u32 t1, t1, t1;\n\t"
      "addc.cc.u32 t2, t2, t2;\n\t"
      "addc.cc.u32 t3, t3, t3;\n\t"
      "addc.cc.u32 t4, t4, t4;\n\t"
      "addc.cc.u32 t5, t5, t5;\n\t"
      "addc.cc.u32 t6, t6, t6;\n\t"
      "addc.cc.u32 t7, t7, t7;\n\t"
      "addc.cc.u32 t8, t8, t8;\n\t"
      "addc.cc.u32 t9, t9, t9;\n\t"
      "addc.cc.u32 t10, t10, t10;\n\t"
      "addc.cc.u32 t11, t11, t11;\n\t"
      "addc.cc.u32 t12, t12, t12;\n\t"
      "addc.cc.u32 t13, t13, t13;\n\t"
      "addc.cc.u32 t14, t14, t14;\n\t"
      "addc.u32 t15, 0, 0;\n\t"
      "mad.lo.cc.u32 t0, %8, %8, 0;\n\t"
      "madc.hi.cc.u32 t1, %8, %8, t1;\n\t"
      "madc.lo.cc.u32 t2, %9, %9, t2;\n\t"
      "madc.hi.cc.u32 t3, %9, %9, t3;\n\t"
      "madc.lo.cc.u32 t4, %10, %10, t4;\n\t"
      "madc.hi.cc.u32 t5, %10, %10, t5;\n\t"
      "madc.lo.cc.u32 t6, %11, %11, t6;\n\t"
      "madc.hi.cc.u32 t7, %11, %11, t7;\n\t"
      "madc.lo.cc.u32 t8, %12, %12, t8;\n\t"
      "madc.hi.cc.u32 t9, %12, %12, t9;\n\t"
      "madc.lo.cc.u32 t10, %13, %13, t10;\n\t"
      "madc.hi.cc.u32 t11, %13, %13, t11;\n\t"
      "madc.lo.cc.u32 t12, %14, %14, t12;\n\t"
      "madc.hi.cc.u32 t13, %14, %14, t13;\n\t"
      "madc.lo.cc.u32 t14, %15, %15, t14;\n\t"
      "madc.hi.u32 t15, %15, %15, t15;\n\t"
      "mad.lo.cc.u32 %0, t8, 38, t0;\n\t"
      "madc.hi.cc.u32 %1, t8, 38, t1;\n\t"
      "madc.lo.cc.u32 %2, t10, 38, t2;\n\t"
      "madc.hi.cc.u32 %3, t10, 38, t3;\n\t"
      "madc.lo.cc.u32 %4, t12, 38, t4;\n\t"
      "madc.hi.cc.u32 %5, t12, 38, t5;\n\t"
      "madc.lo.cc.u32 %6, t14, 38, t6;\n\t"
      "madc.hi.cc.u32 %7, t14, 38, t7;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.cc.u32 %1, t9, 38, %1;\n\t"
      "madc.hi.cc.u32 %2, t9, 38, %2;\n\t"
      "madc.lo.cc.u32 %3, t11, 38, %3;\n\t"
      "madc.hi.cc.u32 %4, t11, 38, %4;\n\t"
      "madc.lo.cc.u32 %5, t13, 38, %5;\n\t"
      "madc.hi.cc.u32 %6, t13, 38, %6;\n\t"
      "madc.lo.cc.u32 %7, t15, 38, %7;\n\t"
      "madc.hi.u32 c, t15, 38, c;\n\t"
      "mad.lo.cc.u32 %0, c, 38, %0;\n\t"
      "addc.cc.u32 %1, %1, 0;\n\t"
      "addc.cc.u32 %2, %2, 0;\n\t"
      "addc.cc.u32 %3, %3, 0;\n\t"
      "addc.cc.u32 %4, %4, 0;\n\t"
      "addc.cc.u32 %5, %5, 0;\n\t"
      "addc.cc.u32 %6, %6, 0;\n\t"
      "addc.cc.u32 %7, %7, 0;\n\t"
      "addc.u32 c, 0, 0;\n\t"
      "mad.lo.u32 %0, c, 38, %0;\n\t"
      "}"
      : FE_OUT(r)
      : FE_IN(a));
  return r;
}

__device__ __forceinline__ fe fe_sqn(fe a, int k) {
#pragma unroll 1
  for (int i = 0; i < k; i++) a = fe_sq(a);
  return a;
}

// The representative in [0, p) of a value below 2^256: fold bit 255 as 19
// (x' = x mod 2^255 + 19 x_255 < 2^255 + 19), then x' - p = x' + 19 - 2^255
// when x' + 19 reaches 2^255 (bit 255 of y = x' + 19 set), else x'.
__device__ __forceinline__ fe fe_canonical(const fe& a) {
  fe r;
  asm("{\n\t"
      ".reg .u32 c;\n\t"
      ".reg .u32 y<8>;\n\t"
      ".reg .pred q;\n\t"
      "shr.u32 c, %15, 31;\n\t"
      "mul.lo.u32 c, c, 19;\n\t"
      "and.b32 %7, %15, 0x7fffffff;\n\t"
      "add.cc.u32 %0, %8, c;\n\t"
      "addc.cc.u32 %1, %9, 0;\n\t"
      "addc.cc.u32 %2, %10, 0;\n\t"
      "addc.cc.u32 %3, %11, 0;\n\t"
      "addc.cc.u32 %4, %12, 0;\n\t"
      "addc.cc.u32 %5, %13, 0;\n\t"
      "addc.cc.u32 %6, %14, 0;\n\t"
      "addc.u32 %7, %7, 0;\n\t"
      "add.cc.u32 y0, %0, 19;\n\t"
      "addc.cc.u32 y1, %1, 0;\n\t"
      "addc.cc.u32 y2, %2, 0;\n\t"
      "addc.cc.u32 y3, %3, 0;\n\t"
      "addc.cc.u32 y4, %4, 0;\n\t"
      "addc.cc.u32 y5, %5, 0;\n\t"
      "addc.cc.u32 y6, %6, 0;\n\t"
      "addc.u32 y7, %7, 0;\n\t"
      "shr.u32 c, y7, 31;\n\t"
      "setp.ne.u32 q, c, 0;\n\t"
      "and.b32 y7, y7, 0x7fffffff;\n\t"
      "selp.b32 %0, y0, %0, q;\n\t"
      "selp.b32 %1, y1, %1, q;\n\t"
      "selp.b32 %2, y2, %2, q;\n\t"
      "selp.b32 %3, y3, %3, q;\n\t"
      "selp.b32 %4, y4, %4, q;\n\t"
      "selp.b32 %5, y5, %5, q;\n\t"
      "selp.b32 %6, y6, %6, q;\n\t"
      "selp.b32 %7, y7, %7, q;\n\t"
      "}"
      : FE_OUT(r)
      : FE_IN(a));
  return r;
}

// 16 limbs of 16 bits, (16, N) int64 read along N -> 8 words; each limb's
// low 16 bits are taken (byte_perm 0x5410: the low halves of two limbs).
__device__ __forceinline__ fe fe_load(const int64_t* __restrict__ limbs, int n, int j) {
  fe r;
#pragma unroll
  for (int k = 0; k < 8; k++)
    r.v[k] = __byte_perm((uint32_t)limbs[(size_t)(2 * k) * n + j], (uint32_t)limbs[(size_t)(2 * k + 1) * n + j],
                         0x5410);
  return r;
}

__device__ __forceinline__ void fe_store(int64_t* __restrict__ limbs, int n, int j, const fe& a) {
  const fe c = fe_canonical(a);
#pragma unroll
  for (int k = 0; k < 8; k++) {
    limbs[(size_t)(2 * k) * n + j] = (int64_t)(c.v[k] & 0xFFFFu);
    limbs[(size_t)(2 * k + 1) * n + j] = (int64_t)(c.v[k] >> 16);
  }
}

static const int ADD_LANES = 32;  // lanes a block; its 4 warps are the 4 roles

__global__ void __launch_bounds__(4 * ADD_LANES)
    edwards_add_kernel(const int64_t* __restrict__ x1, const int64_t* __restrict__ y1,
                       const int64_t* __restrict__ z1, const int64_t* __restrict__ t1,
                       const int64_t* __restrict__ x2, const int64_t* __restrict__ y2,
                       const int64_t* __restrict__ z2, const int64_t* __restrict__ t2,
                       int64_t* __restrict__ ox, int64_t* __restrict__ oy,
                       int64_t* __restrict__ oz, int64_t* __restrict__ ot, int n) {
  __shared__ uint32_t abcd[4][8][ADD_LANES];  // a, b, c, d, word k of lane l at [.][k][l]
  const int lane = threadIdx.x % ADD_LANES, role = threadIdx.x / ADD_LANES;
  const int j = blockIdx.x * ADD_LANES + lane;
  const int jl = min(j, n - 1);  // a ragged block's spare lanes read the last lane and store nothing
  fe p;
  if (role == 0) {
    p = fe_mul(fe_sub(fe_load(y1, n, jl), fe_load(x1, n, jl)), fe_sub(fe_load(y2, n, jl), fe_load(x2, n, jl)));
  } else if (role == 1) {
    p = fe_mul(fe_add(fe_load(y1, n, jl), fe_load(x1, n, jl)), fe_add(fe_load(y2, n, jl), fe_load(x2, n, jl)));
  } else if (role == 2) {
    fe k2d;
#pragma unroll
    for (int k = 0; k < 8; k++) k2d.v[k] = FE_K2D[k];
    p = fe_mul(fe_mul(fe_load(t1, n, jl), k2d), fe_load(t2, n, jl));
  } else {
    const fe z = fe_load(z1, n, jl);
    p = fe_mul(fe_add(z, z), fe_load(z2, n, jl));
  }
#pragma unroll
  for (int k = 0; k < 8; k++) abcd[role][k][lane] = p.v[k];
  __syncthreads();
  fe a, b, c, d;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    a.v[k] = abcd[0][k][lane];
    b.v[k] = abcd[1][k][lane];
    c.v[k] = abcd[2][k][lane];
    d.v[k] = abcd[3][k][lane];
  }
  fe u, w;
  int64_t* out;
  if (role == 0) {
    u = fe_sub(b, a), w = fe_sub(d, c), out = ox;  // X = e f
  } else if (role == 1) {
    u = fe_add(d, c), w = fe_add(b, a), out = oy;  // Y = g h
  } else if (role == 2) {
    u = fe_sub(d, c), w = fe_add(d, c), out = oz;  // Z = f g
  } else {
    u = fe_sub(b, a), w = fe_add(b, a), out = ot;  // T = e h
  }
  const fe o = fe_mul(u, w);
  if (j < n) fe_store(out, n, j, o);
}

// z^(2^252 - 3) by the classic curve25519 addition chain: 251 squarings and
// 11 multiplies
__global__ void pow22523_kernel(const int64_t* __restrict__ in, int64_t* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const fe z = fe_load(in, n, j);
  const fe z2 = fe_sq(z);
  const fe z9 = fe_mul(fe_sqn(z2, 2), z);
  const fe z11 = fe_mul(z9, z2);
  const fe z_5 = fe_mul(fe_sq(z11), z9);
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

// An empty kernel: one launch through this library's C interface, the
// yardstick chip_smoke.py and kernel_report.py time beside the kernels above.
__global__ void launch_floor_kernel() {}

static const int CHAIN_THREADS = 32;

extern "C" int bsx_ed25519_add(const int64_t* x1, const int64_t* y1, const int64_t* z1,
                               const int64_t* t1, const int64_t* x2, const int64_t* y2,
                               const int64_t* z2, const int64_t* t2, int64_t* ox,
                               int64_t* oy, int64_t* oz, int64_t* ot, int n, void* stream) {
  if (n <= 0) return 0;
  edwards_add_kernel<<<(n + ADD_LANES - 1) / ADD_LANES, 4 * ADD_LANES, 0, (cudaStream_t)stream>>>(
      x1, y1, z1, t1, x2, y2, z2, t2, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}

extern "C" int bsx_gf25519_pow22523(const int64_t* in, int64_t* out, int n, void* stream) {
  if (n <= 0) return 0;
  pow22523_kernel<<<(n + CHAIN_THREADS - 1) / CHAIN_THREADS, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

extern "C" int bsx_gf25519_sqn(const int64_t* in, int64_t* out, int n, int k, void* stream) {
  if (n <= 0) return 0;
  sqn_kernel<<<(n + CHAIN_THREADS - 1) / CHAIN_THREADS, CHAIN_THREADS, 0, (cudaStream_t)stream>>>(in, out, n, k);
  return (int)cudaGetLastError();
}

extern "C" int bsx_launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
