"""Goldilocks field arithmetic in PyTorch: the (lo, hi) u32-pair layout.

A field element x < p = 2^64 - 2^32 + 1 is a pair of int64 tensors
``(lo, hi)``, each holding a u32 word, x = hi*2^32 + lo — the JAX package's
layout, so the two packages compare like with like. PyTorch's CPU uint32 and
uint64 have no add, shift, compare or ``where``, so the words live in int64
and every op masks back to 32 bits; products are taken 32x16 bits at a time
(< 2^48, exact in int64).

Reduction uses 2^64 ≡ EPS = 2^32 - 1 and 2^96 ≡ -1 (mod p). Every exported op
takes and returns canonical values in [0, p): the digests and proof bytes
must be bit-identical to the reference.

All functions work on the device of their inputs. This is the plain version
that the CUDA kernels (ops/ntt.py, ops/poseidon.py) are held against; on the
card the rest of the prover runs these same tensor ops.

Golden oracle: blobstreamx_tpu_torch.golden.goldilocks (pure Python).
"""

from __future__ import annotations

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
M32 = 0xFFFFFFFF
M16 = 0xFFFF
EPS = M32  # 2^32 - 1 ≡ 2^64 (mod p)

# A Goldilocks array is a tuple (lo, hi) of equal-shape int64 tensors.
Gl = tuple


# ----------------------------------------------------------------------------
# encode / decode (host side)
# ----------------------------------------------------------------------------


def from_u64(values, device=None) -> Gl:
    """numpy array (or list of ints) of canonical values -> (lo, hi) pair."""
    v = np.asarray(values, dtype=np.uint64)
    lo = (v & np.uint64(M32)).astype(np.int64)
    hi = (v >> np.uint64(32)).astype(np.int64)
    return torch.from_numpy(lo).to(device), torch.from_numpy(hi).to(device)


def to_u64(x: Gl) -> np.ndarray:
    lo = x[0].detach().cpu().numpy().astype(np.uint64)
    hi = x[1].detach().cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def zeros(shape, device=None) -> Gl:
    return (
        torch.zeros(shape, dtype=torch.int64, device=device),
        torch.zeros(shape, dtype=torch.int64, device=device),
    )


def full(shape, value: int, device=None) -> Gl:
    value %= P
    return (
        torch.full(shape, value & M32, dtype=torch.int64, device=device),
        torch.full(shape, value >> 32, dtype=torch.int64, device=device),
    )


# ----------------------------------------------------------------------------
# reduction
# ----------------------------------------------------------------------------


def _fold(lo, hi) -> Gl:
    """Canonical residue of hi*2^32 + lo, for |lo| < 2^40 and a value in
    (-2^34, 2^65 - 2^32).

    The value is first split into a signed 2^64 carry c in {-1, 0, 1} and a
    64-bit remainder; c*2^64 ≡ c*EPS folds back in without a second carry
    (for c = 1 the remainder is < 2^64 - 2^32; for c = -1 the sum is v + p
    in [0, p)). One conditional subtraction of p then canonicalizes."""
    hi = hi + (lo >> 32)
    lo = lo & M32
    c = hi >> 32
    hi = hi & M32
    lo = lo + c * EPS
    hi = hi + (lo >> 32)
    lo = lo & M32
    ge = ((hi == M32) & (lo >= 1)).to(torch.int64)
    return lo - ge, hi - ge * M32


def _mul32(x, y):
    """x*y for u32 words, as (low word, high word)."""
    y0 = y & M16
    y1 = y >> 16
    t0 = x * y0  # < 2^48
    t1 = x * y1  # < 2^48
    low = (t0 & M32) + ((t1 & M16) << 16)
    high = (t0 >> 32) + (t1 >> 16) + (low >> 32)
    return low & M32, high


def _mul_wide(a: Gl, b: Gl):
    """64x64 -> 128-bit product as four u32 words (n0..n3, little-endian)."""
    ll0, ll1 = _mul32(a[0], b[0])
    lh0, lh1 = _mul32(a[0], b[1])
    hl0, hl1 = _mul32(a[1], b[0])
    hh0, hh1 = _mul32(a[1], b[1])
    n1 = ll1 + lh0 + hl0
    n2 = lh1 + hl1 + hh0 + (n1 >> 32)
    n3 = hh1 + (n2 >> 32)
    return ll0, n1 & M32, n2 & M32, n3


def _reduce128(n0, n1, n2, n3) -> Gl:
    """n0 + n1*2^32 + n2*2^64 + n3*2^96 ≡ (n0 + n1*2^32) + n2*(2^32 - 1) - n3."""
    return _fold(n0 - n3 - n2, n1 + n2)


# ----------------------------------------------------------------------------
# field ops
# ----------------------------------------------------------------------------


def gl_add(a: Gl, b: Gl) -> Gl:
    return _fold(a[0] + b[0], a[1] + b[1])


def gl_sub(a: Gl, b: Gl) -> Gl:
    return _fold(a[0] - b[0], a[1] - b[1])


def gl_neg(a: Gl) -> Gl:
    return _fold(-a[0], -a[1])


def gl_mul(a: Gl, b: Gl) -> Gl:
    return _reduce128(*_mul_wide(a, b))


def gl_square(a: Gl) -> Gl:
    return gl_mul(a, a)


def gl_mul_pow2(a: Gl, k: int) -> Gl:
    """a * 2^k mod p for a static 0 <= k < 32: the top k bits t of the
    shifted value weigh t*2^64 ≡ t*(2^32 - 1)."""
    assert 0 <= k < 32
    if k == 0:
        return a
    t = a[1] >> (32 - k)
    hi = ((a[1] << k) | (a[0] >> (32 - k))) & M32
    lo = (a[0] << k) & M32
    return _fold(lo - t, hi + t)


def gl_pow(a: Gl, e: int) -> Gl:
    """a^e for a static Python-int exponent, by square-and-multiply over its
    bits (least significant first)."""
    assert e >= 0
    result = full(a[0].shape, 1, a[0].device)
    base = a
    while e:
        if e & 1:
            result = gl_mul(result, base)
        e >>= 1
        if e:
            base = gl_square(base)
    return result


def _sq_k(x: Gl, k: int) -> Gl:
    for _ in range(k):
        x = gl_square(x)
    return x


def gl_inv(a: Gl) -> Gl:
    """Fermat inversion a^(p-2) by its addition chain (64 squarings and 8
    multiplies); maps 0 -> 0.

    p - 2 = 0xFFFFFFFE_FFFFFFFF = (2^31 - 1)·2^33 + (2^32 - 1)."""
    t2 = gl_mul(gl_square(a), a)            # a^(2^2 - 1)
    t3 = gl_mul(gl_square(t2), a)           # a^(2^3 - 1)
    t6 = gl_mul(_sq_k(t3, 3), t3)           # a^(2^6 - 1)
    t12 = gl_mul(_sq_k(t6, 6), t6)          # a^(2^12 - 1)
    t24 = gl_mul(_sq_k(t12, 12), t12)       # a^(2^24 - 1)
    t30 = gl_mul(_sq_k(t24, 6), t6)         # a^(2^30 - 1)
    t31 = gl_mul(gl_square(t30), a)         # a^(2^31 - 1)
    t32 = gl_mul(gl_square(t31), a)         # a^(2^32 - 1)
    return gl_mul(_sq_k(t31, 33), t32)      # a^((2^31-1)·2^33 + 2^32 - 1)


def gl_select(mask, a: Gl, b: Gl) -> Gl:
    return torch.where(mask, a[0], b[0]), torch.where(mask, a[1], b[1])


def gl_eq(a: Gl, b: Gl):
    return (a[0] == b[0]) & (a[1] == b[1])


# ----------------------------------------------------------------------------
# GF(p^2) = GF(p)[X]/(X^2 - 7): elements are pairs (c0, c1) of Gl arrays.
# ----------------------------------------------------------------------------

EXT_W = 7


def _w_like(x: Gl) -> Gl:
    return full((), EXT_W, x[0].device)


def ext_add(a, b):
    return gl_add(a[0], b[0]), gl_add(a[1], b[1])


def ext_sub(a, b):
    return gl_sub(a[0], b[0]), gl_sub(a[1], b[1])


def ext_mul(a, b):
    w = _w_like(a[0])
    c0 = gl_add(gl_mul(a[0], b[0]), gl_mul(w, gl_mul(a[1], b[1])))
    c1 = gl_add(gl_mul(a[0], b[1]), gl_mul(a[1], b[0]))
    return c0, c1


def ext_square(a):
    return ext_mul(a, a)


def ext_zeros(shape, device=None):
    return zeros(shape, device), zeros(shape, device)


def ext_full(shape, v: tuple[int, int], device=None):
    return full(shape, v[0], device), full(shape, v[1], device)


def ext_scale(base: Gl, k: tuple[int, int]):
    """Multiply a base-field array by a static ext constant: (k0*b, k1*b)."""
    shape, dev = base[0].shape, base[0].device
    return gl_mul(base, full(shape, k[0], dev)), gl_mul(base, full(shape, k[1], dev))


def ext_scale_ext(a, k: tuple[int, int]):
    """Multiply an ext array by a static ext constant."""
    return ext_mul(a, ext_full(a[0][0].shape, k, a[0][0].device))


def ext_from_base(base: Gl):
    return base, zeros(base[0].shape, base[0].device)


def ext_neg(a):
    return gl_neg(a[0]), gl_neg(a[1])


def ext_select(mask, a, b):
    return gl_select(mask, a[0], b[0]), gl_select(mask, a[1], b[1])


def ext_inv(a):
    """Batched ext inverse: conj(a) / norm(a), norm = c0^2 - W*c1^2 (one
    base-field inversion per lane)."""
    w = _w_like(a[0])
    norm = gl_sub(gl_square(a[0]), gl_mul(w, gl_square(a[1])))
    ninv = gl_inv(norm)
    return gl_mul(a[0], ninv), gl_mul(gl_neg(a[1]), ninv)
