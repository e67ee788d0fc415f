"""A plain Goldilocks NTT in NumPy: radix-2 decimation in time over uint64
words, natural order in and out.

forward: X[k] = sum_j x[j] w^(jk), w the primitive 2^log_n-th root of unity
of ``goldilocks.root_of_unity``; inverse: x[j] = n^-1 sum_k X[k] w^(-jk).
Every value in and out is canonical, in [0, p).
"""

from __future__ import annotations

import numpy as np

from .goldilocks import P, inv, root_of_unity

_P = np.uint64(P)
_EPS = np.uint64(0xFFFFFFFF)  # 2^64 mod p
_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def _canon(x: np.ndarray) -> np.ndarray:
    return np.where(x >= _P, x - _P, x)


def add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    s = a + b
    s = np.where(s < a, s + _EPS, s)  # a carry out of 2^64 is worth 2^64 mod p
    return _canon(s)


def sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return np.where(a < b, d + _P, d)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b mod p: the 128-bit product from four 32 x 32-bit products,
    reduced with 2^64 = 2^32 - 1 and 2^96 = -1 (mod p)."""
    a0, a1 = a & _M32, a >> _S32
    b0, b1 = b & _M32, b >> _S32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = p01 + p10
    mid_carry = (mid < p01).astype(np.uint64)
    lo = p00 + (mid << _S32)
    lo_carry = (lo < p00).astype(np.uint64)
    hi = p11 + (mid >> _S32) + (mid_carry << _S32) + lo_carry
    hi_hi, hi_lo = hi >> _S32, hi & _M32
    t0 = lo - hi_hi
    t0 = np.where(lo < hi_hi, t0 - _EPS, t0)
    t1 = hi_lo * _EPS
    t2 = t0 + t1
    t2 = np.where(t2 < t1, t2 + _EPS, t2)
    return _canon(t2)


def _powers(w: int, count: int) -> np.ndarray:
    out = np.ones(count, dtype=np.uint64)
    if count > 1:
        out[1] = w
    k = 2
    while k < count:
        step = min(k, count - k)
        out[k : k + step] = mul(out[:step], np.full(step, pow(w, k, P), dtype=np.uint64))
        k += step
    return out


def _bitrev(log_n: int) -> np.ndarray:
    idx = np.arange(1 << log_n)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


def ntt(x: np.ndarray, inverse: bool = False, mul=mul) -> np.ndarray:
    """The NTT of one polynomial of 2^k canonical uint64 coefficients
    (`mul` multiplies the butterflies' operands; the default is exact)."""
    x = np.asarray(x, dtype=np.uint64)
    n = x.shape[0]
    log_n = n.bit_length() - 1
    if n != 1 << log_n:
        raise ValueError(f"length {n} is not a power of two")
    w = root_of_unity(log_n)
    if inverse:
        w = inv(w)
    table = _powers(w, max(n // 2, 1))
    a = x[_bitrev(log_n)]
    half = 1
    while half < n:
        blocks = a.reshape(n // (2 * half), 2, half)
        tw = table[:: n // (2 * half)][:half]
        u = blocks[:, 0, :]
        v = mul(blocks[:, 1, :], tw[None, :])
        a = np.stack([add(u, v), sub(u, v)], axis=1).reshape(n)
        half *= 2
    if inverse:
        a = mul(a, np.full(n, inv(n), dtype=np.uint64))
    return a


def naive(x: list[int], inverse: bool = False) -> list[int]:
    """The same transform by its definition, O(n^2), for small n."""
    n = len(x)
    w = root_of_unity(n.bit_length() - 1)
    if inverse:
        w = inv(w)
    out = [sum(int(xj) * pow(w, j * k, P) for j, xj in enumerate(x)) % P for k in range(n)]
    if inverse:
        n_inv = inv(n)
        out = [v * n_inv % P for v in out]
    return out
