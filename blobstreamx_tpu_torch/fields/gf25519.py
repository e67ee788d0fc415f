"""GF(2^255 - 19) arithmetic in PyTorch for Ed25519 batch verification.

Representation (the JAX package's): a field element batch is one int64
tensor of shape ``(16, N)`` — sixteen 16-bit limbs (little-endian) per lane,
value < 2^256. Values are *semi-reduced* (< 2^256, possibly >= p) through
arithmetic; ``canonicalize`` produces the unique representative < p for
encoding and equality.

Multiplication: a (16, 16, N) tensor of exact 16x16 -> 32-bit partial
products, anti-diagonal accumulation into 16-bit columns, and a fold of the
512-bit product with 2^256 ≡ 38 (mod p). The plain functions reproduce the
JAX package's limbs exactly.

``sqn`` and ``pow22523`` are the power-chain entry points: on a CUDA tensor
they launch the power-chain kernel (csrc/ed25519.cu), which returns the
canonical value; on a CPU tensor they run the plain chains.

Golden oracle: python bigints + blobstreamx_tpu_torch.golden.ed25519.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from blobstreamx_tpu_torch import kernels
from blobstreamx_tpu_torch.device import on_cuda

Q = (1 << 255) - 19
M16 = 0xFFFF
NLIMB = 16

_Q_LIMBS = np.array([(Q >> (16 * i)) & 0xFFFF for i in range(NLIMB)], dtype=np.int64)
_FOURP_LO = np.array(
    [((((1 << 257) - 76) - (1 << 256)) >> (16 * i)) & 0xFFFF for i in range(NLIMB)],
    dtype=np.int64,
)


# ----------------------------------------------------------------------------
# encode / decode (host)
# ----------------------------------------------------------------------------


def from_int(values, device=None) -> torch.Tensor:
    """ints (each < 2^256) -> (16, N) int64 limb tensor on `device`."""
    if isinstance(values, int):
        values = [values]
    out = np.zeros((NLIMB, len(values)), dtype=np.int64)
    for j, v in enumerate(values):
        for i in range(NLIMB):
            out[i, j] = (v >> (16 * i)) & 0xFFFF
    return torch.from_numpy(out).to(device)


def to_int(x) -> list[int]:
    arr = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    out = []
    for j in range(arr.shape[1]):
        v = 0
        for i in range(NLIMB):
            v |= int(arr[i, j]) << (16 * i)
        out.append(v)
    return out


def zeros(n: int, device=None) -> torch.Tensor:
    return torch.zeros((NLIMB, n), dtype=torch.int64, device=device)


@lru_cache(maxsize=None)
def _const_col(value: int, device: str) -> torch.Tensor:
    return from_int(value % (1 << 256), device)


def full(n: int, value: int, device=None) -> torch.Tensor:
    return _const_col(value, str(torch.device(device) if device is not None else "cpu")).expand(NLIMB, n)


@lru_cache(maxsize=None)
def _table_col(name: str, device: str) -> torch.Tensor:
    return torch.from_numpy({"q": _Q_LIMBS, "fourp": _FOURP_LO}[name]).to(device)[:, None]


# ----------------------------------------------------------------------------
# carry machinery
# ----------------------------------------------------------------------------


def _propagate(cols):
    """cols: (K, N) columns -> (words (K, N) < 2^16, carry (N,))."""
    carry = torch.zeros_like(cols[0])
    outs = []
    for i in range(cols.shape[0]):
        tot = cols[i] + carry
        outs.append(tot & M16)
        carry = tot >> 16
    return torch.stack(outs), carry


def _add_at0(cols, v):
    out = cols.clone()
    out[0] = out[0] + v
    return out


def _fold_overflow(words, over):
    """(words (16,N) < 2^16) + over*2^256 mod p, semi-reduced < 2^256.

    38*over lands in columns 0 and 1; the fold's own carries are re-folded
    twice (after the first re-fold the value is < 2^256 + 38, and when that
    carries again the rest is < 38, so the final add cannot carry)."""
    add = over * 38
    cols = words.clone()
    cols[0] = cols[0] + (add & M16)
    cols[1] = cols[1] + (add >> 16)
    words2, c1 = _propagate(cols)
    words3, c2 = _propagate(_add_at0(words2, c1 * 38))
    return _add_at0(words3, c2 * 38)


# ----------------------------------------------------------------------------
# field ops
# ----------------------------------------------------------------------------


def add(a, b):
    words, over = _propagate(a + b)
    return _fold_overflow(words, over)


def sub(a, b):
    """a - b via a + (4p - 2^256) + (2^256 - b), all columns nonnegative."""
    cols = a + _table_col("fourp", str(a.device)) + (M16 - b)
    cols = _add_at0(cols, 1)
    words, over = _propagate(cols)
    return _fold_overflow(words, over)


def neg(a):
    return sub(torch.zeros_like(a), a)


def mul(a, b):
    # exact partial products: (16, 16, N); p[i, j] = a[i] * b[j]
    p = a[:, None, :] * b[None, :, :]
    plo = p & M16
    phi = p >> 16
    cols = torch.zeros((2 * NLIMB + 1, a.shape[1]), dtype=torch.int64, device=a.device)
    for i in range(NLIMB):
        cols[i : i + NLIMB] += plo[i]
        cols[i + 1 : i + 1 + NLIMB] += phi[i]
    words, _carry = _propagate(cols)  # carry provably 0 (< 2^512)
    # fold hi (words[16..32]) * 38 into lo
    ph = words[NLIMB : 2 * NLIMB] * 38
    cols2 = words[:NLIMB] + (ph & M16)
    cols2[1:] += (ph >> 16)[: NLIMB - 1]
    over_hi = ph[NLIMB - 1] >> 16  # weight 2^256
    words2, carry = _propagate(cols2)
    return _fold_overflow(words2, carry + over_hi)


def mul_small(a, k: int):
    """a * k for a small static constant 0 < k < 2^15 (one carry pass)."""
    assert 0 < k < (1 << 15)
    words, over = _propagate(a * k)
    return _fold_overflow(words, over)


def canonicalize(x):
    """Unique representative < p (subtract p up to two times, branchless)."""
    q = _table_col("q", str(x.device))
    out = x
    for _ in range(2):
        borrow = torch.zeros_like(out[0])
        diffs = []
        for i in range(NLIMB):
            d = out[i] - q[i] - borrow
            diffs.append(d & M16)
            borrow = (d < 0).to(torch.int64)
        out = torch.where((borrow == 0)[None, :], torch.stack(diffs), out)
    return out


def eq(a, b):
    return (canonicalize(a) == canonicalize(b)).all(dim=0)


def is_zero(a):
    return (canonicalize(a) == 0).all(dim=0)


def select(mask, a, b):
    return torch.where(mask[None, :], a, b)


# ----------------------------------------------------------------------------
# power chains (the power-chain kernel on CUDA tensors)
# ----------------------------------------------------------------------------


def pow_static(a, e: int):
    """a^e for a static Python-int exponent by generic square-and-multiply
    over its bits (least significant first); pow22523 and inv use addition
    chains instead."""
    result = full(a.shape[1], 1, a.device).contiguous()
    base = a
    for i in range(max(e.bit_length(), 1)):
        if (e >> i) & 1:
            result = mul(result, base)
        base = mul(base, base)
    return result


def sqn_plain(a, k: int):
    for _ in range(k):
        a = mul(a, a)
    return a


def _chain_250(z, sqn_fn):
    """z^(2^250 - 1) by the classic curve25519 addition chain, plus the
    intermediates (z9, z11, z_50 = z^(2^50-1)) later steps reuse."""
    z2 = mul(z, z)
    z9 = mul(sqn_fn(z2, 2), z)  # z^9
    z11 = mul(z9, z2)  # z^11
    z_5 = mul(mul(z11, z11), z9)  # z^(2^5 - 1)
    z_10 = mul(sqn_fn(z_5, 5), z_5)  # z^(2^10 - 1)
    z_20 = mul(sqn_fn(z_10, 10), z_10)
    z_40 = mul(sqn_fn(z_20, 20), z_20)
    z_50 = mul(sqn_fn(z_40, 10), z_10)
    z_100 = mul(sqn_fn(z_50, 50), z_50)
    z_200 = mul(sqn_fn(z_100, 100), z_100)
    z_250 = mul(sqn_fn(z_200, 50), z_50)
    return z_250, z9, z11, z_50


def pow22523_plain(z):
    """z^(2^252 - 3) = z^((q-5)/8), the plain version of the chain."""
    z_250, _z9, _z11, _z50 = _chain_250(z, sqn_plain)
    return mul(sqn_plain(z_250, 2), z)


def _chain_cuda(a, k: int | None):
    a = a.contiguous()
    if a.dtype != torch.int64 or a.dim() != 2 or a.shape[0] != NLIMB:
        raise ValueError("expected a (16, N) int64 limb tensor")
    n = a.shape[1]
    out = torch.empty_like(a)
    lib = kernels.load("ed25519")
    with torch.cuda.device(a.device):
        if k is None:
            rc = lib.bsx_gf25519_pow22523(a.data_ptr(), out.data_ptr(), n, kernels.stream_of(a))
        else:
            rc = lib.bsx_gf25519_sqn(a.data_ptr(), out.data_ptr(), n, k, kernels.stream_of(a))
    kernels.check(rc, "power-chain kernel")
    kernels.count("pow_chain")
    return out


def sqn(a, k: int):
    """a^(2^k): k squarings (one kernel launch on CUDA tensors)."""
    if on_cuda(a):
        return _chain_cuda(a, k)
    return sqn_plain(a, k)


def pow22523(z):
    """z^(2^252 - 3), the square-root chain (~254 muls): one kernel launch on
    CUDA tensors, the plain chain on CPU tensors (equal field values)."""
    if on_cuda(z):
        return _chain_cuda(z, None)
    return pow22523_plain(z)


def inv(a):
    """a^(q-2) = a^(2^255 - 21) by the addition chain (~254 muls)."""
    z_250, _z9, z11, _z50 = _chain_250(a, sqn)
    return mul(sqn(z_250, 5), z11)
