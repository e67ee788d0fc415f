"""Pure-Python golden model of SHA-512 (FIPS 180-4), needed by Ed25519 (RFC 8032).

Constants derived from prime roots with exact integer arithmetic and
cross-checked against ``hashlib.sha512`` in tests.
"""

from __future__ import annotations

import math
from functools import lru_cache

from .sha256 import _icbrt, _primes

MASK64 = (1 << 64) - 1


@lru_cache(maxsize=None)
def k_constants() -> tuple[int, ...]:
    """K[i] = floor(frac(cbrt(prime_i)) * 2^64)."""
    ks = []
    for p in _primes(80):
        c = _icbrt(p << 192)
        ks.append(c & MASK64)
    return tuple(ks)


@lru_cache(maxsize=None)
def h_constants() -> tuple[int, ...]:
    """H[i] = floor(frac(sqrt(prime_i)) * 2^64)."""
    hs = []
    for p in _primes(8):
        s = math.isqrt(p << 128)
        hs.append(s & MASK64)
    return tuple(hs)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & MASK64


def pad(message: bytes) -> bytes:
    bit_len = len(message) * 8
    padded = message + b"\x80"
    padded += b"\x00" * ((112 - len(padded) % 128) % 128)
    return padded + bit_len.to_bytes(16, "big")


def compress(state: tuple[int, ...], block: bytes) -> tuple[int, ...]:
    assert len(block) == 128
    K = k_constants()
    w = [int.from_bytes(block[i * 8 : i * 8 + 8], "big") for i in range(16)]
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ (w[t - 15] >> 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ (w[t - 2] >> 6)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK64)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        S1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + K[t] + w[t]) & MASK64
        S0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & MASK64
        a, b, c, d, e, f, g, h = (t1 + t2) & MASK64, a, b, c, (d + t1) & MASK64, e, f, g
    return tuple((x + y) & MASK64 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def sha512(message: bytes) -> bytes:
    state = h_constants()
    padded = pad(message)
    for i in range(0, len(padded), 128):
        state = compress(state, padded[i : i + 128])
    return b"".join(x.to_bytes(8, "big") for x in state)
