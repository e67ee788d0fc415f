"""Pure-Python golden model of SHA-256 (FIPS 180-4).

Round constants and IV are *derived* (fractional parts of cube/square roots of
the first primes, computed with exact integer arithmetic) rather than
hard-coded, and the whole implementation is cross-checked against ``hashlib``
in tests — giving two independent oracles for the device kernel
(blobstreamx_tpu_torch.ops.sha256; config 1 at BASELINE.json:7).
"""

from __future__ import annotations

from functools import lru_cache

MASK32 = 0xFFFFFFFF


def _primes(n: int) -> list[int]:
    out, c = [], 2
    while len(out) < n:
        if all(c % q for q in out if q * q <= c):
            out.append(c)
        c += 1
    return out


def _icbrt(n: int) -> int:
    """Integer cube root via Newton iteration on exact ints."""
    if n == 0:
        return 0
    x = 1 << ((n.bit_length() + 2) // 3)
    while True:
        y = (2 * x + n // (x * x)) // 3
        if y >= x:
            break
        x = y
    return x


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


@lru_cache(maxsize=None)
def k_constants() -> tuple[int, ...]:
    """K[i] = floor(frac(cbrt(prime_i)) * 2^32)."""
    ks = []
    for p in _primes(64):
        c = _icbrt(p << 96)  # floor(cbrt(p) * 2^32)
        ks.append(c & MASK32)
    return tuple(ks)


@lru_cache(maxsize=None)
def h_constants() -> tuple[int, ...]:
    """H[i] = floor(frac(sqrt(prime_i)) * 2^32)."""
    hs = []
    for p in _primes(8):
        s = _isqrt(p << 64)
        hs.append(s & MASK32)
    return tuple(hs)


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & MASK32


def pad(message: bytes) -> bytes:
    bit_len = len(message) * 8
    padded = message + b"\x80"
    padded += b"\x00" * ((56 - len(padded) % 64) % 64)
    return padded + bit_len.to_bytes(8, "big")


def compress(state: tuple[int, ...], block: bytes) -> tuple[int, ...]:
    """One 64-byte block compression. state is 8 u32 words."""
    assert len(block) == 64
    K = k_constants()
    w = [int.from_bytes(block[i * 4 : i * 4 + 4], "big") for i in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
    a, b, c, d, e, f, g, h = state
    for t in range(64):
        S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (h + S1 + ch + K[t] + w[t]) & MASK32
        S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (S0 + maj) & MASK32
        a, b, c, d, e, f, g, h = (t1 + t2) & MASK32, a, b, c, (d + t1) & MASK32, e, f, g
    return tuple((x + y) & MASK32 for x, y in zip(state, (a, b, c, d, e, f, g, h)))


def sha256_pure(message: bytes) -> bytes:
    """The from-scratch FIPS 180-4 model (pad + compress above) — the
    independent oracle the kernel tests check against (SURVEY.md §4.3 item 1).
    ~600x slower than hashlib; use sha256() on any volume path."""
    state = h_constants()
    padded = pad(message)
    for i in range(0, len(padded), 64):
        state = compress(state, padded[i : i + 64])
    return b"".join(x.to_bytes(4, "big") for x in state)


def sha256(message: bytes) -> bytes:
    """hashlib-backed SHA-256 for golden trees / fixtures / witness packing.

    Host witness generation hashes O(headers * validators) messages; the
    pure-python compress put 23.7 s of a 24.3 s 256-header witness build in
    _rotr alone (round-5 profile; VERDICT r4 missing #3). hashlib IS FIPS
    180-4, and test_golden pins sha256_pure == sha256 on spec vectors, so
    the oracle independence the survey demands is preserved."""
    import hashlib

    return hashlib.sha256(message).digest()
