"""The Goldilocks field GF(p), p = 2^64 - 2^32 + 1, and its quadratic
extension GF(p^2) = GF(p)[X] / (X^2 - 7), in plain Python integers.

Parameters follow plonky2: multiplicative generator 7, two-adicity 32,
coset shift 7 for low-degree extensions.
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1
TWO_ADICITY = 32
MULTIPLICATIVE_GENERATOR = 7
POWER_OF_TWO_GENERATOR = pow(MULTIPLICATIVE_GENERATOR, (P - 1) >> TWO_ADICITY, P)
COSET_SHIFT = MULTIPLICATIVE_GENERATOR
EXT_W = 7  # X^2 = 7, a quadratic non-residue mod p

assert pow(EXT_W, (P - 1) // 2, P) == P - 1


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in GF(p)")
    return pow(a, P - 2, P)


def root_of_unity(log_n: int) -> int:
    """The primitive 2^log_n-th root of unity the NTT and the STARK use."""
    if not 0 <= log_n <= TWO_ADICITY:
        raise ValueError(f"log_n={log_n} exceeds two-adicity {TWO_ADICITY}")
    base = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - log_n):
        base = base * base % P
    return base


def ext_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def ext_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def ext_mul(a, b):
    return ((a[0] * b[0] + EXT_W * (a[1] * b[1] % P)) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def ext_inv(a):
    d = (a[0] * a[0] - EXT_W * (a[1] * a[1] % P)) % P
    di = inv(d)
    return (a[0] * di % P, (-a[1]) * di % P)


def ext_exp(a, e: int):
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = ext_mul(result, base)
        base = ext_mul(base, base)
        e >>= 1
    return result
