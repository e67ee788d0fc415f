"""Pure-Python golden model of the Goldilocks field GF(p), p = 2^64 - 2^32 + 1.

This is the spec-derived reference implementation (SURVEY.md §4.3 item 1) against
which every TPU kernel is tested bit-exactly. The mounted reference snapshot
contains no code (SURVEY.md §0), so this golden model *is* the ground truth;
its parameters follow the published plonky2 Goldilocks conventions
(generator 7, two-adicity 32) named in BASELINE.json:5.

Everything here is plain Python integers — no numpy, no JAX — so there is no
shared code (and no shared bugs) with the device implementations in
``blobstreamx_tpu_torch.fields.gf64``.
"""

from __future__ import annotations

P = (1 << 64) - (1 << 32) + 1  # 0xFFFFFFFF_00000001
TWO_ADICITY = 32
MULTIPLICATIVE_GENERATOR = 7  # generates the full multiplicative group

# g^((p-1)/2^32): canonical primitive 2^32-th root of unity.
POWER_OF_TWO_GENERATOR = pow(MULTIPLICATIVE_GENERATOR, (P - 1) >> TWO_ADICITY, P)

# Coset shift used for low-degree extension (LDE): the multiplicative generator.
COSET_SHIFT = MULTIPLICATIVE_GENERATOR


def add(a: int, b: int) -> int:
    return (a + b) % P


def sub(a: int, b: int) -> int:
    return (a - b) % P


def neg(a: int) -> int:
    return (-a) % P


def mul(a: int, b: int) -> int:
    return (a * b) % P


def inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in GF(p)")
    return pow(a, P - 2, P)


def exp(a: int, e: int) -> int:
    return pow(a, e, P)


def root_of_unity(log_n: int) -> int:
    """Primitive 2^log_n-th root of unity (subgroup generator for NTT)."""
    if not 0 <= log_n <= TWO_ADICITY:
        raise ValueError(f"log_n={log_n} exceeds two-adicity {TWO_ADICITY}")
    base = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - log_n):
        base = mul(base, base)
    return base


# ----------------------------------------------------------------------------
# Quadratic extension GF(p^2) = GF(p)[X] / (X^2 - W), W a non-residue.
# Used for FRI soundness (challenges drawn from the extension field).
# W = 7 is a quadratic non-residue mod p (plonky2's choice for Goldilocks).
# ----------------------------------------------------------------------------

EXT_W = 7  # X^2 = 7; 7 is a non-residue: 7^((p-1)/2) == p-1.

assert pow(EXT_W, (P - 1) // 2, P) == P - 1, "EXT_W must be a quadratic non-residue"


def ext_add(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    return (add(a[0], b[0]), add(a[1], b[1]))


def ext_sub(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    return (sub(a[0], b[0]), sub(a[1], b[1]))


def ext_mul(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    # (a0 + a1 X)(b0 + b1 X) = a0 b0 + W a1 b1 + (a0 b1 + a1 b0) X
    c0 = add(mul(a[0], b[0]), mul(EXT_W, mul(a[1], b[1])))
    c1 = add(mul(a[0], b[1]), mul(a[1], b[0]))
    return (c0, c1)


def ext_neg(a: tuple[int, int]) -> tuple[int, int]:
    return (neg(a[0]), neg(a[1]))


def ext_inv(a: tuple[int, int]) -> tuple[int, int]:
    # 1/(a0 + a1 X) = (a0 - a1 X) / (a0^2 - W a1^2)
    d = sub(mul(a[0], a[0]), mul(EXT_W, mul(a[1], a[1])))
    di = inv(d)
    return (mul(a[0], di), mul(neg(a[1]), di))


def ext_exp(a: tuple[int, int], e: int) -> tuple[int, int]:
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = ext_mul(result, base)
        base = ext_mul(base, base)
        e >>= 1
    return result
