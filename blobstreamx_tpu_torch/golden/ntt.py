"""Pure-Python golden model of the radix-2 NTT over Goldilocks.

Defines the canonical transform every device NTT (single-chip Pallas and the
multi-chip six-step all-to-all NTT, SURVEY.md §5.7) must match bit-exactly
(config 4, BASELINE.json:10).

Convention: natural-order in, natural-order out (bit-reversal applied
internally), forward transform evaluates the coefficient vector on the
subgroup generated by ``root_of_unity(log_n)``:

    out[j] = sum_i coeffs[i] * w^(i*j)  with w = root_of_unity(log_n)

The inverse divides by n and uses w^-1. Coset LDE evaluates on
``shift * <w>`` by pre-scaling coefficients with shift^i.
"""

from __future__ import annotations

from .goldilocks import COSET_SHIFT, P, exp, inv, mul, root_of_unity


def bit_reverse_permute(values: list[int]) -> list[int]:
    n = len(values)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n, "length must be a power of two"
    out = [0] * n
    for i in range(n):
        j = int(format(i, f"0{log_n}b")[::-1], 2) if log_n else 0
        out[j] = values[i]
    return out


def ntt(coeffs: list[int]) -> list[int]:
    """Forward NTT, natural order in/out (decimation-in-time)."""
    n = len(coeffs)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    a = bit_reverse_permute([c % P for c in coeffs])
    for stage in range(log_n):
        half = 1 << stage  # butterfly half-span
        w_stage = root_of_unity(stage + 1)
        for start in range(0, n, half * 2):
            w = 1
            for k in range(half):
                lo = a[start + k]
                hi = mul(a[start + k + half], w)
                a[start + k] = (lo + hi) % P
                a[start + k + half] = (lo - hi) % P
                w = mul(w, w_stage)
    return a


def intt(evals: list[int]) -> list[int]:
    """Inverse NTT, natural order in/out."""
    n = len(evals)
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    # Inverse transform = forward with w^-1, scaled by n^-1.
    a = bit_reverse_permute([e % P for e in evals])
    for stage in range(log_n):
        half = 1 << stage
        w_stage = inv(root_of_unity(stage + 1))
        for start in range(0, n, half * 2):
            w = 1
            for k in range(half):
                lo = a[start + k]
                hi = mul(a[start + k + half], w)
                a[start + k] = (lo + hi) % P
                a[start + k + half] = (lo - hi) % P
                w = mul(w, w_stage)
    n_inv = inv(n % P)
    return [mul(x, n_inv) for x in a]


def coset_ntt(coeffs: list[int], shift: int = COSET_SHIFT) -> list[int]:
    """Evaluate on the coset shift*<w>: scale coeff i by shift^i, then NTT."""
    scaled = []
    s = 1
    for c in coeffs:
        scaled.append(mul(c, s))
        s = mul(s, shift)
    return ntt(scaled)


def coset_intt(evals: list[int], shift: int = COSET_SHIFT) -> list[int]:
    coeffs = intt(evals)
    s_inv = inv(shift)
    out = []
    s = 1
    for c in coeffs:
        out.append(mul(c, s))
        s = mul(s, s_inv)
    return out


def lde(coeffs: list[int], rate_bits: int, shift: int = COSET_SHIFT) -> list[int]:
    """Low-degree extension: zero-pad to n*2^rate_bits, coset-evaluate."""
    n = len(coeffs)
    padded = list(coeffs) + [0] * (n * ((1 << rate_bits) - 1))
    return coset_ntt(padded, shift)


def naive_evaluate(coeffs: list[int], points: list[int]) -> list[int]:
    """O(n^2) Horner evaluation — independent cross-check for the NTT itself."""
    out = []
    for x in points:
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % P
        out.append(acc)
    return out


def subgroup(log_n: int, shift: int = 1) -> list[int]:
    w = root_of_unity(log_n)
    pts = []
    cur = shift % P
    for _ in range(1 << log_n):
        pts.append(cur)
        cur = mul(cur, w)
    return pts
