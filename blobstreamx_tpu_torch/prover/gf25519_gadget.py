"""In-AIR GF(2^255 - 19) arithmetic gadgets of the Ed25519 auxiliary STARK
(prover.ed_air): one field multiplication, and one unified Edwards addition
as a row of nine of them.

Representation: a field element is 16 little-endian 16-bit limbs (a loose
representative < 2^256; values produced by gadgets are canonical < q).
Multiplication operands may be LINEAR COMBINATIONS of row values — limbs are
then small signed integers (|limb| < 2^17 covers sums/differences of two
elements), which is what makes a whole Edwards group operation expressible
with 9 multiplications and no standalone add/sub gadgets.

One multiplication c = a*b (mod q), q = 2^255 - 19, is witnessed as

    a * b  =  (Q_enc - 2^271) * q + c        over the integers,

with Q_enc a 17-limb offset-encoded signed quotient and c the canonical
remainder, checked limb-column-wise with offset-encoded signed carries:

    t_k := conv_k(a, b) - conv_k(Q_enc, q) + OFFCONST_k - c_k + r_{k-1}
    t_k == r_k * 2^16,        r_32 == 0

where conv_k(x, y) = sum_{i+j=k} x_i y_j and OFFCONST_k = conv_k(2^271, q).
Carries r_k are encoded cl_k + 2^16 ch_k - 2^31 with cl, ch in [0, 2^16)
(range-checked via ONE shared logUp table, prover.lookup). Magnitudes:
|conv_k| < 16*2^34, |r_k 2^16| < 2^48 — far below p/2, so per-limb
Goldilocks equality implies integer equality, and telescoping the 33 limb
equations implies the integer identity. All constraints are degree <= 2 in
trace values (operands of degree 1 keep the product at degree 2).

Column budget: 16(c) + 17(Q) + 33(cl) + 33(ch) = 99 witness columns per
multiplication (+ operand columns, which Edwards ops share).
"""

from __future__ import annotations

import numpy as np

from blobstreamx_tpu_torch.golden import ed25519 as ged

Q255 = ged.Q  # 2^255 - 19
N_LIMBS = 16
N_QLIMBS = 17
N_CARRY = 33  # limb equations k = 0..32 (conv(Q, q) reaches k = 32)
CARRY_OFFSET = 1 << 31  # signed-carry bias
Q_OFFSET = 1 << 271  # signed-quotient bias (Q_enc = Q + 2^271, 17 limbs)

Q_LIMBS = [(Q255 >> (16 * i)) & 0xFFFF for i in range(N_LIMBS)]
QOFF_LIMBS = [(Q_OFFSET >> (16 * i)) & 0xFFFF for i in range(N_QLIMBS)]


def to_limbs(v: int, n: int = N_LIMBS) -> list[int]:
    assert v >= 0
    return [(v >> (16 * i)) & 0xFFFF for i in range(n)]


def from_limbs(limbs) -> int:
    return sum(int(l) << (16 * i) for i, l in enumerate(limbs))


def _conv_int(x, y, k: int) -> int:
    return sum(int(x[i]) * int(y[k - i]) for i in range(len(x)) if 0 <= k - i < len(y))


OFFCONST = [_conv_int(QOFF_LIMBS, Q_LIMBS, k) for k in range(N_CARRY)]


class MulWitness:
    """Witness for one multiplication c = a*b mod q where a, b are given as
    SIGNED limb vectors (linear combinations of row values). c is the
    canonical remainder in [0, q)."""

    def __init__(self, a_limbs, b_limbs):
        self.a_limbs = [int(v) for v in a_limbs]
        self.b_limbs = [int(v) for v in b_limbs]
        assert len(self.a_limbs) == N_LIMBS and len(self.b_limbs) == N_LIMBS
        assert all(abs(v) < (1 << 18) for v in self.a_limbs + self.b_limbs)
        a = sum(v << (16 * i) for i, v in enumerate(self.a_limbs))
        b = sum(v << (16 * i) for i, v in enumerate(self.b_limbs))
        prod = a * b
        q_int = prod // Q255  # floor division: c in [0, q) even for prod < 0
        self.c = prod - q_int * Q255
        assert 0 <= self.c < Q255
        q_enc = q_int + Q_OFFSET
        assert 0 <= q_enc < (1 << (16 * N_QLIMBS)), "quotient out of range"
        self.c_limbs = to_limbs(self.c)
        self.q_limbs = to_limbs(q_enc, N_QLIMBS)
        self.cl = []
        self.ch = []
        r_prev = 0
        for k in range(N_CARRY):
            t = (
                _conv_int(self.a_limbs, self.b_limbs, k)
                - _conv_int(self.q_limbs, Q_LIMBS, k)
                + OFFCONST[k]
                - (self.c_limbs[k] if k < N_LIMBS else 0)
                + r_prev
            )
            assert t % (1 << 16) == 0, (k, t)
            r = t >> 16
            assert -CARRY_OFFSET <= r < CARRY_OFFSET, (k, r)
            enc = r + CARRY_OFFSET
            self.cl.append(enc & 0xFFFF)
            self.ch.append(enc >> 16)
            r_prev = r
        assert r_prev == 0, "multiplication identity does not close"

    def witness_columns(self) -> list[int]:
        """c, Q_enc, cl, ch — the 99 per-mul witness columns (operands are
        the caller's; they are usually shared between muls)."""
        return self.c_limbs + self.q_limbs + self.cl + self.ch


N_MUL_WITNESS = N_LIMBS + N_QLIMBS + 2 * N_CARRY  # 99


def _conv_elems_mat(alg, elems, mat, out_width: int):
    """Matrix-form convolution sum_i pad(elems[i] * mat, i) -> (n, out_width).

    elems: list of algebra elements; mat: width-w matrix (or const row).
    Equivalent to the limb convolution conv_k(elems, mat) for k < out_width,
    built from O(len) broadcast ops instead of O(len^2) scalar ops (on the
    device, a few elementwise kernels a term instead of one a limb pair)."""
    w = alg.width(mat)
    acc = None
    for i, e in enumerate(elems):
        term = alg.mul(alg.colv(e), mat)
        term = alg.pad_cols(term, i, out_width - i - w)
        acc = term if acc is None else alg.add(acc, term)
    return acc


def eval_mul_constraints(alg, a, b, witness):
    """Degree-2 constraint values (kind 'all') for one multiplication.

    a, b: 16 algebra elements each (may be linear combinations, degree 1).
    witness: the 99 elements in witness_columns() order. Returns
    [(width-34 matrix value, 'all')] — 33 limb equations + the closing carry.
    """
    c = witness[0:N_LIMBS]
    q = witness[N_LIMBS : N_LIMBS + N_QLIMBS]
    cl = witness[N_LIMBS + N_QLIMBS : N_LIMBS + N_QLIMBS + N_CARRY]
    ch = witness[N_LIMBS + N_QLIMBS + N_CARRY :]

    two16 = 1 << 16
    # carry values r_k = cl_k + 2^16 ch_k - 2^31 as elements (r[32] closes)
    r = [
        alg.sub(alg.add(cl[k], alg.mul(ch[k], alg.const(two16))), alg.const(CARRY_OFFSET))
        for k in range(N_CARRY)
    ]
    conv_ab = _conv_elems_mat(alg, a, alg.stack(b), N_CARRY)
    conv_qq = _conv_elems_mat(alg, q, alg.const_row(Q_LIMBS), N_CARRY)
    c_mat = alg.pad_cols(alg.stack(c), 0, N_CARRY - N_LIMBS)
    r_mat = alg.stack(r)
    r_prev = alg.stack([alg.const(0)] + r[: N_CARRY - 1])
    t = alg.add(alg.sub(conv_ab, conv_qq), alg.const_row(OFFCONST))
    t = alg.add(alg.sub(t, c_mat), r_prev)
    resid = alg.sub(t, alg.scale_row(r_mat, [two16] * N_CARRY))
    return [(alg.concat_cols(resid, alg.colv(r[N_CARRY - 1])), "all")]


# ----------------------------------------------------------------------------
# Edwards unified addition as one row gadget (add-2008-hwcd-3, k = 2d —
# the same complete formula ops/curve25519.add uses on device)
# ----------------------------------------------------------------------------

TWO_D = (2 * ged.D) % Q255
TWO_D_LIMBS = to_limbs(TWO_D)

# 9 multiplications; operands are linear combinations of the 8 input
# coordinates and earlier mul outputs:
#   A = (y1-x1)(y2-x2)   B = (y1+x1)(y2+x2)   U = t1*t2   C = U*2d
#   V = z1*z2            E = B-A  F = 2V-C  G = 2V+C  H = B+A
#   x3 = E*F   y3 = G*H   z3 = F*G   t3 = E*H
MUL_NAMES = ("A", "B", "U", "C", "V", "X3", "Y3", "Z3", "T3")
N_EDADD_INPUT = 8 * N_LIMBS  # x1 y1 z1 t1 x2 y2 z2 t2
N_EDADD_COLS = N_EDADD_INPUT + len(MUL_NAMES) * N_MUL_WITNESS  # 128 + 891 = 1019


class EdAddWitness:
    """Witness one unified addition P3 = P1 + P2 in extended coordinates.
    Inputs are canonical coordinate ints; outputs (X3, Y3, Z3, T3) are the
    c-limbs of the last four multiplications."""

    def __init__(self, p1: tuple[int, int, int, int], p2: tuple[int, int, int, int]):
        x1, y1, z1, t1 = [v % Q255 for v in p1]
        x2, y2, z2, t2 = [v % Q255 for v in p2]
        L = to_limbs
        self.inputs = L(x1) + L(y1) + L(z1) + L(t1) + L(x2) + L(y2) + L(z2) + L(t2)

        def sub_l(u, v):
            return [a - b for a, b in zip(u, v)]

        def add_l(u, v):
            return [a + b for a, b in zip(u, v)]

        wA = MulWitness(sub_l(L(y1), L(x1)), sub_l(L(y2), L(x2)))
        wB = MulWitness(add_l(L(y1), L(x1)), add_l(L(y2), L(x2)))
        wU = MulWitness(L(t1), L(t2))
        wC = MulWitness(wU.c_limbs, TWO_D_LIMBS)
        wV = MulWitness(L(z1), L(z2))
        e = sub_l(wB.c_limbs, wA.c_limbs)
        f = sub_l(add_l(wV.c_limbs, wV.c_limbs), wC.c_limbs)
        g = add_l(add_l(wV.c_limbs, wV.c_limbs), wC.c_limbs)
        h = add_l(wB.c_limbs, wA.c_limbs)
        wX3 = MulWitness(e, f)
        wY3 = MulWitness(g, h)
        wZ3 = MulWitness(f, g)
        wT3 = MulWitness(e, h)
        self.muls = (wA, wB, wU, wC, wV, wX3, wY3, wZ3, wT3)
        self.out = (wX3.c, wY3.c, wZ3.c, wT3.c)

    def columns(self) -> list[int]:
        cols = list(self.inputs)
        for w in self.muls:
            cols += w.witness_columns()
        return cols


def _mul_operands(alg, cols, idx: int):
    """Operand limb vectors (a, b) of multiplication `idx` of the Edwards
    addition, rebuilt from the row columns (MUL_NAMES order)."""
    L = N_LIMBS

    def word(base):
        return cols[base : base + L]

    x1, y1, z1, t1 = (word(L * i) for i in range(4))
    x2, y2, z2, t2 = (word(L * (4 + i)) for i in range(4))

    def c_of(i):
        base = N_EDADD_INPUT + i * N_MUL_WITNESS
        return cols[base : base + L]

    def sub_l(u, v):
        return [alg.sub(a, b) for a, b in zip(u, v)]

    def add_l(u, v):
        return [alg.add(a, b) for a, b in zip(u, v)]

    if idx == 0:  # A
        return sub_l(y1, x1), sub_l(y2, x2)
    if idx == 1:  # B
        return add_l(y1, x1), add_l(y2, x2)
    if idx == 2:  # U
        return t1, t2
    if idx == 3:  # C = U * 2d
        return c_of(2), [alg.const(v) for v in TWO_D_LIMBS]
    if idx == 4:  # V
        return z1, z2
    a_c, b_c, c_c, v_c = c_of(0), c_of(1), c_of(3), c_of(4)
    e = sub_l(b_c, a_c)
    f = sub_l(add_l(v_c, v_c), c_c)
    g = add_l(add_l(v_c, v_c), c_c)
    h = add_l(b_c, a_c)
    return {5: (e, f), 6: (g, h), 7: (f, g), 8: (e, h)}[idx]


def eval_ed_add_group(alg, cols, idx: int):
    """Constraints of multiplication `idx` alone (chunked-quotient group)."""
    a, b = _mul_operands(alg, cols, idx)
    base = N_EDADD_INPUT + idx * N_MUL_WITNESS
    return eval_mul_constraints(alg, a, b, cols[base : base + N_MUL_WITNESS])


def eval_ed_add_constraints(alg, cols):
    """Constraints for one Edwards addition row; cols in EdAddWitness order.
    Returns a list of [(matrix value, 'all')] — one per multiplication."""
    cs = []
    for idx in range(len(MUL_NAMES)):
        cs += eval_ed_add_group(alg, cols, idx)
    return cs


def range_checked_columns() -> list[int]:
    """Every EdAdd column must be in [0, 2^16) (inputs, c/Q/carry limbs)."""
    return list(range(N_EDADD_COLS))
