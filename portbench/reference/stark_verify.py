"""A frozen host verifier for the STARKs of the skip and step proofs.

It re-derives the whole Fiat-Shamir transcript from the publics and the
proof's commitments, checks the ALI identity at the out-of-domain point
zeta with the AIR's constraints over GF(p^2), checks every Merkle opening,
recomputes the DEEP combination at each queried point and runs the
extension-field FRI fold checks down to the final polynomial.

It covers AIRs without preprocessed columns, post-commit challenges or a
second trace commitment, which is what SkipAir and StepAir are. The proof is
read by attribute (trace_cap, quotient_cap, trace_zeta, trace_gzeta,
quotient_zeta, stage2_cap, fri, openings): the verifier imports nothing of
the program whose proof it judges.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import goldilocks as gl
from .challenger import Challenger
from .goldilocks import P, ext_add, ext_exp, ext_inv, ext_mul, ext_sub
from .poseidon import verify_path

U = (0, 1)  # the extension's basis element X


@dataclass(frozen=True)
class StarkParams:
    rate_bits: int
    cap_height: int
    num_query_rounds: int
    proof_of_work_bits: int
    final_poly_len: int


class _Alg:
    """GF(p^2) arithmetic on (c0, c1) pairs, for constraints at zeta."""

    @staticmethod
    def const(v: int):
        return (v % P, 0)

    add = staticmethod(ext_add)
    sub = staticmethod(ext_sub)
    mul = staticmethod(ext_mul)


class SkipAir:
    """Columns tp, tb, ta, tt (target set: power, signed bit, signed and
    total accumulators) and rp, rb, ra, rt (trusted set); publics [0..3] the
    four sums, then roots, data commitment, heights and aux digests (46)."""

    n_cols = 8
    n_publics = 46

    @staticmethod
    def constraints(local, nxt, pub, alg):
        tp, tb, ta, tt, rp, rb, ra, rt = local
        tp_n, tb_n, ta_n, tt_n, rp_n, rb_n, ra_n, rt_n = nxt
        one = alg.const(1)
        cs = [(alg.mul(b, alg.sub(b, one)), "all") for b in (tb, rb)]
        cs += [
            (alg.sub(ta, alg.mul(tb, tp)), "first"),
            (alg.sub(tt, tp), "first"),
            (alg.sub(ra, alg.mul(rb, rp)), "first"),
            (alg.sub(rt, rp), "first"),
            (alg.sub(ta_n, alg.add(ta, alg.mul(tb_n, tp_n))), "transition"),
            (alg.sub(tt_n, alg.add(tt, tp_n)), "transition"),
            (alg.sub(ra_n, alg.add(ra, alg.mul(rb_n, rp_n))), "transition"),
            (alg.sub(rt_n, alg.add(rt, rp_n)), "transition"),
            (alg.sub(ta, pub[0]), "last"),
            (alg.sub(tt, pub[1]), "last"),
            (alg.sub(ra, pub[2]), "last"),
            (alg.sub(rt, pub[3]), "last"),
        ]
        return cs


class StepAir:
    """Columns p, b, a, t of the new validator set; publics [0] signed,
    [1] total, then both roots and both heights (20)."""

    n_cols = 4
    n_publics = 20

    @staticmethod
    def constraints(local, nxt, pub, alg):
        p, b, a, t = local
        p_n, b_n, a_n, t_n = nxt
        one = alg.const(1)
        return [
            (alg.mul(b, alg.sub(b, one)), "all"),
            (alg.sub(a, alg.mul(b, p)), "first"),
            (alg.sub(t, p), "first"),
            (alg.sub(a_n, alg.add(a, alg.mul(b_n, p_n))), "transition"),
            (alg.sub(t_n, alg.add(t, p_n)), "transition"),
            (alg.sub(a, pub[0]), "last"),
            (alg.sub(t, pub[1]), "last"),
        ]


def _divisor_inv(kind: str, zeta, n: int, g_last: int):
    zh = ext_sub(ext_exp(zeta, n), (1, 0))
    if kind == "all":
        return ext_inv(zh)
    if kind == "transition":
        return ext_mul(ext_inv(zh), ext_sub(zeta, (g_last, 0)))
    if kind == "first":
        return ext_inv(ext_sub(zeta, (1, 0)))
    if kind == "last":
        return ext_inv(ext_sub(zeta, (g_last, 0)))
    raise ValueError(kind)


def _fri_verify(fri, n: int, prm: StarkParams, ch: Challenger, shift: int, layer0_check) -> bool:
    num_layers = len(fri.caps)
    betas, sizes, shifts = [], [], []
    size, cur_shift = n, shift % P
    for ell in range(num_layers):
        sizes.append(size)
        shifts.append(cur_shift)
        for digest in fri.caps[ell]:
            ch.observe_many(digest)
        betas.append(ch.sample_ext())
        size //= 2
        cur_shift = cur_shift * cur_shift % P
    if size != prm.final_poly_len:
        return False
    if len(fri.final_poly) != prm.final_poly_len >> prm.rate_bits:
        return False
    for v in fri.final_poly:
        ch.observe_ext(v)
    ch.observe(fri.pow_nonce)
    if ch.sample() >> (64 - prm.proof_of_work_bits) != 0:
        return False
    indices = ch.sample_indices(prm.num_query_rounds, n // 2)
    if len(fri.query_rounds) != len(indices):
        return False
    inv2 = (gl.inv(2), 0)
    for idx, qround in zip(indices, fri.query_rounds):
        if len(qround.layers) != num_layers:
            return False
        pos = idx
        expect = None
        for ell in range(num_layers):
            half = sizes[ell] // 2
            i = pos % half
            layer = qround.layers[ell]
            fe, fo = (tuple(layer.pair[0]), tuple(layer.pair[1]))
            if ell == 0 and not layer0_check(i, (fe, fo)):
                return False
            if expect is not None and (fe if pos < half else fo) != expect:
                return False
            if not verify_path(fri.caps[ell], [fe[0], fe[1], fo[0], fo[1]], i, layer.path):
                return False
            x_i = shifts[ell] * pow(gl.root_of_unity(sizes[ell].bit_length() - 1), i, P) % P
            even = ext_mul(ext_add(fe, fo), inv2)
            odd = ext_mul(ext_mul(ext_sub(fe, fo), inv2), (gl.inv(x_i), 0))
            expect = ext_add(even, ext_mul(betas[ell], odd))
            pos = i
        final_shift = shifts[-1] * shifts[-1] % P if num_layers else shift % P
        x = final_shift * pow(gl.root_of_unity(prm.final_poly_len.bit_length() - 1), pos, P) % P
        val = (0, 0)
        for coeff in reversed(fri.final_poly):
            val = ext_add(ext_mul(val, (x, 0)), tuple(coeff))
        if expect is not None and val != expect:
            return False
    return True


def verify(air, proof, publics: list[int], prm: StarkParams, n: int, shift: int = gl.COSET_SHIFT) -> bool:
    """True when `proof` is a valid STARK of `air` over n rows with these
    publics; False on any failed check or malformed field."""
    try:
        return _verify(air, proof, publics, prm, n, shift)
    except (AttributeError, IndexError, TypeError, ValueError, ZeroDivisionError):
        return False


def _verify(air, proof, publics, prm: StarkParams, n: int, shift: int) -> bool:
    n_cols = air.n_cols
    blowup = 1 << prm.rate_bits
    n_ext = n * blowup
    log_n = n.bit_length() - 1
    if n != 1 << log_n or len(publics) != air.n_publics:
        return False
    g = gl.root_of_unity(log_n)
    g_last = pow(g, n - 1, P)
    w_ext = gl.root_of_unity(log_n + prm.rate_bits)
    trace_zeta = [tuple(v) for v in proof.trace_zeta]
    trace_gzeta = [tuple(v) for v in proof.trace_gzeta]
    quotient_zeta = [tuple(v) for v in proof.quotient_zeta]
    if len(trace_zeta) != n_cols or len(trace_gzeta) != n_cols or len(quotient_zeta) != 2 * blowup:
        return False
    if proof.stage2_cap or proof.stage2_zeta or proof.stage2_gzeta:
        return False

    ch = Challenger()
    ch.observe_many([v % P for v in publics])
    for digest in proof.trace_cap:
        ch.observe_many(digest)
    alpha = ch.sample_ext()
    for digest in proof.quotient_cap:
        ch.observe_many(digest)
    zeta = ch.sample_ext()
    for v in trace_zeta + trace_gzeta + quotient_zeta:
        ch.observe_ext(v)
    gamma = ch.sample_ext()

    # the ALI identity at zeta: sum over divisor kinds of the alpha-combined
    # constraints over their divisor equals the quotient chunks at zeta
    pub = [(v % P, 0) for v in publics]
    constraints = air.constraints(trace_zeta, trace_gzeta, pub, _Alg)
    acc: dict[str, tuple[int, int]] = {}
    cur = (1, 0)
    for value, kind in constraints:
        acc[kind] = ext_add(acc.get(kind, (0, 0)), ext_mul(value, cur))
        cur = ext_mul(cur, alpha)
    lhs = (0, 0)
    for kind, v in acc.items():
        lhs = ext_add(lhs, ext_mul(v, _divisor_inv(kind, zeta, n, g_last)))
    zeta_n = ext_exp(zeta, n)
    rhs = (0, 0)
    zp = (1, 0)
    for k in range(blowup):
        qk = ext_add(quotient_zeta[2 * k], ext_mul(U, quotient_zeta[2 * k + 1]))
        rhs = ext_add(rhs, ext_mul(zp, qk))
        zp = ext_mul(zp, zeta_n)
    if lhs != rhs:
        return False

    # the DEEP combination at each queried point, then FRI
    g_zeta = ext_mul(zeta, (g, 0))
    g_pows = []
    cur = (1, 0)
    for _ in range(2 * n_cols + 2 * blowup):
        g_pows.append(cur)
        cur = ext_mul(cur, gamma)
    half = n_ext // 2
    state = {"round": -1}

    def deep_at(posn: int, row_w: list[int], row_q: list[int]):
        x = shift % P * pow(w_ext, posn, P) % P
        inv_xz = ext_inv(ext_sub((x, 0), zeta))
        inv_xgz = ext_inv(ext_sub((x, 0), g_zeta))
        num_a = (0, 0)
        num_b = (0, 0)
        for j in range(n_cols):
            tv = (row_w[j] % P, 0)
            num_a = ext_add(num_a, ext_mul(g_pows[j], ext_sub(tv, trace_zeta[j])))
            num_b = ext_add(num_b, ext_mul(g_pows[n_cols + j], ext_sub(tv, trace_gzeta[j])))
        for k in range(2 * blowup):
            qv = (row_q[k] % P, 0)
            num_a = ext_add(num_a, ext_mul(g_pows[2 * n_cols + k], ext_sub(qv, quotient_zeta[k])))
        return ext_add(ext_mul(num_a, inv_xz), ext_mul(num_b, inv_xgz))

    def layer0_check(i: int, pair) -> bool:
        state["round"] += 1
        r = state["round"]
        if r >= len(proof.openings):
            return False
        q = proof.openings[r]
        for side, (posn, want) in enumerate(((i, pair[0]), (i + half, pair[1]))):
            t, qu = q.trace[side], q.quotient[side]
            if len(t.row) != n_cols or len(qu.row) != 2 * blowup:
                return False
            if not verify_path(proof.trace_cap, [v % P for v in t.row], posn, t.path):
                return False
            if not verify_path(proof.quotient_cap, [v % P for v in qu.row], posn, qu.path):
                return False
            if deep_at(posn, list(t.row), list(qu.row)) != want:
                return False
        return True

    return _fri_verify(proof.fri, n_ext, prm, ch, shift, layer0_check)
