"""Ed25519 scalar-multiplication auxiliary STARK (design:
docs/ed25519_stark.md).

Statement: for each claimed (scalar s, base point P, result Q) triple,
Q = s * P on the Ed25519 curve, computed MSB-first double-and-add in extended
twisted-Edwards coordinates using the complete unified addition formula (the
same one ops/curve25519.py uses on device).

Layout: ONE unified Edwards addition per trace row, every GF(2^255-19)
element as 16 little-endian 16-bit limbs in Goldilocks columns
(prover/gf25519_gadget.py), so the whole constraint system is a fixed
vectorized polynomial program over the extended domain:

  row r of a 512-row segment:
    r = 2k   (k = 0..252)  double:           acc' = acc + acc
    r = 2k+1 (k = 0..252)  conditional add:  acc' = acc + (bit ? P : identity)
                           for bit = s_{252-k} (MSB-first)
    r = 506..511           padding adds of the identity (bit forced 0; adding
                           the identity preserves the point projectively)

Trace columns per row (n_cols = 1068 + nt):
  acc[64]      X1,Y1,Z1,T1 of the accumulator (EdAdd input 1)
  addend[64]   X2,Y2,Z2,T2 (EdAdd input 2)
  wit[891]     9 multiplication witnesses (c, Q_enc, carries) — the last four
               multiplications' c-limbs are the row's output point
  p[48]        the segment's base point: px, py, pt = px*py (affine, Z = 1)
  bit[1]       the scalar bit consumed by this row (0 on double/pad rows)
  mult[nt]     logUp multiplicities for the 16-bit limb range table

Fixed (preprocessed) columns: add/pad/segfirst/seglast selectors + nt range-
table columns jointly covering [0, 2^16) (prover.lookup.range_table_columns;
nt = ceil(2^16 / n_rows), so short test traces stay provable).

Digest bus (stage-2, after the trace commit yields r): the accumulator
absorbs, per segment, the 48 base-point limbs (on the segment-first row),
then one scalar bit per add row (253 bits MSB-first + 6 forced-zero pads),
then the 64 result limbs (on the segment-last row); the final value is pinned
to C = the same Horner fold of the CLAIMED (s, P, Q) triples in aux, observed
before sampling r. A second post-commit challenge beta drives the logUp
range argument over all 939 limb-witness columns.
"""

from __future__ import annotations

import numpy as np

from blobstreamx_tpu_torch.golden import ed25519 as ged
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.prover import gf25519_gadget as gg
from blobstreamx_tpu_torch.prover import lookup

from .air import Air, frame_block

P = gold.P
Q255 = ged.Q

SEG = 512
BITS = 253
N_PAD = SEG - 2 * BITS  # 6

OFF_ACC = 0
OFF_ADD = 64
OFF_WIT = 128
OFF_P = OFF_WIT + 9 * gg.N_MUL_WITNESS  # 1019
OFF_BIT = OFF_P + 48  # 1067
OFF_MULT = OFF_BIT + 1  # 1068
N_LOOKUP = 9 * gg.N_MUL_WITNESS + 48  # 939: every mul-witness limb + P limbs

FX_ADD, FX_PAD, FX_SEGFIRST, FX_SEGLAST = range(4)
FX_TABLE = 4

# identity (0, 1, 1, 0) as 64 limbs
ID_LIMBS = [0] * 16 + gg.to_limbs(1) + gg.to_limbs(1) + [0] * 16
E0 = gg.to_limbs(1)  # the limb vector of 1

# trace offsets of the output point's limbs (c-limbs of muls X3,Y3,Z3,T3)
OUT_COLS = [
    OFF_WIT + (5 + m) * gg.N_MUL_WITNESS + j for m in range(4) for j in range(16)
]


def _is_add_row(t: int) -> bool:
    return (t % 2 == 1 and t <= 2 * BITS - 1) or t >= 2 * BITS


def _scalar_bits(s: int) -> list[int]:
    assert 0 <= s < (1 << BITS)
    return [(s >> (BITS - 1 - k)) & 1 for k in range(BITS)]


def _claim_limbs(px: int, py: int) -> list[int]:
    pt = px * py % Q255
    return gg.to_limbs(px) + gg.to_limbs(py) + gg.to_limbs(pt)


def _out_limbs(out: tuple[int, int, int, int]) -> list[int]:
    return sum((gg.to_limbs(v % Q255) for v in out), [])


def fold_ed_claims(aux, r: int) -> int:
    """Horner fold of the absorbed stream; must match the AIR's bus schedule:
    per segment: 48 base limbs, then 253 bits MSB-first + 6 zero pads (the
    last combined with the 64 result limbs)."""
    r48 = pow(r, 48, P)
    r64 = pow(r, 64, P)
    c = 0
    for s, (px, py), out in aux:
        fold = 0
        for limb in _claim_limbs(px, py):
            fold = (fold * r + limb) % P
        c = (c * r48 + fold) % P
        for b in _scalar_bits(s) + [0] * N_PAD:
            c = (c * r + b) % P
        fold = 0
        for limb in _out_limbs(out):
            fold = (fold * r + limb) % P
        c = (c * r64 + fold) % P
    return c


class EdScalarMulAir(Air):
    """n_segments scalar-multiplication chains of 512 rows each (n_segments
    a power of two; trace height n = 512 * n_segments)."""

    max_degree = 3  # add-row addend selection: fixed selector * bit * P limb

    def __init__(self, n_segments: int):
        assert n_segments >= 1 and n_segments & (n_segments - 1) == 0
        self.n_segments = n_segments
        n = SEG * n_segments
        self.n_rows = n
        self.nt = ((1 << 16) + n - 1) // n
        self.n_cols = OFF_MULT + self.nt
        self.n_fixed = FX_TABLE + self.nt
        # paired-ext logUp wells [u0.., u1.., wm0.., wm1.., A0, A1] + digest
        # bus — the GF(p^2) challenge at the OLD base-field column budget
        # (one ext well covers TWO lookup columns at degree 3)
        self.n_stage2 = lookup.n_stage2_cols_multi_ext(N_LOOKUP, self.nt) + 1
        self.n_challenges = 67  # r^1..r^64, C, beta0, beta1 (GF(p^2) logUp)

    def cache_key(self):
        return (type(self), self.n_segments)

    # ------------------------------------------------------------------ fixed
    def fixed_columns(self, n: int) -> np.ndarray:
        assert n == self.n_rows
        out = np.zeros((n, self.n_fixed), dtype=np.uint64)
        for t in range(SEG):
            rows = slice(t, n, SEG)
            out[rows, FX_ADD] = 1 if _is_add_row(t) else 0
            out[rows, FX_PAD] = 1 if t >= 2 * BITS else 0
            out[rows, FX_SEGFIRST] = 1 if t == 0 else 0
            out[rows, FX_SEGLAST] = 1 if t == SEG - 1 else 0
        out[:, FX_TABLE:] = lookup.range_table_columns(n)
        return out

    # -------------------------------------------------------------------- bus
    def observe_aux(self, challenger, aux) -> None:
        """aux: list per segment of (scalar, (px, py), (X, Y, Z, T))."""
        assert len(aux) == self.n_segments
        for s, (px, py), out in aux:
            challenger.observe_many(gg.to_limbs(s))
            challenger.observe_many(_claim_limbs(px, py))
            challenger.observe_many(_out_limbs(out))

    def sample_challenges(self, challenger, aux) -> list[int]:
        r = challenger.sample()
        rp = [r]
        for _ in range(63):
            rp.append(gold.mul(rp[-1], r))
        c = fold_ed_claims(aux, r)
        # logUp challenge from GF(p^2): ~2^-101 soundness instead of the
        # base field's ~2^-40 (prover.lookup module docstring)
        beta = challenger.sample_ext()
        return rp + [c, beta[0], beta[1]]

    def build_stage2(self, trace: np.ndarray, challenges: list[int], aux) -> np.ndarray:
        n = trace.shape[0]
        r = int(challenges[0])
        beta = (int(challenges[65]), int(challenges[66]))
        values = trace[:, OFF_WIT : OFF_WIT + N_LOOKUP]
        mult = trace[:, OFF_MULT : OFF_MULT + self.nt]
        table = lookup.range_table_columns(n)
        lu = lookup.build_logup_stage2_multi_ext(values, mult, table, beta)

        r48 = pow(r, 48, P)
        r64 = pow(r, 64, P)
        rp47 = [pow(r, 47 - j, P) for j in range(48)]
        rp63 = [pow(r, 63 - j, P) for j in range(64)]
        bus = np.zeros((n, 1), dtype=np.uint64)
        bits = trace[:, OFF_BIT].tolist()
        c = 0
        for row in range(n):
            t = row % SEG
            if t == 0:
                fold = 0
                for j, v in enumerate(trace[row, OFF_P : OFF_P + 48].tolist()):
                    fold = (fold + v * rp47[j]) % P
                c = (c * r48 + fold) % P
            elif _is_add_row(t):
                c = (c * r + bits[row]) % P
                if t == SEG - 1:
                    fold = 0
                    for j, v in enumerate(trace[row, OUT_COLS].tolist()):
                        fold = (fold + v * rp63[j]) % P
                    c = (c * r64 + fold) % P
            bus[row, 0] = c
        return np.concatenate([lu, bus], axis=1)

    # ----------------------------------------------------------- constraints
    #
    # Constraint groups (see Air.n_constraint_groups): groups 0-8 are the
    # nine Edwards-addition multiplication gadgets (the bulk of the program;
    # the quotient evaluates one group at a time, so each group's
    # temporaries are freed before the next), group 9 the scalar/
    # accumulator/bus logic, group 10 the logUp range argument. eval_constraints is the
    # concatenation, in that order (the verifier and the grouped prover agree
    # on alpha offsets because the order is identical).
    n_constraint_groups = 11

    def eval_constraint_group(
        self,
        g,
        local,
        nxt,
        publics,
        alg,
        fixed=None,
        fixed_next=None,
        challenges=None,
        stage2=None,
        stage2_next=None,
    ):
        if g < 9:
            return gg.eval_ed_add_group(alg, local[: gg.N_EDADD_COLS], g)
        if g == 9:
            return self._eval_scalar_bus(
                local, nxt, alg, fixed, fixed_next, challenges, stage2, stage2_next
            )
        assert g == 10
        return self._eval_lookup(
            local, nxt, alg, fixed, fixed_next, challenges, stage2, stage2_next
        )

    def eval_constraints(
        self,
        local,
        nxt,
        publics,
        alg,
        fixed=None,
        fixed_next=None,
        challenges=None,
        stage2=None,
        stage2_next=None,
    ):
        cs = []
        for g in range(self.n_constraint_groups):
            cs += self.eval_constraint_group(
                g,
                local,
                nxt,
                publics,
                alg,
                fixed=fixed,
                fixed_next=fixed_next,
                challenges=challenges,
                stage2=stage2,
                stage2_next=stage2_next,
            )
        return cs

    def _eval_scalar_bus(
        self, local, nxt, alg, fixed, fixed_next, challenges, stage2, stage2_next
    ):
        one = alg.const(1)
        add_sel = fixed[FX_ADD]
        pad_sel = fixed[FX_PAD]
        segfirst = fixed[FX_SEGFIRST]
        seglast = fixed[FX_SEGLAST]
        add_n = fixed_next[FX_ADD]
        segfirst_n = fixed_next[FX_SEGFIRST]
        seglast_n = fixed_next[FX_SEGLAST]
        rp = challenges[:64]  # rp[i] = r^{i+1}
        c_final = challenges[64]
        bit = local[OFF_BIT]
        bit_n = nxt[OFF_BIT]

        def out_block(frame):
            # OUT_COLS is four contiguous 16-column runs (X3,Y3,Z3,T3 c-limbs)
            return alg.concat_cols(
                *(
                    frame_block(
                        alg,
                        frame,
                        OFF_WIT + (5 + m) * gg.N_MUL_WITNESS,
                        OFF_WIT + (5 + m) * gg.N_MUL_WITNESS + 16,
                    )
                    for m in range(4)
                )
            )

        cs = []
        # 2. bit booleanity; pad rows force bit = 0
        cs.append((alg.mul(bit, alg.sub(bit, one)), "all"))
        cs.append((alg.mul(pad_sel, bit), "all"))

        # 3. accumulator chaining: next acc = this row's output point
        acc_m = frame_block(alg, local, OFF_ACC, OFF_ACC + 64)
        acc_mn = frame_block(alg, nxt, OFF_ACC, OFF_ACC + 64)
        out_m = out_block(local)
        not_last = alg.colv(alg.sub(one, seglast))
        cs.append((alg.mul(not_last, alg.sub(acc_mn, out_m)), "transition"))

        # 4. segment-first rows start from the identity
        cs.append(
            (
                alg.mul(alg.colv(segfirst), alg.sub(acc_m, alg.const_row(ID_LIMBS))),
                "all",
            )
        )

        # 5. double rows: addend = acc
        add_m = frame_block(alg, local, OFF_ADD, OFF_ADD + 64)
        dbl = alg.sub(one, add_sel)
        cs.append((alg.mul(alg.colv(dbl), alg.sub(add_m, acc_m)), "all"))

        # 6. add rows: addend = bit ? (px, py, 1, pt) : (0, 1, 1, 0)
        px_m = frame_block(alg, local, OFF_P, OFF_P + 16)
        py_m = frame_block(alg, local, OFF_P + 16, OFF_P + 32)
        pt_m = frame_block(alg, local, OFF_P + 32, OFF_P + 48)
        bitc = alg.colv(bit)
        nbitc = alg.colv(alg.sub(one, bit))
        e0 = alg.const_row(E0)
        # target addend: X = bit*px, Y = bit*py + (1-bit), Z = 1, T = bit*pt
        # (Z written as (bit + (1-bit)) * e0 so every block is (n, 16))
        target = alg.concat_cols(
            alg.mul(bitc, px_m),
            alg.add(alg.mul(bitc, py_m), alg.mul(nbitc, e0)),
            alg.add(alg.mul(bitc, e0), alg.mul(nbitc, e0)),
            alg.mul(bitc, pt_m),
        )
        cs.append((alg.mul(alg.colv(add_sel), alg.sub(add_m, target)), "all"))

        # 7. the base point is constant within a segment
        p_m = frame_block(alg, local, OFF_P, OFF_P + 48)
        p_mn = frame_block(alg, nxt, OFF_P, OFF_P + 48)
        cs.append((alg.mul(not_last, alg.sub(p_mn, p_m)), "transition"))

        # 8. digest bus
        bus = stage2[-1]
        bus_n = stage2_next[-1]

        def fold_desc(elems):
            # sum_j elems[j] * r^{L-1-j}; the last element gets r^0.
            # Matrix form (one wide mul + log-depth column sum) instead of a
            # sequential chain: exact field addition is associative, so the
            # value — and therefore the proof — is unchanged, but it takes
            # a few wide operations instead of one per element.
            k = len(elems)
            if k == 1:
                return elems[0]
            m = alg.stack(list(elems[:-1]))  # (n, k-1)
            w = alg.stack([rp[k - 2 - j] for j in range(k - 1)])  # (1, k-1)
            return alg.add(alg.sum_cols(alg.mul(m, w)), elems[-1])

        fold48_n = fold_desc([nxt[OFF_P + j] for j in range(48)])
        fold64_n = fold_desc([nxt[c] for c in OUT_COLS])
        absorb_bit = alg.add(alg.mul(bus, rp[0]), bit_n)
        term_first = alg.mul(segfirst_n, alg.add(alg.mul(bus, rp[47]), fold48_n))
        term_add = alg.mul(alg.sub(add_n, seglast_n), absorb_bit)
        term_last = alg.mul(
            seglast_n, alg.add(alg.mul(absorb_bit, rp[63]), fold64_n)
        )
        term_dbl = alg.mul(alg.sub(alg.sub(one, add_n), segfirst_n), bus)
        absorb = alg.add(alg.add(term_first, term_add), alg.add(term_last, term_dbl))
        cs.append((alg.sub(bus_n, absorb), "transition"))
        cs.append((alg.sub(bus, fold_desc([local[OFF_P + j] for j in range(48)])), "first"))
        cs.append((alg.sub(bus, c_final), "last"))
        return cs

    def _eval_lookup(
        self, local, nxt, alg, fixed, fixed_next, challenges, stage2, stage2_next
    ):
        nt = self.nt
        beta0, beta1 = challenges[65], challenges[66]
        cs = []
        # 9. logUp 16-bit range checks over every mul-witness and P limb
        values_m = frame_block(alg, local, OFF_WIT, OFF_WIT + N_LOOKUP)
        values_mn = frame_block(alg, nxt, OFF_WIT, OFF_WIT + N_LOOKUP)
        mult_m = frame_block(alg, local, OFF_MULT, OFF_MULT + nt)
        mult_mn = frame_block(alg, nxt, OFF_MULT, OFF_MULT + nt)
        table_m = frame_block(alg, fixed, FX_TABLE, FX_TABLE + nt)
        table_mn = frame_block(alg, fixed_next, FX_TABLE, FX_TABLE + nt)
        cs += lookup.eval_logup_multi_ext(
            alg,
            beta0,
            beta1,
            values_m,
            mult_m,
            table_m,
            values_mn,
            mult_mn,
            table_mn,
            stage2,
            stage2_next,
            N_LOOKUP,
            nt,
        )
        return cs


# ---------------------------------------------------------------------------
# host-side witness generation
# ---------------------------------------------------------------------------

IDENT = (0, 1, 1, 0)


class _Lanes:
    """A batch of field values in both representations: python ints (exact
    big-number arithmetic) and (S, 16) signed int64 limbs (vectorized
    convolution/carry arithmetic). Lin-comb limbs stay |v| < 2^17."""

    __slots__ = ("ints", "limbs")

    def __init__(self, ints, limbs):
        self.ints = ints
        self.limbs = limbs

    @classmethod
    def from_ints(cls, ints: list[int]) -> "_Lanes":
        return cls(list(ints), _limbs_of_ints(ints, 16, 32))

    def __sub__(self, o: "_Lanes") -> "_Lanes":
        return _Lanes([a - b for a, b in zip(self.ints, o.ints)], self.limbs - o.limbs)

    def __add__(self, o: "_Lanes") -> "_Lanes":
        return _Lanes([a + b for a, b in zip(self.ints, o.ints)], self.limbs + o.limbs)


def _limbs_of_ints(vals: list[int], n_limbs: int, nbytes: int) -> np.ndarray:
    buf = b"".join(v.to_bytes(nbytes, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(vals), nbytes // 2)
    return arr[:, :n_limbs].astype(np.int64)


_Q_ROW = np.array(gg.Q_LIMBS, dtype=np.int64)
_OFF_ROW = np.array(gg.OFFCONST, dtype=np.int64)


def _mul_batch(a: _Lanes, b: _Lanes):
    """Vectorized MulWitness over S lanes: exact big-int quotient/remainder
    per lane (cheap) + numpy convolution/carry columns (the bulk). Returns
    ((S, 99) uint64 witness columns, c as _Lanes). Bit-identical to
    gg.MulWitness per lane (tests cross-check)."""
    S = len(a.ints)
    q_ints, c_ints, q_encs = [], [], []
    for ai, bi in zip(a.ints, b.ints):
        p = ai * bi
        q = p // Q255
        q_ints.append(q)
        c_ints.append(p - q * Q255)
        q_encs.append(q + gg.Q_OFFSET)
    c_limbs = _limbs_of_ints(c_ints, gg.N_LIMBS, 32)
    q_limbs = _limbs_of_ints(q_encs, gg.N_QLIMBS, 34)

    conv = np.zeros((S, gg.N_CARRY), dtype=np.int64)
    outer = a.limbs[:, :, None] * b.limbs[:, None, :]
    for i in range(gg.N_LIMBS):
        conv[:, i : i + gg.N_LIMBS] += outer[:, i, :]
    for i in range(gg.N_QLIMBS):
        conv[:, i : i + gg.N_LIMBS] -= q_limbs[:, i : i + 1] * _Q_ROW[None, :]
    conv += _OFF_ROW[None, :]
    conv[:, : gg.N_LIMBS] -= c_limbs

    cl = np.zeros((S, gg.N_CARRY), dtype=np.uint64)
    ch = np.zeros((S, gg.N_CARRY), dtype=np.uint64)
    r_prev = np.zeros(S, dtype=np.int64)
    for k in range(gg.N_CARRY):
        tk = conv[:, k] + r_prev
        r = tk >> 16  # arithmetic shift == python floor shift
        assert not (tk & 0xFFFF).any(), "mul identity does not close limb-wise"
        enc = r + gg.CARRY_OFFSET
        cl[:, k] = (enc & 0xFFFF).astype(np.uint64)
        ch[:, k] = (enc >> 16).astype(np.uint64)
        r_prev = r
    assert not r_prev.any(), "multiplication identity does not close"
    wit = np.concatenate(
        [c_limbs.astype(np.uint64), q_limbs.astype(np.uint64), cl, ch], axis=1
    )
    return wit, _Lanes(c_ints, c_limbs)


def _ed_add_batch(p1, p2):
    """Vectorized EdAddWitness over S lanes. p1/p2: 4-tuples of _Lanes
    (canonical coordinates). Returns ((S, 1019) uint64 row columns,
    output point as a 4-tuple of _Lanes)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    S = len(x1.ints)
    inputs = np.concatenate(
        [l.limbs for l in (x1, y1, z1, t1, x2, y2, z2, t2)], axis=1
    ).astype(np.uint64)
    two_d = _Lanes([TWO_D] * S, np.tile(np.array(TWO_D_LIMBS, np.int64), (S, 1)))
    wA, A = _mul_batch(y1 - x1, y2 - x2)
    wB, B = _mul_batch(y1 + x1, y2 + x2)
    wU, U = _mul_batch(t1, t2)
    wC, C = _mul_batch(U, two_d)
    wV, V = _mul_batch(z1, z2)
    e = B - A
    f = (V + V) - C
    g = (V + V) + C
    h = B + A
    wX, X3 = _mul_batch(e, f)
    wY, Y3 = _mul_batch(g, h)
    wZ, Z3 = _mul_batch(f, g)
    wT, T3 = _mul_batch(e, h)
    cols = np.concatenate([inputs, wA, wB, wU, wC, wV, wX, wY, wZ, wT], axis=1)
    return cols, (X3, Y3, Z3, T3)


TWO_D = gg.TWO_D
TWO_D_LIMBS = gg.TWO_D_LIMBS


def build_ed_trace(pairs: list[tuple[int, tuple[int, int]]]):
    """pairs: [(scalar < 2^253, affine point (x, y) on the curve)]; length a
    power of two. Returns (trace (512*len, n_cols) uint64, aux claims).

    Vectorized across segments: every segment executes the same row schedule,
    so row t of all S segments is one batched Edwards addition. The scalar
    build_ed_trace_ref is the independent oracle (tests assert equality).

    The claimed result in aux is the raw extended-coordinate output
    (X, Y, Z, T) of the chain's last row — consumers normalize by Z."""
    S = len(pairs)
    assert S >= 1 and S & (S - 1) == 0
    air = EdScalarMulAir(S)
    n = SEG * S
    trace = np.zeros((n, air.n_cols), dtype=np.uint64)

    px = [p[0] % Q255 for _, p in pairs]
    py = [p[1] % Q255 for _, p in pairs]
    pt = [x * y % Q255 for x, y in zip(px, py)]
    p_lanes = (_Lanes.from_ints(px), _Lanes.from_ints(py),
               _Lanes.from_ints([1] * S), _Lanes.from_ints(pt))
    id_lanes = (_Lanes.from_ints([0] * S), _Lanes.from_ints([1] * S),
                _Lanes.from_ints([1] * S), _Lanes.from_ints([0] * S))
    bits = np.array([_scalar_bits(s) for s, _ in pairs], dtype=np.uint64)  # (S, 253)
    p_limb_cols = np.concatenate(
        [p_lanes[0].limbs, p_lanes[1].limbs, p_lanes[3].limbs], axis=1
    ).astype(np.uint64)

    acc = id_lanes
    for t in range(SEG):
        rows = np.arange(S) * SEG + t
        if t < 2 * BITS and t % 2 == 0:
            addend = acc
            bcol = np.zeros(S, dtype=np.uint64)
        elif t < 2 * BITS:
            k = (t - 1) // 2
            bcol = bits[:, k]
            mask = bcol.astype(bool)[:, None]
            addend = tuple(
                _Lanes(
                    [pc if bb else ic for pc, ic, bb in zip(pl.ints, il.ints, bcol)],
                    np.where(mask, pl.limbs, il.limbs),
                )
                for pl, il in zip(p_lanes, id_lanes)
            )
        else:
            addend = id_lanes
            bcol = np.zeros(S, dtype=np.uint64)
        cols, acc = _ed_add_batch(acc, addend)
        trace[rows, : gg.N_EDADD_COLS] = cols
        trace[rows, OFF_P : OFF_P + 48] = p_limb_cols
        trace[rows, OFF_BIT] = bcol
    aux = [
        (pairs[si][0], (px[si], py[si]),
         (acc[0].ints[si], acc[1].ints[si], acc[2].ints[si], acc[3].ints[si]))
        for si in range(S)
    ]
    values = trace[:, OFF_WIT : OFF_WIT + N_LOOKUP]
    table = lookup.range_table_columns(n)
    trace[:, OFF_MULT : OFF_MULT + air.nt] = lookup.multiplicities_multi(values, table)
    return trace, aux


def build_ed_trace_ref(pairs: list[tuple[int, tuple[int, int]]]):
    """Scalar reference trace builder (one EdAddWitness per row; the
    independent oracle for the vectorized builder)."""
    S = len(pairs)
    assert S >= 1 and S & (S - 1) == 0
    air = EdScalarMulAir(S)
    n = SEG * S
    trace = np.zeros((n, air.n_cols), dtype=np.uint64)
    aux = []
    for si, (s, (px, py)) in enumerate(pairs):
        px %= Q255
        py %= Q255
        pt = px * py % Q255
        p_ext = (px, py, 1, pt)
        p_limbs = np.array(_claim_limbs(px, py), dtype=np.uint64)
        bits = _scalar_bits(s)
        base = si * SEG
        acc = IDENT
        ops: list[tuple[tuple[int, int, int, int] | None, int]] = []
        for k in range(BITS):
            ops.append((None, 0))  # double
            ops.append((p_ext if bits[k] else IDENT, bits[k]))
        for _ in range(N_PAD):
            ops.append((IDENT, 0))
        for t, (addend, b) in enumerate(ops):
            w = gg.EdAddWitness(acc, acc if addend is None else addend)
            row = trace[base + t]
            row[: gg.N_EDADD_COLS] = w.columns()
            row[OFF_P : OFF_P + 48] = p_limbs
            row[OFF_BIT] = b
            acc = w.out
        aux.append((s, (px, py), acc))
    values = trace[:, OFF_WIT : OFF_WIT + N_LOOKUP]
    table = lookup.range_table_columns(n)
    trace[:, OFF_MULT : OFF_MULT + air.nt] = lookup.multiplicities_multi(values, table)
    return trace, aux


def claims_hold(aux) -> bool:
    """Host check that each claimed triple satisfies Q = s*P (projective
    comparison against the golden RFC 8032 ladder) — the consumer-side
    meaning of the STARK's statement."""
    for s, (px, py), out in aux:
        pt = px * py % Q255
        want = ged.point_mul(s, (px, py, 1, pt))
        if not ged.point_equal(out, want):
            return False
    return True
