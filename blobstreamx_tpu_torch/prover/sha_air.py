"""SHA-256 auxiliary STARK: the batch-hash prover of the SHA-256 trust
tier (upstream proves batched SHA-256 in an auxiliary STARK linked into its
circuit by a lookup; here the host verifier plays the circuit's role).

ONE row per SHA-256 round (64 rows per block), every 32-bit word held as 32
boolean base-field columns (LSB-first), so the whole constraint system is a
fixed vectorized polynomial program over the extended domain — no gates, no
branches. On the device it runs as plain PyTorch tensor code through the
prover's DeviceAlgebra; the host verifier runs the same code at zeta.

Trace layout per row (n_cols = 1300):
  win[16][32]   sliding message-schedule window: win[j] = w_{t-j}
                (entries with t-j < 0 carry shifted-in garbage that no
                active constraint reads; the shift recurrence itself is
                enforced uniformly)
  st[8][32]     working state a..h at the START of round t
  hin[8][32]    the block's input chaining value (constant within a block)
  dg[8][32]     digest words hin + state_after_round_63 (meaningful only on
                last-round rows; unconstrained elsewhere)
  car[20]       carry bits: sched(2) | a'(3) | e'(3) | dg_a(3) | dg_e(3)
                | dg_b,c,d,f,g,h (1 each)

Fixed (preprocessed, never committed) columns (n_fixed = 6):
  K             round constant K_{t mod 64} as a field value
  sel_msg       1 on rows with t mod 64 < 16 (message injection rows)
  sel_sched     1 on rows whose NEXT row is a schedule row (15 <= t%64 <= 62)
  sel_last      1 on rows with t mod 64 == 63
  sel_first     1 on rows with t mod 64 == 0
  sel_chain     1 on last-round rows whose NEXT block chains from this
                block's digest (multi-block messages)

Digest bus (the CTL/lookup analog, via the stage-2 machinery in stark.py):
after the trace is committed the transcript yields r; a stage-2 accumulator
column acc folds the absorbed stream Horner-style:
  message rows:    acc' = acc*r + val(w_t)
  last-round rows: acc' = acc*r^8 + sum_j r^j val(dg_j)
and the final acc is pinned to C = the same fold of the CLAIMED
(message words, output states) in aux, which were observed before sampling
r. Schwartz-Zippel binds the committed hash computation to the claims.

The AIR proves, for every block b in the static layout: dg(b) =
compress(hin(b), w(b)) per FIPS 180-4, hin(b) = IV when block b starts a
message, hin(b) = dg(b-1) when it chains.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from blobstreamx_tpu_torch import native
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.golden import sha256 as gsha

from .air import Air, frame_block

P = gold.P
MASK32 = 0xFFFFFFFF
POW2 = [1 << i for i in range(32)]

# column offsets
N_WIN = 16
OFF_WIN = 0
OFF_ST = OFF_WIN + 32 * N_WIN  # 512
OFF_HIN = OFF_ST + 32 * 8  # 768
OFF_DG = OFF_HIN + 32 * 8  # 1024
OFF_CAR = OFF_DG + 32 * 8  # 1280
N_COLS = OFF_CAR + 20  # 1300

# carry sub-offsets within car
CAR_SCHED = 0  # 2 bits
CAR_A = 2  # 3 bits
CAR_E = 5  # 3 bits
CAR_DGA = 8  # 3 bits
CAR_DGE = 11  # 3 bits
CAR_DG1 = 14  # 6 bits: one for each of dg b,c,d,f,g,h

# fixed column indices
FX_K, FX_MSG, FX_SCHED, FX_LAST, FX_FIRST, FX_CHAIN = range(6)

ROUNDS = 64


def _word(cols, base):
    """32 consecutive algebra elements -> list of bit elements."""
    return [cols[base + i] for i in range(32)]


class Sha256Air(Air):
    """Batched SHA-256 compression AIR over a static block layout.

    chain[b] is True when block b continues the message of block b-1 (so
    hin(b) = dg(b-1)); chain[0] must be False. len(chain) = n_blocks must
    be a power of two (trace length 64*n_blocks)."""

    n_cols = N_COLS
    n_fixed = 6
    n_challenges = 9  # r, r^2 .. r^8, C
    n_stage2 = 1  # the digest-bus accumulator
    max_degree = 4  # xor3 (deg 3) gated by a fixed selector

    def __init__(self, chain: tuple[bool, ...]):
        n_blocks = len(chain)
        assert n_blocks >= 1 and n_blocks & (n_blocks - 1) == 0
        assert not chain[0], "block 0 cannot chain"
        self.chain = tuple(bool(c) for c in chain)

    def cache_key(self):
        return (type(self), self.chain)

    # ------------------------------------------------------------------ fixed
    def fixed_columns(self, n: int) -> np.ndarray:
        assert n == ROUNDS * len(self.chain)
        t = np.arange(n) % ROUNDS
        nxt_chain = np.roll(np.array(self.chain, bool), -1)  # block b+1 chains (cyclic)
        out = np.zeros((n, 6), dtype=np.uint64)
        out[:, FX_K] = np.array(gsha.k_constants(), np.uint64)[t]
        out[:, FX_MSG] = t < 16
        out[:, FX_SCHED] = (15 <= t) & (t <= 62)
        out[:, FX_LAST] = t == ROUNDS - 1
        out[:, FX_FIRST] = t == 0
        out[:, FX_CHAIN] = (t == ROUNDS - 1) & np.repeat(nxt_chain, ROUNDS)
        return out

    # ----------------------------------------------------------------- bus
    def observe_aux(self, challenger, aux) -> None:
        """aux: list per block of (w_words[16], out_words[8])."""
        for w_words, out_words in aux:
            challenger.observe_many([int(v) & MASK32 for v in w_words])
            challenger.observe_many([int(v) & MASK32 for v in out_words])

    def sample_challenges(self, challenger, aux) -> list[int]:
        r = challenger.sample()
        rp = [r]
        for _ in range(7):
            rp.append(gold.mul(rp[-1], r))
        c = fold_claims(aux, r)
        return rp + [c]

    def build_stage2(self, trace: np.ndarray, challenges: list[int], aux) -> np.ndarray:
        r = challenges[0]
        r8 = challenges[7]
        r_pows = [pow(r, j, P) for j in range(8)]
        n = trace.shape[0]
        blocks = trace.reshape(n // ROUNDS, ROUNDS, -1)
        # the words the bus absorbs, read from the trace's bit columns: w_t on
        # the 16 message rows, the 8 digest words on the last-round row
        w_words = _words(blocks[:, :16, OFF_WIN : OFF_WIN + 32])
        dg_words = _words(blocks[:, ROUNDS - 1, OFF_DG : OFF_DG + 256].reshape(-1, 8, 32))
        acc = np.zeros((n // ROUNDS, ROUNDS), dtype=np.uint64)
        cur = 0
        for b in range(n // ROUNDS):
            for t in range(16):
                cur = (cur * r + int(w_words[b, t])) % P
                acc[b, t] = cur
            acc[b, 16 : ROUNDS - 1] = cur  # rows that absorb nothing carry acc
            fold = sum(rp * int(dg) for rp, dg in zip(r_pows, dg_words[b])) % P
            cur = (cur * r8 + fold) % P
            acc[b, ROUNDS - 1] = cur
        return acc.reshape(n, 1)

    # ----------------------------------------------------------- constraints
    # The 8 sections below split into 6 constraint groups (Air.
    # n_constraint_groups; the JAX package's grouping, kept so the two
    # packages evaluate the same programs): each group's temporaries are
    # freed before the next is evaluated, and the concatenation order is
    # IDENTICAL to the ungrouped list, so alpha assignment and proofs are
    # bit-exact.
    n_constraint_groups = 6

    _GROUPS = {0: (1,), 1: (2, 3), 2: (4,), 3: (5,), 4: (6, 7), 5: (8,)}

    def eval_constraints(self, local, nxt, publics, alg, **frame):
        return self._eval_sections(
            (1, 2, 3, 4, 5, 6, 7, 8), local, nxt, publics, alg, **frame
        )

    def eval_constraint_group(self, g, local, nxt, publics, alg, **frame):
        return self._eval_sections(
            self._GROUPS[g], local, nxt, publics, alg, **frame
        )

    def _eval_sections(
        self,
        sections,
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
        sections = set(sections)
        one = alg.const(1)
        K = fixed[FX_K]
        sel_msg_n = fixed_next[FX_MSG]
        sel_sched = fixed[FX_SCHED]
        sel_last = fixed[FX_LAST]
        sel_last_n = fixed_next[FX_LAST]
        sel_first = fixed[FX_FIRST]
        sel_chain = fixed[FX_CHAIN]
        r = challenges[0]
        r_pows = challenges[:8]  # r^1 .. r^8
        c_final = challenges[8]
        (acc,) = stage2
        (acc_n,) = stage2_next

        def M(base, src=local):
            return alg.stack(_word(src, base))

        def val(m):
            return alg.wsum(m, POW2)

        def xor3(x, y, z):
            # x+y+z - 2(xy+yz+zx) + 4xyz, elementwise (degree 3); doublings
            # are adds, not const-muls, to keep the quotient graph lean
            xy = alg.mul(x, y)
            yz = alg.mul(y, z)
            zx = alg.mul(z, x)
            s = alg.add(alg.add(x, y), z)
            p = alg.add(alg.add(xy, yz), zx)
            t = alg.mul(xy, z)
            t2 = alg.add(t, t)
            return alg.add(alg.sub(s, alg.add(p, p)), alg.add(t2, t2))

        def big_sigma(m, r1, r2, r3):
            return xor3(alg.rotr_bits(m, r1), alg.rotr_bits(m, r2), alg.rotr_bits(m, r3))

        def small_sigma(m, r1, r2, sh):
            return xor3(alg.rotr_bits(m, r1), alg.rotr_bits(m, r2), alg.shr_bits(m, sh))

        def carry_val(src, off, nbits):
            return alg.wsum(
                alg.stack([src[OFF_CAR + off + i] for i in range(nbits)]),
                [1 << (32 + i) for i in range(nbits)],
            )

        cs = []

        if 1 in sections:
            # 1. booleanity of every bit column (trace cols 0..1299)
            all_bits = frame_block(alg, local, 0, N_COLS)
            cs.append(
                (alg.mul(all_bits, alg.sub(all_bits, alg.const_row([1] * N_COLS))), "all")
            )

        if 2 in sections:
            # 2. window shift: win_next[j] = win[j-1], j = 1..15
            shift_next = alg.stack(
                [b for j in range(1, N_WIN) for b in _word(nxt, OFF_WIN + 32 * j)]
            )
            shift_cur = alg.stack(
                [b for j in range(0, N_WIN - 1) for b in _word(local, OFF_WIN + 32 * j)]
            )
            cs.append((alg.sub(shift_next, shift_cur), "transition"))

        if 3 in sections:
            # 3. message schedule: on rows whose next row is a schedule row,
            #    val(w0') + 2^32*val(c_sched') = sig1(win1) + win6 + sig0(win14) + win15
            w0n = val(M(OFF_WIN, nxt))
            csched_n = alg.wsum(
                alg.stack([nxt[OFF_CAR + CAR_SCHED + i] for i in range(2)]), [1 << 32, 1 << 33]
            )
            sched_rhs = alg.add(
                alg.add(val(small_sigma(M(OFF_WIN + 32 * 1), 17, 19, 10)), val(M(OFF_WIN + 32 * 6))),
                alg.add(val(small_sigma(M(OFF_WIN + 32 * 14), 7, 18, 3)), val(M(OFF_WIN + 32 * 15))),
            )
            cs.append(
                (alg.mul(sel_sched, alg.sub(alg.add(w0n, csched_n), sched_rhs)), "transition")
            )

        not_last = alg.sub(one, sel_last)
        if sections & {4, 5}:
            # shared by sections 4 and 5: the round-63 state and t1/t2
            a, b, c, d, e, f, g, h = (M(OFF_ST + 32 * j) for j in range(8))
            s1 = big_sigma(e, 6, 11, 25)
            # ch = e*f + (1-e)*g  ==  g + e*(f-g)
            ch = alg.add(g, alg.mul(e, alg.sub(f, g)))
            s0 = big_sigma(a, 2, 13, 22)
            # maj = ab + ac + bc - 2abc
            ab = alg.mul(a, b)
            abc = alg.mul(ab, c)
            maj = alg.sub(
                alg.add(ab, alg.add(alg.mul(a, c), alg.mul(b, c))), alg.add(abc, abc)
            )
            t1 = alg.add(
                alg.add(val(h), val(s1)), alg.add(alg.add(val(ch), K), val(M(OFF_WIN)))
            )
            t2 = alg.add(val(s0), val(maj))

        if 4 in sections:
            # 4. round update (rows that are not the last round of a block)
            a_next = val(M(OFF_ST + 32 * 0, nxt))
            e_next = val(M(OFF_ST + 32 * 4, nxt))
            cs.append(
                (
                    alg.mul(
                        not_last,
                        alg.sub(alg.add(a_next, carry_val(nxt, CAR_A, 3)), alg.add(t1, t2)),
                    ),
                    "transition",
                )
            )
            cs.append(
                (
                    alg.mul(
                        not_last,
                        alg.sub(alg.add(e_next, carry_val(nxt, CAR_E, 3)), alg.add(val(d), t1)),
                    ),
                    "transition",
                )
            )
            # rotations: b' = a, c' = b, d' = c, f' = e, g' = f, h' = g
            rot_next = alg.stack(
                [bit for j in (1, 2, 3, 5, 6, 7) for bit in _word(nxt, OFF_ST + 32 * j)]
            )
            rot_cur = alg.stack(
                [bit for j in (0, 1, 2, 4, 5, 6) for bit in _word(local, OFF_ST + 32 * j)]
            )
            cs.append(
                (alg.mul(alg.colv(not_last), alg.sub(rot_next, rot_cur)), "transition")
            )

        if 5 in sections:
            # 5. digest rows: dg = hin + state_after_round_63
            hin = [M(OFF_HIN + 32 * j) for j in range(8)]
            dgv = [val(M(OFF_DG + 32 * j)) for j in range(8)]
            post = {  # value of the post-round word, and its carry allocation
                0: (alg.add(t1, t2), CAR_DGA, 3),
                4: (alg.add(val(d), t1), CAR_DGE, 3),
                1: (val(a), CAR_DG1 + 0, 1),
                2: (val(b), CAR_DG1 + 1, 1),
                3: (val(c), CAR_DG1 + 2, 1),
                5: (val(e), CAR_DG1 + 3, 1),
                6: (val(f), CAR_DG1 + 4, 1),
                7: (val(g), CAR_DG1 + 5, 1),
            }
            for j in range(8):
                rhs, car_off, car_bits = post[j]
                cs.append(
                    (
                        alg.mul(
                            sel_last,
                            alg.sub(
                                alg.add(dgv[j], carry_val(local, car_off, car_bits)),
                                alg.add(val(hin[j]), rhs),
                            ),
                        ),
                        "transition",
                    )
                )
            # the global last row also carries a digest; enforce it there too
            for j in range(8):
                rhs, car_off, car_bits = post[j]
                cs.append(
                    (
                        alg.sub(
                            alg.add(dgv[j], carry_val(local, car_off, car_bits)),
                            alg.add(val(hin[j]), rhs),
                        ),
                        "last",
                    )
                )

        if sections & {6, 7}:
            hin_cur = alg.stack(
                [bit for j in range(8) for bit in _word(local, OFF_HIN + 32 * j)]
            )
            iv_bits = _iv_bits()

        if 6 in sections:
            # 6. chaining: hin constant within a block; at block boundaries the
            #    next hin is dg (chain) or IV (new message)
            hin_next = alg.stack([bit for j in range(8) for bit in _word(nxt, OFF_HIN + 32 * j)])
            dg_cur = alg.stack([bit for j in range(8) for bit in _word(local, OFF_DG + 32 * j)])
            cs.append((alg.mul(alg.colv(not_last), alg.sub(hin_next, hin_cur)), "transition"))
            boundary = alg.sub(
                alg.mul(alg.colv(sel_last), hin_next),
                alg.add(
                    alg.mul(alg.colv(sel_chain), dg_cur),
                    alg.mul(alg.colv(alg.sub(sel_last, sel_chain)), alg.const_row(iv_bits)),
                ),
            )
            cs.append((boundary, "transition"))

        if 7 in sections:
            # 7. first round of every block: working state = hin
            st_cur = alg.stack([bit for j in range(8) for bit in _word(local, OFF_ST + 32 * j)])
            cs.append((alg.mul(alg.colv(sel_first), alg.sub(st_cur, hin_cur)), "all"))
            # the very first block starts from the IV
            cs.append((alg.sub(hin_cur, alg.const_row(iv_bits)), "first"))

        if 8 in sections:
            # 8. digest bus (stage-2 accumulator)
            w0v = val(M(OFF_WIN, nxt))
            dg_fold_n = None
            for j in range(8):
                term = val(M(OFF_DG + 32 * j, nxt))
                if j > 0:
                    term = alg.mul(term, r_pows[j - 1])
                dg_fold_n = term if dg_fold_n is None else alg.add(dg_fold_n, term)
            sel_mid_n = alg.sub(alg.sub(one, sel_msg_n), sel_last_n)
            absorb = alg.add(
                alg.mul(sel_msg_n, alg.add(alg.mul(acc, r), w0v)),
                alg.add(
                    alg.mul(sel_last_n, alg.add(alg.mul(acc, r_pows[7]), dg_fold_n)),
                    alg.mul(sel_mid_n, acc),
                ),
            )
            cs.append((alg.sub(acc_n, absorb), "transition"))
            cs.append((alg.sub(acc, val(M(OFF_WIN))), "first"))
            cs.append((alg.sub(acc, c_final), "last"))

        return cs


# ---------------------------------------------------------------------------
# host-side witness generation and claim helpers
# ---------------------------------------------------------------------------


def _words(bits: np.ndarray) -> np.ndarray:
    """(..., 32) 0/1 LSB-first bit columns -> (...,) uint64 words."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=-1, dtype=np.uint64)


def _put_word(row: np.ndarray, base: int, w: int) -> None:
    for i in range(32):
        row[base + i] = (w >> i) & 1


@lru_cache(maxsize=1)
def _iv_bits() -> tuple[int, ...]:
    iv = gsha.h_constants()
    return tuple((iv[j] >> i) & 1 for j in range(8) for i in range(32))


def fold_claims(aux, r: int) -> int:
    """Horner fold of the absorbed stream; must match the AIR's absorb order:
    per block: w_0..w_15 then acc*r^8 + sum_j r^j out_j."""
    r8 = pow(r, 8, P)
    c = 0
    for w_words, out_words in aux:
        for w in w_words:
            c = (c * r + (w & MASK32)) % P
        fold = 0
        for j, dg in enumerate(out_words):
            fold = (fold + pow(r, j, P) * (dg & MASK32)) % P
        c = (c * r8 + fold) % P
    return c


def plan_blocks(messages: list[bytes]) -> tuple[tuple[bool, ...], list[bytes]]:
    """FIPS-pad each message and emit (chain flags, flat 64B block list),
    padding the block count to a power of two with standalone dummy blocks."""
    chain: list[bool] = []
    blocks: list[bytes] = []
    for msg in messages:
        padded = gsha.pad(msg)
        for i in range(0, len(padded), 64):
            blocks.append(padded[i : i + 64])
            chain.append(i > 0)
    n = max(1, 1 << (len(blocks) - 1).bit_length())
    while len(blocks) < n:
        blocks.append(gsha.pad(b""))
        chain.append(False)
    return tuple(chain), blocks


def _bits32(vals: np.ndarray) -> np.ndarray:
    """(...,) uint64 -> (..., 32) 0/1 uint64, LSB-first."""
    return (vals[..., None] >> np.arange(32, dtype=np.uint64)) & np.uint64(1)


def _rotr_v(x: np.ndarray, r: int) -> np.ndarray:
    return ((x >> np.uint64(r)) | (x << np.uint64(32 - r))) & np.uint64(MASK32)


def _compress_vec(hin: np.ndarray, w: np.ndarray):
    """Vectorized FIPS 180-4 compression over a group of blocks.

    hin (g, 8), w (g, 64), both uint64 words < 2^32. Returns
    (states (g, 64, 8) state at round start, car_a (g, 64), car_e (g, 64)
    carries stored at the row that holds them, dg_carr (g, 8), out (g, 8))."""
    K = gsha.k_constants()
    g = hin.shape[0]
    M = np.uint64(MASK32)
    states = np.zeros((g, 64, 8), np.uint64)
    car_a = np.zeros((g, 64), np.uint64)
    car_e = np.zeros((g, 64), np.uint64)
    s = [hin[:, j].copy() for j in range(8)]
    dg_carr = np.zeros((g, 8), np.uint64)
    out = np.zeros((g, 8), np.uint64)
    for t in range(ROUNDS):
        a, b, c, d, e, f, gg, h = s
        for j in range(8):
            states[:, t, j] = s[j]
        S1 = _rotr_v(e, 6) ^ _rotr_v(e, 11) ^ _rotr_v(e, 25)
        ch = (e & f) ^ ((e ^ M) & gg)
        t1_full = h + S1 + ch + np.uint64(K[t]) + w[:, t]
        S0 = _rotr_v(a, 2) ^ _rotr_v(a, 13) ^ _rotr_v(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2_full = S0 + maj
        if t < ROUNDS - 1:
            a_full = t1_full + t2_full
            e_full = d + t1_full
            car_a[:, t + 1] = a_full >> np.uint64(32)
            car_e[:, t + 1] = e_full >> np.uint64(32)
        else:
            full_rhs = [
                hin[:, 0] + t1_full + t2_full,
                hin[:, 1] + a,
                hin[:, 2] + b,
                hin[:, 3] + c,
                hin[:, 4] + d + t1_full,
                hin[:, 5] + e,
                hin[:, 6] + f,
                hin[:, 7] + gg,
            ]
            for j in range(8):
                dg_carr[:, j] = full_rhs[j] >> np.uint64(32)
                out[:, j] = full_rhs[j] & M
        s = [(t1_full + t2_full) & M, a, b, c, (d + t1_full) & M, e, f, gg]
    return states, car_a, car_e, dg_carr, out


def build_sha_trace(chain: tuple[bool, ...], blocks: list[bytes]):
    """Execution trace + aux claims for the given block layout, filled by
    the native C builder (blobstreamx_tpu_torch.native, built at first use;
    a failed build raises). _build_sha_trace_numpy is its plain version and
    the scalar build_sha_trace_ref the independent oracle.

    Returns (trace (64*n_blocks, N_COLS) uint64, aux list of
    (w_words[16], out_words[8]) per block)."""
    assert len(blocks) == len(chain)
    return native.sha_trace_fill(chain, blocks)


def _build_sha_trace_numpy(chain: tuple[bool, ...], blocks: list[bytes]):
    """Vectorized numpy trace builder over the blocks: the plain version the
    native builder is held to (tests, chip_smoke.py); the main path does not
    call it."""
    assert len(blocks) == len(chain)
    B = len(blocks)
    n = ROUNDS * B
    M = np.uint64(MASK32)

    # message schedule for every block
    blk_words = np.frombuffer(b"".join(blocks), dtype=">u4").reshape(B, 16)
    w = np.zeros((B, ROUNDS), np.uint64)
    w[:, :16] = blk_words
    sched_carry = np.zeros((B, ROUNDS), np.uint64)
    for t in range(16, ROUNDS):
        x = w[:, t - 15]
        s0 = _rotr_v(x, 7) ^ _rotr_v(x, 18) ^ (x >> np.uint64(3))
        y = w[:, t - 2]
        s1 = _rotr_v(y, 17) ^ _rotr_v(y, 19) ^ (y >> np.uint64(10))
        full = w[:, t - 16] + s0 + w[:, t - 7] + s1
        w[:, t] = full & M
        sched_carry[:, t] = full >> np.uint64(32)

    # chain depth of every block; blocks at depth d need depth d-1 digests
    depth = []
    cur = 0
    for c in chain:
        cur = cur + 1 if c else 0
        depth.append(cur)
    hin_all = np.zeros((B, 8), np.uint64)
    out_all = np.zeros((B, 8), np.uint64)
    st_all = np.zeros((B, ROUNDS, 8), np.uint64)
    car_a_all = np.zeros((B, ROUNDS), np.uint64)
    car_e_all = np.zeros((B, ROUNDS), np.uint64)
    dgc_all = np.zeros((B, 8), np.uint64)
    iv = np.array(gsha.h_constants(), np.uint64)
    for d in range(max(depth) + 1):
        idx = np.array([b for b in range(B) if depth[b] == d], np.int64)
        if idx.size == 0:
            continue
        hin = iv[None, :].repeat(idx.size, 0) if d == 0 else out_all[idx - 1]
        states, car_a, car_e, dg_carr, out = _compress_vec(hin, w[idx])
        hin_all[idx] = hin
        out_all[idx] = out
        st_all[idx] = states
        car_a_all[idx] = car_a
        car_e_all[idx] = car_e
        dgc_all[idx] = dg_carr

    trace = np.zeros((n, N_COLS), np.uint64)
    w_flat = w.reshape(-1)
    for j in range(N_WIN):
        shifted = np.zeros(n, np.uint64)
        shifted[j:] = w_flat[: n - j]
        trace[:, OFF_WIN + 32 * j : OFF_WIN + 32 * (j + 1)] = _bits32(shifted)
    st_flat = st_all.reshape(n, 8)
    hin_rows = np.repeat(hin_all, ROUNDS, axis=0)
    for j in range(8):
        trace[:, OFF_ST + 32 * j : OFF_ST + 32 * (j + 1)] = _bits32(st_flat[:, j])
        trace[:, OFF_HIN + 32 * j : OFF_HIN + 32 * (j + 1)] = _bits32(hin_rows[:, j])
        dg_col = np.zeros(n, np.uint64)
        dg_col[ROUNDS - 1 :: ROUNDS] = out_all[:, j]
        trace[:, OFF_DG + 32 * j : OFF_DG + 32 * (j + 1)] = _bits32(dg_col)
    sc = sched_carry.reshape(-1)
    trace[:, OFF_CAR + CAR_SCHED] = sc & np.uint64(1)
    trace[:, OFF_CAR + CAR_SCHED + 1] = (sc >> np.uint64(1)) & np.uint64(1)
    ca = car_a_all.reshape(-1)
    ce = car_e_all.reshape(-1)
    for i in range(3):
        trace[:, OFF_CAR + CAR_A + i] = (ca >> np.uint64(i)) & np.uint64(1)
        trace[:, OFF_CAR + CAR_E + i] = (ce >> np.uint64(i)) & np.uint64(1)
        trace[ROUNDS - 1 :: ROUNDS, OFF_CAR + CAR_DGA + i] = (
            dgc_all[:, 0] >> np.uint64(i)
        ) & np.uint64(1)
        trace[ROUNDS - 1 :: ROUNDS, OFF_CAR + CAR_DGE + i] = (
            dgc_all[:, 4] >> np.uint64(i)
        ) & np.uint64(1)
    for slot, jw in enumerate((1, 2, 3, 5, 6, 7)):
        trace[ROUNDS - 1 :: ROUNDS, OFF_CAR + CAR_DG1 + slot] = dgc_all[:, jw] & np.uint64(1)

    aux = [
        (tuple(int(v) for v in w[b, :16]), tuple(int(v) for v in out_all[b]))
        for b in range(B)
    ]
    return trace, aux


def build_sha_trace_ref(chain: tuple[bool, ...], blocks: list[bytes]):
    """Scalar reference trace builder (one bit at a time; kept as the
    independent oracle for the vectorized builder)."""
    assert len(blocks) == len(chain)
    K = gsha.k_constants()
    n = ROUNDS * len(blocks)
    trace = np.zeros((n, N_COLS), dtype=np.uint64)
    aux = []
    w_global: list[int] = []  # concatenated schedule words across blocks
    state = gsha.h_constants()
    for b, block in enumerate(blocks):
        if not chain[b]:
            state = gsha.h_constants()
        hin = state
        w = [int.from_bytes(block[i * 4 : i * 4 + 4], "big") for i in range(16)]
        for t in range(16, ROUNDS):
            s0 = gsha._rotr(w[t - 15], 7) ^ gsha._rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
            s1 = gsha._rotr(w[t - 2], 17) ^ gsha._rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & MASK32)
            # schedule carry: integer sum before masking
            full = w[t - 16] + s0 + w[t - 7] + s1
            row = ROUNDS * b + t
            carry = full >> 32
            trace[row, OFF_CAR + CAR_SCHED] = carry & 1
            trace[row, OFF_CAR + CAR_SCHED + 1] = (carry >> 1) & 1
        a, b2, c, d, e, f, g, h = hin
        for t in range(ROUNDS):
            row = ROUNDS * b + t
            # window: win[j] = w_global[row - j] pattern — within this block
            # win[j] = w[t-j]; for t-j < 0 the shifted-in value from the
            # previous block's tail (or 0 for the very first rows)
            w_global.append(w[t])
            for j in range(N_WIN):
                gidx = row - j
                wv = w_global[gidx] if gidx >= 0 else 0
                _put_word(trace[row], OFF_WIN + 32 * j, wv)
            for jw, wv in enumerate((a, b2, c, d, e, f, g, h)):
                _put_word(trace[row], OFF_ST + 32 * jw, wv)
            for jw in range(8):
                _put_word(trace[row], OFF_HIN + 32 * jw, hin[jw])
            # round update
            S1 = gsha._rotr(e, 6) ^ gsha._rotr(e, 11) ^ gsha._rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1_full = h + S1 + ch + K[t] + w[t]
            S0 = gsha._rotr(a, 2) ^ gsha._rotr(a, 13) ^ gsha._rotr(a, 22)
            maj = (a & b2) ^ (a & c) ^ (b2 & c)
            t2_full = S0 + maj
            if t < ROUNDS - 1:
                a_full = t1_full + t2_full
                e_full = d + t1_full
                nrow = row + 1
                for i in range(3):
                    trace[nrow, OFF_CAR + CAR_A + i] = (a_full >> (32 + i)) & 1
                    trace[nrow, OFF_CAR + CAR_E + i] = (e_full >> (32 + i)) & 1
            else:
                # digest row: dg = hin + post-round state, with carries
                post = [
                    (t1_full + t2_full) & MASK32,
                    a,
                    b2,
                    c,
                    (d + t1_full) & MASK32,
                    e,
                    f,
                    g,
                ]
                # the dg sums re-derive the unmasked values in-constraint:
                full_rhs = [
                    hin[0] + t1_full + t2_full,
                    hin[1] + a,
                    hin[2] + b2,
                    hin[3] + c,
                    hin[4] + d + t1_full,
                    hin[5] + e,
                    hin[6] + f,
                    hin[7] + g,
                ]
                out = [(hin[jw] + post[jw]) & MASK32 for jw in range(8)]
                for jw in range(8):
                    _put_word(trace[row], OFF_DG + 32 * jw, out[jw])
                carr = [full_rhs[jw] >> 32 for jw in range(8)]
                for i in range(3):
                    trace[row, OFF_CAR + CAR_DGA + i] = (carr[0] >> i) & 1
                    trace[row, OFF_CAR + CAR_DGE + i] = (carr[4] >> i) & 1
                for slot, jw in enumerate((1, 2, 3, 5, 6, 7)):
                    trace[row, OFF_CAR + CAR_DG1 + slot] = carr[jw] & 1
            a, b2, c, d, e, f, g, h = (
                (t1_full + t2_full) & MASK32,
                a,
                b2,
                c,
                (d + t1_full) & MASK32,
                e,
                f,
                g,
            )
        out_state = tuple((hin[jw] + s) & MASK32 for jw, s in enumerate((a, b2, c, d, e, f, g, h)))
        aux.append((tuple(w[:16]), out_state))
        state = out_state
    return trace, aux


def digests_from_aux(chain: tuple[bool, ...], aux) -> list[bytes]:
    """The digest of each message = out_words of its LAST block."""
    out = []
    for b in range(len(chain)):
        is_msg_end = b + 1 >= len(chain) or not chain[b + 1]
        if is_msg_end:
            out.append(b"".join(int(w).to_bytes(4, "big") for w in aux[b][1]))
    return out
