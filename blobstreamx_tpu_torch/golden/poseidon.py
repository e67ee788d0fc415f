"""Pure-Python golden model of the Poseidon permutation over Goldilocks.

Parameters (width 12, 8 full + 22 partial rounds, x^7 S-box) follow the
published plonky2 Poseidon instantiation named in BASELINE.json:5,8.
The mounted reference snapshot contains no code (SURVEY.md §0), so round
constants are re-derived from the *published specification*: the Grain-LFSR
procedure of the Poseidon paper (GKRRS19, §B / reference `generate_parameters_grain.sage`)
with parameters ``1 0 64 12 8 22`` over p = 2^64 - 2^32 + 1, which is how the
upstream's constants were generated. The MDS matrix is the circulant-plus-
diagonal power-of-two matrix published in plonky2's `poseidon.rs`.

Bit-exactness contract: every device kernel (blobstreamx_tpu_torch.ops.poseidon)
must reproduce this model exactly (SURVEY.md §4.3 item 2; config 2 at
BASELINE.json:8).
"""

from __future__ import annotations

from functools import lru_cache

from .goldilocks import P, add, exp, mul

WIDTH = 12
FULL_ROUNDS = 8  # 4 at the start + 4 at the end
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
SBOX_EXP = 7

# Sponge parameters: rate 8, capacity 4, digest 4 (plonky2 PoseidonHash layout).
RATE = 8
CAPACITY = 4
DIGEST = 4

# Circulant row + diagonal extra, all small powers of two (fast MDS evaluation):
# out[r] = sum_i CIRC[i] * state[(i + r) % 12] + DIAG[r] * state[r]
MDS_CIRC = (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)
MDS_DIAG = (8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)


# ----------------------------------------------------------------------------
# Grain LFSR round-constant generation (Poseidon paper, Appendix B).
# ----------------------------------------------------------------------------


def _grain_bits(n_bits: int, t: int, r_f: int, r_p: int):
    """Infinite bit generator: 80-bit Grain LFSR with shrinking self-decimation."""
    state = []

    def append(val: int, width: int) -> None:
        for i in range(width - 1, -1, -1):
            state.append((val >> i) & 1)

    append(1, 2)  # field descriptor: prime field
    append(0, 4)  # S-box descriptor: x^alpha
    append(n_bits, 12)
    append(t, 12)
    append(r_f, 10)
    append(r_p, 10)
    append((1 << 30) - 1, 30)
    assert len(state) == 80

    def step() -> int:
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):  # discard initialization output
        step()

    while True:
        # Shrinking generator: emit the second bit of a pair iff the first is 1.
        if step() == 1:
            yield step()
        else:
            step()


@lru_cache(maxsize=None)
def round_constants(
    width: int = WIDTH,
    full_rounds: int = FULL_ROUNDS,
    partial_rounds: int = PARTIAL_ROUNDS,
    n_bits: int = 64,
    p: int = P,
) -> tuple[int, ...]:
    """All width*(full+partial) round constants, rejection-sampled < p."""
    bits = _grain_bits(n_bits, width, full_rounds, partial_rounds)
    out = []
    need = width * (full_rounds + partial_rounds)
    while len(out) < need:
        v = 0
        for _ in range(n_bits):
            v = (v << 1) | next(bits)
        if v < p:
            out.append(v)
    return tuple(out)


# ----------------------------------------------------------------------------
# Permutation
# ----------------------------------------------------------------------------


def _sbox(x: int) -> int:
    return exp(x, SBOX_EXP)


def _mds(state: list[int]) -> list[int]:
    out = []
    for r in range(WIDTH):
        acc = 0
        for i in range(WIDTH):
            acc += MDS_CIRC[i] * state[(i + r) % WIDTH]
        acc += MDS_DIAG[r] * state[r]
        out.append(acc % P)
    return out


def permute(state: list[int] | tuple[int, ...]) -> list[int]:
    """One Poseidon permutation of a width-12 state. Input/output canonical ints."""
    assert len(state) == WIDTH
    s = [x % P for x in state]
    rc = round_constants()
    half = FULL_ROUNDS // 2
    ctr = 0
    for _ in range(half):
        s = [add(x, rc[ctr * WIDTH + i]) for i, x in enumerate(s)]
        s = [_sbox(x) for x in s]
        s = _mds(s)
        ctr += 1
    for _ in range(PARTIAL_ROUNDS):
        s = [add(x, rc[ctr * WIDTH + i]) for i, x in enumerate(s)]
        s[0] = _sbox(s[0])
        s = _mds(s)
        ctr += 1
    for _ in range(half):
        s = [add(x, rc[ctr * WIDTH + i]) for i, x in enumerate(s)]
        s = [_sbox(x) for x in s]
        s = _mds(s)
        ctr += 1
    assert ctr == N_ROUNDS
    return s


# ----------------------------------------------------------------------------
# Hashing (sponge, rate 8 / capacity 4) — the prover's Merkle + Fiat-Shamir hash.
# ----------------------------------------------------------------------------


def hash_n_to_m_no_pad(inputs: list[int], num_outputs: int = DIGEST) -> list[int]:
    """Sponge over chunks of RATE elements, no padding (fixed-length inputs)."""
    state = [0] * WIDTH
    for start in range(0, len(inputs), RATE):
        chunk = inputs[start : start + RATE]
        for i, x in enumerate(chunk):
            state[i] = x % P
        state = permute(state)
    outputs = []
    while True:
        for x in state[:RATE]:
            outputs.append(x)
            if len(outputs) == num_outputs:
                return outputs
        state = permute(state)


def hash_no_pad(inputs: list[int]) -> list[int]:
    return hash_n_to_m_no_pad(inputs, DIGEST)


def two_to_one(left: list[int], right: list[int]) -> list[int]:
    """Merkle compression: state = [left(4) | right(4) | 0(4)], one permutation."""
    assert len(left) == DIGEST and len(right) == DIGEST
    state = list(left) + list(right) + [0] * CAPACITY
    state = permute(state)
    return state[:DIGEST]
