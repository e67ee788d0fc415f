"""The Poseidon permutation over Goldilocks (width 12, 8 full and 22 partial
rounds, x^7 S-box) and its rate-8 sponge, in plain Python integers.

Round constants come from the Grain LFSR of the Poseidon paper (GKRRS19,
appendix B) with parameters 1 0 64 12 8 22 over p; the MDS matrix is
plonky2's circulant-plus-diagonal matrix of powers of two.
"""

from __future__ import annotations

from functools import lru_cache

from .goldilocks import P

WIDTH = 12
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 22
N_ROUNDS = FULL_ROUNDS + PARTIAL_ROUNDS
RATE = 8
CAPACITY = 4
DIGEST = 4

MDS_CIRC = (1, 1, 2, 1, 8, 32, 2, 256, 4096, 8, 65536, 1024)
MDS_DIAG = (8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)

# row r of the MDS matrix as (coefficient, state index) pairs
_MDS_ROWS = tuple(
    tuple(
        (MDS_CIRC[(j - r) % WIDTH] + (MDS_DIAG[r] if j == r else 0), j)
        for j in range(WIDTH)
    )
    for r in range(WIDTH)
)


def _grain_bits(n_bits: int, t: int, r_f: int, r_p: int):
    state = []

    def append(val: int, width: int) -> None:
        for i in range(width - 1, -1, -1):
            state.append((val >> i) & 1)

    append(1, 2)
    append(0, 4)
    append(n_bits, 12)
    append(t, 12)
    append(r_f, 10)
    append(r_p, 10)
    append((1 << 30) - 1, 30)

    def step() -> int:
        new = state[62] ^ state[51] ^ state[38] ^ state[23] ^ state[13] ^ state[0]
        state.pop(0)
        state.append(new)
        return new

    for _ in range(160):
        step()
    while True:
        if step() == 1:
            yield step()
        else:
            step()


@lru_cache(maxsize=None)
def round_constants() -> tuple[int, ...]:
    bits = _grain_bits(64, WIDTH, FULL_ROUNDS, PARTIAL_ROUNDS)
    out = []
    while len(out) < WIDTH * N_ROUNDS:
        v = 0
        for _ in range(64):
            v = (v << 1) | next(bits)
        if v < P:
            out.append(v)
    return tuple(out)


def mds_table(s: list[int]) -> list[int]:
    """The MDS layer by its definition: out[r] = sum_i CIRC[i] s[(i + r) % 12]
    + DIAG[r] s[r]."""
    return [sum(c * s[j] for c, j in row) % P for row in _MDS_ROWS]


def _mds(s: list[int]) -> list[int]:
    """mds_table written out, row by row (the verifier's hot loop)."""
    s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11 = s
    return [
        (9 * s0 + s1 + 2 * s2 + s3 + 8 * s4 + 32 * s5 + 2 * s6 + 256 * s7 + 4096 * s8 + 8 * s9 + 65536 * s10 + 1024 * s11) % P,
        (1024 * s0 + s1 + s2 + 2 * s3 + s4 + 8 * s5 + 32 * s6 + 2 * s7 + 256 * s8 + 4096 * s9 + 8 * s10 + 65536 * s11) % P,
        (65536 * s0 + 1024 * s1 + s2 + s3 + 2 * s4 + s5 + 8 * s6 + 32 * s7 + 2 * s8 + 256 * s9 + 4096 * s10 + 8 * s11) % P,
        (8 * s0 + 65536 * s1 + 1024 * s2 + s3 + s4 + 2 * s5 + s6 + 8 * s7 + 32 * s8 + 2 * s9 + 256 * s10 + 4096 * s11) % P,
        (4096 * s0 + 8 * s1 + 65536 * s2 + 1024 * s3 + s4 + s5 + 2 * s6 + s7 + 8 * s8 + 32 * s9 + 2 * s10 + 256 * s11) % P,
        (256 * s0 + 4096 * s1 + 8 * s2 + 65536 * s3 + 1024 * s4 + s5 + s6 + 2 * s7 + s8 + 8 * s9 + 32 * s10 + 2 * s11) % P,
        (2 * s0 + 256 * s1 + 4096 * s2 + 8 * s3 + 65536 * s4 + 1024 * s5 + s6 + s7 + 2 * s8 + s9 + 8 * s10 + 32 * s11) % P,
        (32 * s0 + 2 * s1 + 256 * s2 + 4096 * s3 + 8 * s4 + 65536 * s5 + 1024 * s6 + s7 + s8 + 2 * s9 + s10 + 8 * s11) % P,
        (8 * s0 + 32 * s1 + 2 * s2 + 256 * s3 + 4096 * s4 + 8 * s5 + 65536 * s6 + 1024 * s7 + s8 + s9 + 2 * s10 + s11) % P,
        (s0 + 8 * s1 + 32 * s2 + 2 * s3 + 256 * s4 + 4096 * s5 + 8 * s6 + 65536 * s7 + 1024 * s8 + s9 + s10 + 2 * s11) % P,
        (2 * s0 + s1 + 8 * s2 + 32 * s3 + 2 * s4 + 256 * s5 + 4096 * s6 + 8 * s7 + 65536 * s8 + 1024 * s9 + s10 + s11) % P,
        (s0 + 2 * s1 + s2 + 8 * s3 + 32 * s4 + 2 * s5 + 256 * s6 + 4096 * s7 + 8 * s8 + 65536 * s9 + 1024 * s10 + s11) % P,
    ]


def permute(state) -> list[int]:
    s = [x % P for x in state]
    rc = round_constants()
    half = FULL_ROUNDS // 2
    for r in range(N_ROUNDS):
        base = r * WIDTH
        s = [(x + c) % P for x, c in zip(s, rc[base : base + WIDTH])]
        if r < half or r >= half + PARTIAL_ROUNDS:
            s = [pow(x, 7, P) for x in s]
        else:
            s[0] = pow(s[0], 7, P)
        s = _mds(s)
    return s


def hash_no_pad(inputs: list[int]) -> list[int]:
    """Sponge over chunks of RATE elements (no padding), DIGEST outputs."""
    state = [0] * WIDTH
    for start in range(0, len(inputs), RATE):
        for i, x in enumerate(inputs[start : start + RATE]):
            state[i] = x % P
        state = permute(state)
    return state[:DIGEST]


def two_to_one(left: list[int], right: list[int]) -> list[int]:
    return permute(list(left) + list(right) + [0] * CAPACITY)[:DIGEST]


def verify_path(cap: list[list[int]], leaf: list[int], index: int, path: list[list[int]]) -> bool:
    """A Poseidon Merkle opening of `leaf` at `index` under a tree cap."""
    digest = hash_no_pad(leaf)
    idx = index
    for sibling in path:
        digest = two_to_one(sibling, digest) if idx & 1 else two_to_one(digest, sibling)
        idx >>= 1
    return idx < len(cap) and digest == list(cap[idx])
