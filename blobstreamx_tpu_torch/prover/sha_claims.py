"""Binding the SHA-256 auxiliary STARK (prover.sha_air) to Tendermint hash
workloads (upstream's circuit consumed batched SHA claims; here the HOST
verifier plays the circuit's role, checking that the claimed (message,
digest) pairs assemble into the exact RFC-6962/Tendermint tree whose root is
the public data commitment, while the STARK proves every digest claim —
the verifier itself never hashes).

Message enumeration follows golden.merkle.simple_hash_from_byte_slices's
recursion (DFS post-order, split at the largest power of two < n), so the
verifier walks the same recursion, rebuilding every expected message from
the digests CLAIMED for its children and checking the block claims (with
their full FIPS padding) against it.
"""

from __future__ import annotations

from dataclasses import dataclass

from blobstreamx_tpu_torch.golden import merkle as gmerkle
from blobstreamx_tpu_torch.golden import sha256 as gsha
from blobstreamx_tpu_torch.prover import sha_air, stark, stark_stream
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.utils.timing import maybe_scope

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"


def tuple_tree_messages(heights: list[int], data_hashes: list[bytes]) -> tuple[list[bytes], bytes]:
    """DFS post-order message list of the data-commitment tuple tree, plus
    the root (golden-computed on the prover side; the STARK re-proves every
    hash and the verifier re-derives the structure from claims alone)."""
    leaves = [gmerkle.data_root_tuple(h, d) for h, d in zip(heights, data_hashes)]
    messages: list[bytes] = []

    def walk(lo: int, hi: int) -> bytes:
        n = hi - lo
        if n == 1:
            msg = LEAF_PREFIX + leaves[lo]
            messages.append(msg)
            return gsha.sha256(msg)
        k = gmerkle._split_point(n)
        left = walk(lo, lo + k)
        right = walk(lo + k, hi)
        msg = INNER_PREFIX + left + right
        messages.append(msg)
        return gsha.sha256(msg)

    root = walk(0, len(leaves))
    return messages, root


@dataclass
class ShaStarkProof:
    """A batched-SHA STARK plus its claims. The chain layout and every
    expected message are recomputed by the verifier, so neither is
    attacker-controlled."""

    stark: stark.StarkProof
    aux: list  # per block: (w_words[16], out_words[8])
    n_rows: int


def _expected_chain(n_leaves: int) -> tuple[bool, ...]:
    """Every tuple-tree message is 65 bytes = exactly 2 blocks."""
    n_msgs = 2 * n_leaves - 1 if n_leaves else 0
    chain: list[bool] = []
    for _ in range(n_msgs):
        chain += [False, True]
    n_blk = max(1, 1 << (len(chain) - 1).bit_length()) if chain else 1
    chain += [False] * (n_blk - len(chain))
    return tuple(chain)


def _pad_words(message: bytes) -> list[list[int]]:
    padded = gsha.pad(message)
    return [
        [int.from_bytes(padded[64 * i + 4 * j : 64 * i + 4 * j + 4], "big") for j in range(16)]
        for i in range(len(padded) // 64)
    ]


def prove_data_commitment_stark(
    heights: list[int],
    data_hashes: list[bytes],
    config: StarkConfig | None = None,
    device=None,
    timing=None,
) -> tuple[ShaStarkProof, bytes]:
    """Prove every SHA-256 of the data-commitment tuple tree in one batched
    STARK on `device` (default: the card). Returns (proof, root).
    timing: a TimingTree that the host trace build and the streaming
    prover's phases are added to."""
    config = config or StarkConfig(rate_bits=2)
    with maybe_scope(timing, "host trace"):
        messages, root = tuple_tree_messages(heights, data_hashes)
        chain, blocks = sha_air.plan_blocks(messages)
        assert chain == _expected_chain(len(heights))
        trace, aux = sha_air.build_sha_trace(chain, blocks)
    air = sha_air.Sha256Air(chain)
    proof = stark_stream.prove_auto(air, trace, [], config, aux=aux, device=device, timing=timing)
    return ShaStarkProof(stark=proof, aux=aux, n_rows=trace.shape[0]), root


def verify_data_commitment_stark(
    proof: ShaStarkProof,
    heights: list[int],
    data_hashes: list[bytes],
    root: bytes,
    config: StarkConfig | None = None,
) -> bool:
    """Host verifier: (a) the claims assemble into the tuple tree over
    (heights, data_hashes); (b) its root equals `root`; (c) the STARK holds
    for the claimed (message, digest) pairs. The verifier computes no
    hashes — inner messages are rebuilt from the CLAIMED child digests. The
    claim walk (host arithmetic) runs before the STARK check (the pure-Python
    transcript and Merkle paths, about a minute at 2^18 rows), so a wrong
    claim fails fast; the verdict needs all three either way."""
    config = config or StarkConfig(rate_bits=2)
    leaves = [gmerkle.data_root_tuple(h, d) for h, d in zip(heights, data_hashes)]
    chain = _expected_chain(len(leaves))
    if proof.n_rows != 64 * len(chain) or len(proof.aux) != len(chain):
        return False

    state = {"b": 0}

    def claim_digest(expected_msg: bytes) -> bytes | None:
        """Consume this message's blocks, checking the claimed words equal
        the FIPS-padded expected message; return its claimed digest."""
        for i, want in enumerate(_pad_words(expected_msg)):
            b = state["b"]
            if b >= len(chain) or chain[b] != (i > 0):
                return None
            if [int(w) for w in proof.aux[b][0]] != want:
                return None
            state["b"] += 1
        out = proof.aux[state["b"] - 1][1]
        return b"".join(int(w).to_bytes(4, "big") for w in out)

    def walk(lo: int, hi: int) -> bytes | None:
        n = hi - lo
        if n == 1:
            return claim_digest(LEAF_PREFIX + leaves[lo])
        k = gmerkle._split_point(n)
        left = walk(lo, lo + k)
        if left is None:
            return None
        right = walk(lo + k, hi)
        if right is None:
            return None
        return claim_digest(INNER_PREFIX + left + right)

    if not leaves:
        return False
    got_root = walk(0, len(leaves))
    if got_root is None or got_root != root:
        return False

    # trailing dummy blocks must be standalone empty-message blocks
    empty_words = _pad_words(b"")[0]
    while state["b"] < len(chain):
        b = state["b"]
        if chain[b] or [int(w) for w in proof.aux[b][0]] != empty_words:
            return False
        state["b"] += 1
    air = sha_air.Sha256Air(chain)
    return stark.verify(air, proof.stark, [], config, proof.n_rows, aux=proof.aux)
