"""Pure-Python golden models of the two Merkle tree families.

1. Tendermint/Celestia SHA-256 trees (RFC 6962 domain separation: 0x00 leaf
   prefix, 0x01 inner prefix; split at the largest power of two < n), including
   the 64-byte DataRootTuple leaves (32 B big-endian height ‖ 32 B data hash)
   — config 1 at BASELINE.json:7, components C5/C14 in SURVEY.md §2.2.

2. Prover-side Poseidon trees with `cap_height` caps (component C5a) used to
   commit to LDE matrices.
"""

from __future__ import annotations

from .poseidon import DIGEST, hash_no_pad, two_to_one
from .sha256 import sha256

LEAF_PREFIX = b"\x00"
INNER_PREFIX = b"\x01"
EMPTY_HASH = sha256(b"")


def leaf_hash(leaf: bytes) -> bytes:
    return sha256(LEAF_PREFIX + leaf)


def inner_hash(left: bytes, right: bytes) -> bytes:
    return sha256(INNER_PREFIX + left + right)


def _split_point(n: int) -> int:
    """Largest power of two strictly less than n (RFC 6962 §2.1)."""
    assert n > 1
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def simple_hash_from_byte_slices(leaves: list[bytes]) -> bytes:
    """Tendermint SimpleMerkle root (handles non-power-of-two leaf counts)."""
    n = len(leaves)
    if n == 0:
        return EMPTY_HASH
    if n == 1:
        return leaf_hash(leaves[0])
    k = _split_point(n)
    return inner_hash(
        simple_hash_from_byte_slices(leaves[:k]),
        simple_hash_from_byte_slices(leaves[k:]),
    )


def data_root_tuple(height: int, data_hash: bytes) -> bytes:
    """64-byte DataRootTuple leaf: uint256-BE height ‖ 32-byte data hash."""
    assert len(data_hash) == 32
    return height.to_bytes(32, "big") + data_hash


def data_commitment(heights: list[int], data_hashes: list[bytes]) -> bytes:
    """SHA-256 Merkle root over DataRootTuple leaves for a header range (C14)."""
    leaves = [data_root_tuple(h, d) for h, d in zip(heights, data_hashes)]
    return simple_hash_from_byte_slices(leaves)


def merkle_proof(leaves: list[bytes], index: int) -> list[bytes]:
    """Audit path (sibling hashes, leaf-to-root) in the RFC 6962 tree."""
    n = len(leaves)
    assert 0 <= index < n
    if n == 1:
        return []
    k = _split_point(n)
    if index < k:
        return merkle_proof(leaves[:k], index) + [simple_hash_from_byte_slices(leaves[k:])]
    return merkle_proof(leaves[k:], index - k) + [simple_hash_from_byte_slices(leaves[:k])]


def verify_merkle_proof(root: bytes, leaf: bytes, index: int, total: int, path: list[bytes]) -> bool:
    def compute(idx: int, n: int, depth: int) -> bytes:
        if n == 1:
            return leaf_hash(leaf)
        k = _split_point(n)
        if idx < k:
            left = compute(idx, k, depth - 1)
            return inner_hash(left, path[depth - 1])
        right = compute(idx - k, n - k, depth - 1)
        return inner_hash(path[depth - 1], right)

    return compute(index, total, len(path)) == root


# ----------------------------------------------------------------------------
# Poseidon prover trees with caps (plonky2 MerkleTree/MerkleCap layout):
# power-of-two leaf count; the tree is truncated at height `cap_height`, the
# commitment is the list of 2^cap_height node digests at that level.
# ----------------------------------------------------------------------------


def poseidon_leaf(values: list[int]) -> list[int]:
    return hash_no_pad(values)


def poseidon_tree_cap(leaves: list[list[int]], cap_height: int = 0) -> list[list[int]]:
    """leaves: list of field-element vectors (one per leaf). Returns the cap."""
    n = len(leaves)
    assert n & (n - 1) == 0 and n >= 1
    assert (1 << cap_height) <= n
    layer = [poseidon_leaf(leaf) for leaf in leaves]
    while len(layer) > (1 << cap_height):
        layer = [two_to_one(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
    assert all(len(d) == DIGEST for d in layer)
    return layer


def poseidon_merkle_path(leaves: list[list[int]], index: int, cap_height: int = 0):
    """(path, cap_index): siblings from leaf level up to (not incl.) cap level."""
    n = len(leaves)
    layer = [poseidon_leaf(leaf) for leaf in leaves]
    path = []
    idx = index
    while len(layer) > (1 << cap_height):
        path.append(layer[idx ^ 1])
        layer = [two_to_one(layer[i], layer[i + 1]) for i in range(0, len(layer), 2)]
        idx >>= 1
    return path, idx


def poseidon_verify_path(
    cap: list[list[int]], leaf: list[int], index: int, path: list[list[int]]
) -> bool:
    digest = poseidon_leaf(leaf)
    idx = index
    for sibling in path:
        if idx & 1:
            digest = two_to_one(sibling, digest)
        else:
            digest = two_to_one(digest, sibling)
        idx >>= 1
    return digest == cap[idx]
