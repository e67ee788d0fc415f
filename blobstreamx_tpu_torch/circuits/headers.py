"""Header-field Merkle inclusion proofs, batched over lanes.

A Tendermint header commits to 14 field leaves via the RFC 6962 SimpleMerkle
tree (golden.encoding.Header). The skip relation checks that data_hash,
validators_hash and last_block_id leaves are included under given header
roots. This module batches N such checks into lane-parallel device hashing:
one leaf-hash block, then one SHA-256 double block per path level.

Host side supplies (siblings, directions) audit paths via
merkle_proof_with_dirs (golden-model structure; static shapes per depth).
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.golden import merkle as gold_merkle
from blobstreamx_tpu_torch.ops import sha256 as sha_ops


def merkle_proof_with_dirs(leaves: list[bytes], index: int):
    """(siblings leaf-to-root, dirs leaf-to-root) in the RFC 6962 tree.

    dirs[d] == 1 iff the running node is the RIGHT child at level d.
    """
    siblings = gold_merkle.merkle_proof(leaves, index)

    dirs: list[int] = []

    def walk(idx: int, n: int):
        if n == 1:
            return
        k = gold_merkle._split_point(n)
        if idx < k:
            walk(idx, k)
            dirs.append(0)
        else:
            walk(idx - k, n - k)
            dirs.append(1)

    walk(index, len(leaves))
    assert len(dirs) == len(siblings)
    return siblings, dirs


def leaf_hash_32(values):
    """RFC 6962 leaf hash of 32-byte values: SHA-256(0x00 ‖ v).

    values: (8, N) big-endian words. The 33-byte message is one block.
    """
    prev = torch.cat([torch.zeros_like(values[:1]), values])  # prev[j] = word j-1
    block = torch.zeros((16, values.shape[1]), dtype=torch.int64, device=values.device)
    block[:8] = ((prev[:8] & 0xFF) << 24) | (values >> 8)
    block[8] = ((values[7] & 0xFF) << 24) | 0x00800000  # v[31], 0x80
    block[15] = 33 * 8
    state = sha_ops.initial_state(values.shape[1], values.device)
    return sha_ops.compress_blocks(state, block)


def fold_paths(leaf_digests, siblings, dirs):
    """Fold N audit paths of equal depth D.

    leaf_digests: (8, N); siblings: (D, 8, N); dirs: (D, N) (1 = node is the
    right child). Returns computed roots (8, N)."""
    h = leaf_digests
    for sib, d in zip(siblings, dirs):
        right = (d == 1)[None, :]
        h = sha_ops.inner_hash_pairs(torch.where(right, sib, h), torch.where(right, h, sib))
    return h


def verify_inclusions(values, siblings, dirs, roots):
    """Batched inclusion check: leaf-hash 32-byte values, fold paths, compare
    to expected roots. Returns (N,) bool."""
    computed = fold_paths(leaf_hash_32(values), siblings, dirs)
    return (computed == roots).all(dim=0)


def pack_proofs_host(proofs: list[tuple[bytes, list[bytes], list[int], bytes]]):
    """Host packing for verify_inclusions.

    proofs: per lane (value32, siblings leaf-to-root, dirs, root32); all
    lanes must share one path depth (true for the header fields we verify).
    """
    depth = len(proofs[0][1])
    assert all(len(p[1]) == depth and len(p[2]) == depth for p in proofs)
    values = sha_ops.bytes32_to_words([p[0] for p in proofs])
    roots = sha_ops.bytes32_to_words([p[3] for p in proofs])
    sibs = np.stack(
        [sha_ops.bytes32_to_words([p[1][d] for p in proofs]) for d in range(depth)]
    )
    dirs = np.array([[p[2][d] for p in proofs] for d in range(depth)], dtype=np.uint32)
    return values, sibs, dirs, roots
