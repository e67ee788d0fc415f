"""The data commitment on the device.

The data commitment for a header range (start, end] is the Tendermint
SimpleMerkle root over 64-byte DataRootTuple leaves (uint256-BE height ‖
data_hash). One device pass hashes all leaves lane-parallel and reduces the
tree.
"""

from __future__ import annotations

import numpy as np

from blobstreamx_tpu_torch.circuits.validators import simple_root_from_digests
from blobstreamx_tpu_torch.ops import sha256 as sha_ops


def heights_to_u32(heights) -> tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(heights, dtype=np.uint64)
    return (arr & 0xFFFFFFFF).astype(np.uint32), (arr >> 32).astype(np.uint32)


def data_commitment_device(heights, data_hashes: list[bytes], device, mesh=None) -> bytes:
    """Data-root tuple commitment on `device`; returns the 32-byte root. The
    pair-and-promote reduction matches golden.merkle.data_commitment for any
    leaf count. With a mesh and power-of-two leaves and leaves a rank, the
    leaves are sharded over the ranks (parallel.merkle.tuple_tree_root_sharded);
    otherwise every rank runs the single-device reduction."""
    hlo, hhi = heights_to_u32(heights)
    words = sha_ops.bytes32_to_words(data_hashes)
    n = len(data_hashes)
    if mesh is not None and n % mesh.size == 0:
        per = n // mesh.size
        if per & (per - 1) == 0 and n & (n - 1) == 0:
            from blobstreamx_tpu_torch.parallel.merkle import tuple_tree_root_sharded

            return sha_ops.digests_to_bytes(tuple_tree_root_sharded(hlo, hhi, words, mesh))[0]
    leaves = sha_ops.leaf_hash_tuples(
        sha_ops.to_device(hlo, device), sha_ops.to_device(hhi, device), sha_ops.to_device(words, device)
    )
    return sha_ops.digests_to_bytes(simple_root_from_digests(leaves))[0]
