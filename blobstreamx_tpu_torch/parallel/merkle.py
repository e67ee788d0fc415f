"""Merkle trees over a mesh: local subtrees, then the top levels over the
gathered subtree roots, computed on every rank.
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl
from blobstreamx_tpu_torch.ops import merkle as merkle_ops, poseidon as pos, sha256 as sha_ops
from .mesh import Mesh


def tuple_tree_root_sharded(height_lo, height_hi, data_hashes, mesh: Mesh) -> torch.Tensor:
    """Data-commitment root with the leaves sharded over the ranks.

    height_lo/hi: (N,) uint32; data_hashes: (8, N) uint32 words, the whole
    input on every rank (host arrays). N and N/D must be powers of two.
    Each rank hashes its N/D leaves to a subtree root, the D roots are
    gathered and the top log2(D) levels are hashed on every rank. Returns
    the (8, 1) root words on the mesh's device, the same on every rank."""
    n = len(height_lo)
    d = mesh.size
    per = n // d
    assert n % d == 0 and per & (per - 1) == 0 and n & (n - 1) == 0, (n, d)
    a, b = mesh.rank * per, (mesh.rank + 1) * per
    dev = mesh.device
    sub = sha_ops.tuple_tree_root(
        sha_ops.to_device(np.asarray(height_lo)[a:b], dev),
        sha_ops.to_device(np.asarray(height_hi)[a:b], dev),
        sha_ops.to_device(np.asarray(data_hashes)[:, a:b], dev),
    )  # (8, 1)
    roots = torch.cat(mesh.all_gather(sub), dim=1)  # (8, D)
    while roots.shape[1] > 1:
        roots = sha_ops.inner_hash_pairs(roots[:, 0::2], roots[:, 1::2])
    return roots


def poseidon_leaf_layer_sharded(leaves: Gl, mesh: Mesh) -> Gl:
    """Leaf digests of a Poseidon tree: this rank's (L, N/D) leaves in, its
    (4, N/D) digests out, no communication. On a rank-local block this is
    pos.hash_columns and the mesh is unused; the function keeps the JAX
    package's name and signature (blobstreamx_tpu.parallel.merkle), where
    the sharding is a shard_map over the mesh."""
    return pos.hash_columns(leaves)


class ShardedTree:
    """A Poseidon cap tree whose leaves are sharded over the ranks.

    ``local`` holds this rank's part of every layer of global width above
    max(D, 2^cap) (leaf digests first), ``top`` the layers from the
    gathered one down to the cap, the same on every rank. ``path`` answers
    for the leaves of this rank (``owner``); a caller gathers the others'
    paths from their owners."""

    def __init__(self, local: list, top: list, cap_height: int, n_leaves: int, mesh: Mesh):
        self.local = local
        self.top = top
        self.cap_height = cap_height
        self.n_leaves = n_leaves
        self.mesh = mesh
        self.per = n_leaves // mesh.size

    @property
    def cap(self) -> Gl:
        return self.top[-1]

    def owner(self, index: int) -> int:
        return index // self.per

    def _host(self):
        if not hasattr(self, "_host_layers"):
            self._host_layers = ([gf64.to_u64(x) for x in self.local], [gf64.to_u64(x) for x in self.top])
        return self._host_layers

    def path(self, index: int):
        """Sibling digests (host ints, each len-4) leaf -> cap and the cap
        index, as PoseidonTree.path gives them; only for this rank's leaves."""
        assert self.owner(index) == self.mesh.rank, (index, self.mesh.rank)
        local, top = self._host()
        sibs, idx = [], index
        width = self.per
        for layer in local:
            sibs.append([int(x) for x in layer[:, (idx ^ 1) - self.mesh.rank * width]])
            idx >>= 1
            width >>= 1
        for layer in top[:-1]:
            sibs.append([int(x) for x in layer[:, idx ^ 1]])
            idx >>= 1
        return sibs, idx


def poseidon_tree_sharded(leaves: Gl, mesh: Mesh, cap_height: int = 0) -> ShardedTree:
    """The whole Poseidon cap tree of N leaves: this rank's (L, N/D) leaves
    in (N/D a power of two), the local layers on the Poseidon kernel down
    to a width of max(1, 2^cap / D), that layer gathered, then compressed on
    every rank down to the cap. Its cap is build_tree's cap for the whole
    leaf matrix."""
    d = mesh.size
    digests = pos.hash_columns(leaves)
    per = digests[0].shape[1]
    n_leaves = per * d
    assert per & (per - 1) == 0, (per, d)
    target = 1 << cap_height
    assert target <= n_leaves, (cap_height, n_leaves)
    stop = max(1, target // d)
    layers = list(merkle_ops.digest_layers(digests, stop.bit_length() - 1))
    gathered = torch.cat(mesh.all_gather(torch.stack(layers[-1])), dim=2)  # (2, 4, max(D, 2^cap))
    top = [(gathered[0], gathered[1])]
    while top[-1][0].shape[1] > target:
        lo, hi = top[-1]
        top.append(pos.compress_pairs((lo[:, 0::2], hi[:, 0::2]), (lo[:, 1::2], hi[:, 1::2])))
    return ShardedTree(layers[:-1], top, cap_height, n_leaves, mesh)
