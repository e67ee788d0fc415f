"""Poseidon Merkle trees on the device.

Poseidon prover trees over field-element leaf vectors, with `cap_height`
caps: leaf layer via the batched sponge, then log2(n) two-to-one reduction
layers, all on the device. All layers are kept so query-phase path
extraction is a host-side gather with no rehashing.
"""

from __future__ import annotations

from dataclasses import dataclass

from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl
from blobstreamx_tpu_torch.ops import poseidon as pos


@dataclass
class PoseidonTree:
    """layers[0] = leaf digests (4, n) ... layers[-1] = cap (4, 2^cap_height)."""

    layers: list
    cap_height: int

    @property
    def cap(self) -> Gl:
        return self.layers[-1]

    def num_leaves(self) -> int:
        return self.layers[0][0].shape[1]

    def host_layers(self):
        """Device->host copies of all layers as uint64 (cached: path queries
        would otherwise re-transfer whole layers per call)."""
        if not hasattr(self, "_host_layers"):
            self._host_layers = [gf64.to_u64(layer) for layer in self.layers]
        return self._host_layers

    def path(self, index: int):
        """Sibling digests (host ints, each len-4) leaf->cap + cap index."""
        sibs = []
        idx = index
        for layer in self.host_layers()[:-1]:
            sibs.append([int(x) for x in layer[:, idx ^ 1]])
            idx >>= 1
        return sibs, idx


def tree_layers(leaves: Gl, cap_height: int = 0):
    """All tree layers as a tuple (leaf digests ... cap)."""
    n = leaves[0].shape[1]
    assert n & (n - 1) == 0 and (1 << cap_height) <= n
    layer = pos.hash_columns(leaves)
    layers = [layer]
    while layer[0].shape[1] > (1 << cap_height):
        lo, hi = layer
        layer = pos.compress_pairs(
            (lo[:, 0::2], hi[:, 0::2]), (lo[:, 1::2], hi[:, 1::2])
        )
        layers.append(layer)
    return tuple(layers)


def build_tree(leaves: Gl, cap_height: int = 0) -> PoseidonTree:
    """leaves: (L, N) field-element matrix, one leaf vector per column."""
    return PoseidonTree(
        layers=list(tree_layers(leaves, cap_height)), cap_height=cap_height
    )


def cap_to_ints(tree: PoseidonTree) -> list[list[int]]:
    """Cap digests as python ints (for the Fiat-Shamir challenger)."""
    arr = gf64.to_u64(tree.cap)
    return [[int(x) for x in arr[:, j]] for j in range(arr.shape[1])]
