"""Validator-set gadgets.

Device responsibilities:
  - hash a whole validator set to its Tendermint SimpleMerkle root: leaf
    SHA-256 of every protobuf-encoded SimpleValidator in parallel lanes, then
    a pair-and-promote tree reduction (the same left-balanced tree as the
    RFC 6962 largest-power-of-two split of golden.merkle);
  - sum voting power exactly, in 16-bit limbs (no float anywhere).

Host responsibilities (thin, O(n) bytes): protobuf encoding via
golden.encoding, message padding/packing via ops.sha256.pack_messages_host.
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.device import resolve
from blobstreamx_tpu_torch.golden import encoding as enc
from blobstreamx_tpu_torch.ops import sha256 as sha_ops


def simple_root_from_digests(digests):
    """Tendermint SimpleMerkle root over already leaf-hashed nodes.

    digests: (8, N) words. Returns (8, 1). Iterative pair-and-promote: each
    level inner-hashes adjacent pairs left-to-right and promotes an odd
    trailing node unchanged."""
    layer = digests
    n = layer.shape[1]
    assert n >= 1
    while n > 1:
        half = n // 2
        pairs = sha_ops.inner_hash_pairs(layer[:, 0 : 2 * half : 2], layer[:, 1 : 2 * half : 2])
        layer = torch.cat([pairs, layer[:, -1:]], dim=1) if n % 2 else pairs
        n = layer.shape[1]
    return layer


def pack_validator_leaves(validators: list[tuple[bytes, int]]):
    """Host: encode SimpleValidator records and pack the RFC 6962 leaf
    messages (0x00-prefixed) into SHA block tensors."""
    msgs = [b"\x00" + enc.encode_simple_validator(pk, power) for pk, power in validators]
    return sha_ops.pack_messages_host(msgs)


def leaf_and_root(blocks, n_blocks):
    """Leaf digests of packed validator messages, reduced to the set root."""
    return simple_root_from_digests(sha_ops.sha256_packed(blocks, n_blocks))


def validators_root_device(validators: list[tuple[bytes, int]], device=None):
    """The whole validators hash on `device` (default: the card): leaf lanes
    and the tree reduction. Returns (8, 1) words."""
    device = resolve(device)
    blocks, n_blocks = pack_validator_leaves(validators)
    return leaf_and_root(sha_ops.to_device(blocks, device), sha_ops.to_device(n_blocks, device))


# ----------------------------------------------------------------------------
# voting-power accumulation (exact, in 16-bit limbs; powers < 2^63 total)
# ----------------------------------------------------------------------------


def powers_to_u32(powers) -> tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(powers, dtype=np.uint64)
    return (arr & 0xFFFFFFFF).astype(np.uint32), (arr >> 32).astype(np.uint32)


def signed_power_sum(power_lo, power_hi, signed_mask):
    """sum(power_i where signed_i) and sum(power_i), as two (4,) vectors of
    16-bit limb sums (exact in int64 for any lane count that fits memory);
    limb_sums_to_int recombines them."""

    def limb_sums(lo, hi):
        return torch.stack([(lo & 0xFFFF).sum(), (lo >> 16).sum(), (hi & 0xFFFF).sum(), (hi >> 16).sum()])

    mask = signed_mask.to(torch.int64)
    return limb_sums(power_lo * mask, power_hi * mask), limb_sums(power_lo, power_hi)


def limb_sums_to_int(limbs) -> int:
    vals = limbs.tolist() if isinstance(limbs, torch.Tensor) else list(limbs)
    return sum(int(v) << (16 * i) for i, v in enumerate(vals))


def threshold_gt(signed: int, total: int, num: int, den: int) -> bool:
    """signed > total * num / den without floats: signed * den > total * num."""
    return signed * den > total * num
