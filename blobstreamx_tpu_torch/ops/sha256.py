"""Batched SHA-256 in PyTorch.

Layout: N independent hash lanes. A state is an (8, N) tensor and a message
block a (16, N) tensor of big-endian u32 words, held in int64 and masked to
32 bits after every add and shift. The 64 rounds run as a Python loop over
whole-lane tensor ops on the device of the inputs (the JAX package wrote
this in jnp too; it has no Pallas SHA kernel).

Variable-length messages are handled with static shapes: the host packs each
message into a padded (B_max, 16, N) word tensor plus a per-lane block count;
the device runs B_max compressions and masks lanes whose blocks are done.

The 65-byte "prefix ‖ 32B ‖ 32B" message of RFC 6962 leaf and inner hashing
(Tendermint tuple trees) has its two blocks assembled on the device, so whole
Merkle levels run without host round-trips.

Golden oracle: blobstreamx_tpu_torch.golden.sha256 (and hashlib).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from blobstreamx_tpu_torch.golden import sha256 as gold

M32 = 0xFFFFFFFF
H0 = np.array(gold.h_constants(), dtype=np.uint32)  # (8,)
K = np.array(gold.k_constants(), dtype=np.uint32)  # (64,)
_K_INT = [int(k) for k in K]


def _rotr(x, n: int):
    return ((x >> n) | (x << (32 - n))) & M32


def compress_blocks(state, words):
    """One compression per lane. state (8, N), words (16, N) -> (8, N)."""
    w = list(words.unbind(0))
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    a, b, c, d, e, f, g, h = state.unbind(0)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = h + s1 + ch + _K_INT[t] + w[t]
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, (d + t1) & M32
        d, c, b, a = c, b, a, (t1 + s0 + maj) & M32
    return (state + torch.stack([a, b, c, d, e, f, g, h])) & M32


@lru_cache(maxsize=None)
def _h0(device: str):
    return torch.from_numpy(H0.astype(np.int64)).to(device)[:, None]


def initial_state(n: int, device):
    return _h0(str(device)).expand(8, n)


def sha256_packed(blocks, n_blocks=None):
    """Full SHA-256 over host-packed padded messages.

    blocks: (B, 16, N) words — per-lane padded message blocks.
    n_blocks: optional (N,) tensor — actual block count per lane; lanes keep
    their state once their blocks are exhausted.
    Returns digests as (8, N) words.
    """
    b_max, _, n = blocks.shape
    state = initial_state(n, blocks.device)
    for i in range(b_max):
        new = compress_blocks(state, blocks[i])
        if n_blocks is not None:
            new = torch.where((n_blocks > i)[None, :], new, state)
        state = new
    return state


def pack_messages_host(messages: list[bytes]):
    """Host-side packing: pad (FIPS 180-4) and build (B_max, 16, N) blocks."""
    padded = [gold.pad(m) for m in messages]
    n_blocks = np.array([len(p) // 64 for p in padded], dtype=np.int32)
    b_max = int(n_blocks.max())
    n = len(messages)
    blocks = np.zeros((b_max, 16, n), dtype=np.uint32)
    for lane, p in enumerate(padded):
        arr = np.frombuffer(p, dtype=">u4").reshape(-1, 16)
        blocks[: arr.shape[0], :, lane] = arr
    return blocks, n_blocks


def to_device(arr, device) -> torch.Tensor:
    """Host uint32/int32 array -> int64 tensor on `device`."""
    return torch.from_numpy(np.asarray(arr).astype(np.int64)).to(device)


def digests_to_bytes(digests) -> list[bytes]:
    """(8, N) words -> list of 32-byte digests (host side)."""
    if isinstance(digests, torch.Tensor):
        digests = digests.cpu().numpy()
    arr = np.asarray(digests).astype(">u4")
    return [arr[:, j].tobytes() for j in range(arr.shape[1])]


def bytes32_to_words(data: list[bytes]) -> np.ndarray:
    """list of 32-byte values -> (8, N) uint32 big-endian words (host side)."""
    flat = np.frombuffer(b"".join(data), dtype=">u4").reshape(-1, 8).T
    return np.ascontiguousarray(flat).astype(np.uint32)


# ----------------------------------------------------------------------------
# RFC 6962 prefix ‖ 32B ‖ 32B hashing, fully on device (leaf + inner nodes)
# ----------------------------------------------------------------------------


def _prefixed_pair_blocks(prefix: int, a, b):
    """The two padded blocks of SHA-256(prefix ‖ a ‖ b) per lane.

    a, b: (8, N) big-endian word views of 32-byte values. The message is 65
    bytes, padded to 128 bytes (2 blocks)."""
    words = torch.cat([a, b])  # (16, N): the 64 payload bytes
    prev = torch.cat([torch.full_like(words[:1], prefix), words])  # prev[j] = word j-1
    # byte stream m[0]=prefix, m[1..64]=payload; block word j = m[4j..4j+3]
    block1 = ((prev[:16] & 0xFF) << 24) | (words >> 8)
    block2 = torch.zeros_like(words)
    block2[0] = ((words[15] & 0xFF) << 24) | 0x00800000  # m[64], 0x80, 0, 0
    block2[15] = 65 * 8
    return block1, block2


def hash_prefixed_pair(prefix: int, a, b):
    """SHA-256(prefix ‖ a ‖ b) per lane: (8,N),(8,N) -> (8,N)."""
    block1, block2 = _prefixed_pair_blocks(prefix, a, b)
    state = compress_blocks(initial_state(a.shape[1], a.device), block1)
    return compress_blocks(state, block2)


def inner_hash_pairs(left, right):
    """RFC 6962 inner node: SHA-256(0x01 ‖ L ‖ R)."""
    return hash_prefixed_pair(0x01, left, right)


def leaf_hash_tuples(height_lo, height_hi, data_hashes):
    """DataRootTuple leaf hash: SHA-256(0x00 ‖ uint256-BE height ‖ data_hash).

    height_lo/hi: (N,) u32 words of 64-bit heights; data_hashes: (8, N)
    words. Returns (8, N)."""
    zero = torch.zeros((6, height_lo.shape[0]), dtype=torch.int64, device=height_lo.device)
    height_words = torch.cat([zero, height_hi[None], height_lo[None]])
    return hash_prefixed_pair(0x00, height_words, data_hashes)


def tuple_tree_root(height_lo, height_hi, data_hashes):
    """Full data-commitment root over a power-of-two leaf count: the leaf
    layer then log2(n) reduction layers, all on device. Returns (8, 1)."""
    layer = leaf_hash_tuples(height_lo, height_hi, data_hashes)
    n = layer.shape[1]
    assert n & (n - 1) == 0, "device tuple tree requires power-of-two leaves"
    while n > 1:
        layer = inner_hash_pairs(layer[:, 0::2], layer[:, 1::2])
        n //= 2
    return layer
