"""Full-coverage SHA-256 claims for the skip relation — EVERY hash the skip
circuit performs, proven in batched SHA-256 STARKs (prover.sha_air), one a
shard of at most max_blocks blocks.

Where sha_claims.py covers only the data-commitment tuple tree, this module
additionally enumerates and verifies:

  1. both validator-set hash trees (0x00-prefixed SimpleValidator leaves,
     RFC-6962 recursion),
  2. the two validators_hash inclusion paths under the PUBLIC trusted and
     target header roots,
  3. per header in (trusted, target]: the last_block_id chain-link leaf —
     whose embedded 32 bytes are rebuilt by the VERIFIER from the previous
     proven root, anchored at the trusted root — plus its audit path to
     root_i, with root_R pinned to the public target root,
  4. per header: the data_hash inclusion path, sharing the SAME claimed
     root_i as the chain link,
  5. the data-commitment tuple tree, root pinned to the public commitment.

The verifier walks the claim list in this fixed order, rebuilding every
expected message either fully (from public anchors + claimed witness data
such as validator lists and part-set fields) or from digests CLAIMED for
earlier messages; it performs no hashing itself. Canonical-padding checks
on every block close padding malleability.

The prover hashes on the host with hashlib (golden.sha256), where the JAX
package calls its native library: hashlib times faster than the native
sha256 through ctypes (chip_smoke.py phase 14), and the proofs equal the
JAX package's for the same witness and config.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from blobstreamx_tpu_torch.device import resolve
from blobstreamx_tpu_torch.golden import encoding as enc
from blobstreamx_tpu_torch.golden import merkle as gmerkle
from blobstreamx_tpu_torch.golden import sha256 as gsha
from blobstreamx_tpu_torch.prover import sha_air, stark, stark_stream
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.prover.sha_claims import _pad_words, tuple_tree_messages
from blobstreamx_tpu_torch.utils.timing import maybe_scope

LEAF = b"\x00"
INNER = b"\x01"


def path_dirs(n_leaves: int, index: int) -> list[int]:
    """Leaf-to-root direction bits (1 = node is the RIGHT child) for the
    RFC-6962 tree shape over n_leaves — structure only, no hashing."""
    dirs: list[int] = []

    def walk(idx: int, n: int) -> None:
        if n == 1:
            return
        k = gmerkle._split_point(n)
        if idx < k:
            walk(idx, k)
            dirs.append(0)
        else:
            walk(idx - k, n - k)
            dirs.append(1)

    walk(index, n_leaves)
    return dirs


def _n_blocks(length: int) -> int:
    """FIPS 180-4 padded block count of an L-byte message."""
    return (length + 9 + 63) // 64


def parse_block_id_leaf(leaf: bytes) -> tuple[bytes, int, bytes]:
    """Inverse of circuits.witness.block_id_leaf_bytes: extract
    (prev_hash, part_set_total, part_set_hash) from a BlockID header leaf."""
    assert leaf[0:2] == b"\x0a\x20", "field 1 (hash) tag/len"
    prev_hash = leaf[2:34]
    assert leaf[34:35] == b"\x12", "field 2 (part_set_header) tag"
    inner_len = leaf[35]
    inner = leaf[36 : 36 + inner_len]
    assert inner[0:1] == b"\x08", "part_set field 1 (total) tag"
    total = 0
    shift = 0
    i = 1
    while True:
        b = inner[i]
        total |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            break
        shift += 7
    assert inner[i : i + 2] == b"\x12\x20", "part_set field 2 (hash) tag/len"
    psh = inner[i + 2 : i + 34]
    return prev_hash, total, psh


# -----------------------------------------------------------------------------
# shared enumeration skeleton: message lengths (verifier-derivable) and the
# prover's concrete message list follow the same fixed walk order
# -----------------------------------------------------------------------------


def _tree_lengths(leaf_lengths: list[int]) -> list[int]:
    out: list[int] = []

    def walk(lo: int, hi: int) -> None:
        if hi - lo == 1:
            out.append(1 + leaf_lengths[lo])
            return
        k = gmerkle._split_point(hi - lo)
        walk(lo, lo + k)
        walk(lo + k, hi)
        out.append(65)

    walk(0, len(leaf_lengths))
    return out


def skip_message_lengths(
    trusted_vals: list[tuple[bytes, int]],
    target_vals: list[tuple[bytes, int]],
    link_fields: list[tuple[int, bytes]],
) -> list[int]:
    """Expected message lengths in enumeration order — computable by the
    verifier from claimed witness data alone (no digests needed)."""
    lengths: list[int] = []
    for vals in (trusted_vals, target_vals):
        lengths += _tree_lengths(
            [len(enc.encode_simple_validator(pk, p)) for pk, p in vals]
        )
    vh_depth = len(path_dirs(enc.HEADER_NUM_FIELDS, enc.VALIDATORS_HASH_INDEX))
    for _ in range(2):  # the two validators_hash inclusion paths
        lengths += [33] + [65] * vh_depth
    bid_depth = len(path_dirs(enc.HEADER_NUM_FIELDS, enc.LAST_BLOCK_ID_INDEX))
    dh_depth = len(path_dirs(enc.HEADER_NUM_FIELDS, enc.DATA_HASH_INDEX))
    dummy = bytes(32)
    for total, psh in link_fields:
        leaf_len = len(
            enc.encode_bytes_field(1, dummy)
            + enc.encode_bytes_field(
                2, enc.encode_varint_field(1, total) + enc.encode_bytes_field(2, psh)
            )
        )
        lengths += [1 + leaf_len] + [65] * bid_depth  # chain link + path
        lengths += [33] + [65] * dh_depth  # data_hash leaf + path
    lengths += [65] * (2 * len(link_fields) - 1)  # tuple tree (65-byte msgs)
    return lengths


def _chain_from_lengths(lengths: list[int]) -> tuple[bool, ...]:
    chain: list[bool] = []
    for L in lengths:
        chain += [False] + [True] * (_n_blocks(L) - 1)
    n = max(1, 1 << (len(chain) - 1).bit_length())
    chain += [False] * (n - len(chain))
    return tuple(chain)


# -----------------------------------------------------------------------------
# prover
# -----------------------------------------------------------------------------


def _words_to_bytes(words) -> bytes:
    return b"".join(int(w).to_bytes(4, "big") for w in np.asarray(words).reshape(-1))


def _inclusion_path_messages(
    leaf_digest: bytes, siblings: list[bytes], dirs: list[int]
) -> tuple[list[bytes], bytes]:
    """Messages of one audit-path fold plus the resulting root digest."""
    msgs: list[bytes] = []
    h = leaf_digest
    for sib, d in zip(siblings, dirs):
        msg = INNER + (sib + h if d == 1 else h + sib)
        msgs.append(msg)
        h = gsha.sha256(msg)
    return msgs, h


def _tree_messages(leaves: list[bytes]) -> tuple[list[bytes], bytes]:
    msgs: list[bytes] = []

    def walk(lo: int, hi: int) -> bytes:
        if hi - lo == 1:
            m = LEAF + leaves[lo]
            msgs.append(m)
            return gsha.sha256(m)
        k = gmerkle._split_point(hi - lo)
        left = walk(lo, lo + k)
        right = walk(lo + k, hi)
        m = INNER + left + right
        msgs.append(m)
        return gsha.sha256(m)

    root = walk(0, len(leaves))
    return msgs, root


def _witness_link_fields(witness) -> list[tuple[int, bytes]]:
    """(part_set_total, part_set_hash) per range header, parsed back out of
    the packed chain-link SHA blocks."""
    cl = witness.chain_links
    fields = []
    for i in range(cl.blocks.shape[2]):
        raw = b"".join(
            int(w).to_bytes(4, "big")
            for b in range(cl.blocks.shape[0])
            for w in cl.blocks[b, :, i]
        )
        # strip FIPS padding: message length is in the last 8 bytes of the
        # final used block (bits, big-endian)
        nb = int(cl.n_blocks[i])
        bitlen = int.from_bytes(raw[64 * nb - 8 : 64 * nb], "big")
        msg = raw[: bitlen // 8]
        _, total, psh = parse_block_id_leaf(msg[1:])
        fields.append((total, psh))
    return fields


def skip_sha_messages(witness) -> tuple[list[bytes], list[tuple[int, bytes]]]:
    """Enumerate every SHA-256 message of the skip relation in the fixed
    verification order. Returns (messages, link_fields)."""
    w = witness
    msgs: list[bytes] = []

    # 1. the two validator-set trees
    roots = {}
    for name, vs in (("trusted", w.trusted_set), ("target", w.target_set)):
        leaves = [
            enc.encode_simple_validator(pk, int(p))
            for pk, p in zip(vs.pubkeys, vs.powers)
        ]
        m, root = _tree_messages(leaves)
        msgs += m
        roots[name] = root

    # 2. validators_hash inclusion paths (lane 0 trusted, lane 1 target)
    inc = w.valset_inclusions
    vh_dirs = path_dirs(enc.HEADER_NUM_FIELDS, enc.VALIDATORS_HASH_INDEX)
    for lane, name in ((0, "trusted"), (1, "target")):
        leaf_msg = LEAF + roots[name]
        msgs.append(leaf_msg)
        sibs = [_words_to_bytes(inc.siblings[d, :, lane]) for d in range(inc.siblings.shape[0])]
        pm, _ = _inclusion_path_messages(gsha.sha256(leaf_msg), sibs, vh_dirs)
        msgs += pm

    # 3+4. per range header: chain link leaf+path, then data_hash leaf+path
    cl = w.chain_links
    dh = w.data_hash_inclusions
    bid_dirs = path_dirs(enc.HEADER_NUM_FIELDS, enc.LAST_BLOCK_ID_INDEX)
    dh_dirs = path_dirs(enc.HEADER_NUM_FIELDS, enc.DATA_HASH_INDEX)
    link_fields = _witness_link_fields(w)
    prev_root = w.trusted_root
    for i, (total, psh) in enumerate(link_fields):
        leaf = (
            enc.encode_bytes_field(1, prev_root)
            + enc.encode_bytes_field(
                2, enc.encode_varint_field(1, total) + enc.encode_bytes_field(2, psh)
            )
        )
        link_msg = LEAF + leaf
        msgs.append(link_msg)
        sibs = [_words_to_bytes(cl.siblings[d, :, i]) for d in range(cl.siblings.shape[0])]
        pm, root_i = _inclusion_path_messages(gsha.sha256(link_msg), sibs, bid_dirs)
        msgs += pm

        dh_msg = LEAF + bytes(w.range_data_hashes[i])
        msgs.append(dh_msg)
        sibs = [_words_to_bytes(dh.siblings[d, :, i]) for d in range(dh.siblings.shape[0])]
        pm, _ = _inclusion_path_messages(gsha.sha256(dh_msg), sibs, dh_dirs)
        msgs += pm
        prev_root = root_i

    # 5. the data-commitment tuple tree
    tm, _ = tuple_tree_messages([int(h) for h in w.range_heights], w.range_data_hashes)
    msgs += tm
    return msgs, link_fields


# -----------------------------------------------------------------------------
# shard planning: config 5's 1024-header range is about 24k blocks, 2^21
# trace rows at 1300 columns, so the batch splits into deterministic shards
# of at most max_blocks blocks, one STARK each
# -----------------------------------------------------------------------------

DEFAULT_MAX_SHARD_BLOCKS = 4096  # 2^18 rows, the SHA tier's streamed shape


def plan_shards(lengths: list[int], max_blocks: int) -> list[tuple[int, int, int]]:
    """Greedy deterministic shard plan over the message stream: returns
    [(msg_lo, msg_hi, padded_blocks)] where messages [lo, hi) fill a shard of
    `padded_blocks` (a power of two <= max_blocks, dummy-padded). Messages
    never split across shards, so every shard's block 0 starts a message.
    Prover and verifier derive the identical plan from the claimed lengths."""
    assert max_blocks >= 2 and max_blocks & (max_blocks - 1) == 0
    out = []
    lo = 0
    used = 0
    for i, L in enumerate(lengths):
        nb = _n_blocks(L)
        assert nb <= max_blocks, "single message exceeds shard capacity"
        if used + nb > max_blocks:
            out.append((lo, i, 1 << (used - 1).bit_length()))
            lo, used = i, 0
        used += nb
    out.append((lo, len(lengths), max(1, 1 << (used - 1).bit_length())))
    return out


def _shard_chain(lengths: list[int], lo: int, hi: int, padded: int) -> tuple[bool, ...]:
    """Block chain flags of one shard (real messages + standalone dummy pads)."""
    chain: list[bool] = []
    for L in lengths[lo:hi]:
        chain += [False] + [True] * (_n_blocks(L) - 1)
    assert len(chain) <= padded
    chain += [False] * (padded - len(chain))
    return tuple(chain)


@dataclass
class SkipShaProof:
    """Full-coverage batched-SHA STARK for one skip witness, sharded: one
    STARK per <= max_blocks block shard, aux = the concatenated per-block
    claim stream (shard pads included — the verifier walks past them)."""

    starks: list  # list[stark.StarkProof], one per shard
    aux: list  # per block: (w_words[16], out_words[8])
    n_rows: int  # total rows across shards
    link_fields: list  # claimed (part_set_total, part_set_hash) per header
    max_blocks: int = DEFAULT_MAX_SHARD_BLOCKS
    # per shard, as prove_skip_sha_stark ran it: messages, blocks, padded_blocks, rows, the
    # prover_path prove_auto took and prove_s (the shard's TimingTree scope, None without one).
    # The prover's record only: not serialized, so a decoded proof has none.
    shard_log: list = field(default_factory=list)


def prove_skip_sha_stark(
    witness,
    config: StarkConfig | None = None,
    max_blocks: int = DEFAULT_MAX_SHARD_BLOCKS,
    device=None,
    timing=None,
) -> SkipShaProof:
    """Prove every SHA-256 of the skip relation, one STARK a shard, each
    through stark_stream.prove_auto on `device` (default: the card). The
    shards are proven one after another, so the peak device memory is one
    shard's. timing: a TimingTree that gets a scope a shard, holding the
    host trace build and the streaming prover's phases."""
    device = resolve(device)
    config = config or StarkConfig(rate_bits=2)
    messages, link_fields = skip_sha_messages(witness)
    lengths = [len(m) for m in messages]
    shards = plan_shards(lengths, max_blocks)
    starks = []
    aux_all: list = []
    n_rows = 0
    shard_log = []
    for k, (lo, hi, padded) in enumerate(shards):
        with maybe_scope(timing, f"shard {k}", items=padded, unit="blocks", sync=device) as node:
            with maybe_scope(timing, "host trace"):
                chain_s, blocks_s = sha_air.plan_blocks(messages[lo:hi])
                if len(chain_s) < padded:  # plan_blocks pads to the next power of two
                    pad = gsha.pad(b"")
                    blocks_s = blocks_s + [pad] * (padded - len(chain_s))
                    chain_s = chain_s + (False,) * (padded - len(chain_s))
                assert chain_s == _shard_chain(lengths, lo, hi, padded)
                trace, aux_s = sha_air.build_sha_trace(chain_s, blocks_s)
            air = sha_air.Sha256Air(chain_s)
            # uses_streaming is prove_auto's own choice on these inputs
            path = "streaming" if stark_stream.uses_streaming(air, trace.shape[0], config) else "standard"
            starks.append(stark_stream.prove_auto(air, trace, [], config, aux=aux_s, device=device,
                                                  timing=timing))
        shard_log.append(dict(messages=hi - lo, blocks=sum(_n_blocks(L) for L in lengths[lo:hi]),
                              padded_blocks=padded, rows=trace.shape[0], prover_path=path,
                              prove_s=None if node is None else node.seconds))
        aux_all += aux_s
        n_rows += trace.shape[0]
        del trace
    return SkipShaProof(
        starks=starks,
        aux=aux_all,
        n_rows=n_rows,
        link_fields=link_fields,
        max_blocks=max_blocks,
        shard_log=shard_log,
    )


# -----------------------------------------------------------------------------
# verifier
# -----------------------------------------------------------------------------


class _Cursor:
    """Walks the claimed (message words, digest) stream, enforcing the block
    chain layout and canonical FIPS padding on every message it yields.

    pad_ranges: [(start, end)] block-index ranges holding shard padding —
    every pad block must be a standalone canonical empty-message block, and
    the walk steps over them transparently."""

    def __init__(self, aux, chain, pad_ranges=()):
        self.aux = aux
        self.chain = chain
        self.b = 0
        self.pads = sorted(pad_ranges)
        self.pi = 0
        self._empty = _pad_words(b"")[0]

    def _skip_pads(self) -> bool:
        while self.pi < len(self.pads) and self.b >= self.pads[self.pi][0]:
            s, e = self.pads[self.pi]
            if self.b != s:
                return False
            for b in range(s, e):
                if self.chain[b] or [int(w) for w in self.aux[b][0]] != self._empty:
                    return False
            self.b = e
            self.pi += 1
        return True

    def finish(self) -> bool:
        """End of walk: any remaining blocks must be (skipped) padding."""
        return self._skip_pads() and self.b == len(self.chain)

    def take(self, length: int):
        """Consume one length-byte message; return (bytes, digest) or None."""
        if not self._skip_pads():
            return None
        nb = _n_blocks(length)
        first = self.b
        for i in range(nb):
            if self.b >= len(self.chain) or self.chain[self.b] != (i > 0):
                return None
            self.b += 1
        raw = b"".join(
            int(w).to_bytes(4, "big")
            for k in range(first, self.b)
            for w in self.aux[k][0]
        )
        msg = raw[:length]
        got = [[int(w) for w in self.aux[k][0]] for k in range(first, self.b)]
        if got != _pad_words(msg):
            return None  # non-canonical padding
        out = self.aux[self.b - 1][1]
        return msg, b"".join(int(w).to_bytes(4, "big") for w in out)

    def expect(self, expected: bytes):
        r = self.take(len(expected))
        if r is None or r[0] != expected:
            return None
        return r[1]

    def tree(self, leaves: list[bytes]):
        def walk(lo: int, hi: int):
            if hi - lo == 1:
                return self.expect(LEAF + leaves[lo])
            k = gmerkle._split_point(hi - lo)
            left = walk(lo, lo + k)
            if left is None:
                return None
            right = walk(lo + k, hi)
            if right is None:
                return None
            return self.expect(INNER + left + right)

        if not leaves:
            return None
        return walk(0, len(leaves))

    def path(self, leaf_digest: bytes, dirs: list[int]):
        """Fold an audit path: each step's message must carry the running
        digest in the direction-determined half; the sibling half is read
        from the claim itself."""
        h = leaf_digest
        for d in dirs:
            r = self.take(65)
            if r is None:
                return None
            msg, dg = r
            if msg[0:1] != INNER:
                return None
            node = msg[33:65] if d == 1 else msg[1:33]
            if node != h:
                return None
            h = dg
        return h


def _walk_claims(cur: _Cursor, proof: SkipShaProof, trusted_root: bytes, target_root: bytes,
                 trusted_vals, target_vals, range_heights, range_data_hashes, data_commitment) -> bool:
    """Checks (b)-(e) of verify_skip_sha_stark on the claim stream."""
    # (b) validator-set trees + inclusion under the public roots
    vh_dirs = path_dirs(enc.HEADER_NUM_FIELDS, enc.VALIDATORS_HASH_INDEX)
    vs_roots = []
    for vals in (trusted_vals, target_vals):
        leaves = [enc.encode_simple_validator(pk, int(p)) for pk, p in vals]
        root = cur.tree(leaves)
        if root is None:
            return False
        vs_roots.append(root)
    for vs_root, anchor in zip(vs_roots, (trusted_root, target_root)):
        leaf_dg = cur.expect(LEAF + vs_root)
        if leaf_dg is None:
            return False
        if cur.path(leaf_dg, vh_dirs) != anchor:
            return False

    # (c)+(d) chain links and data_hash inclusions
    bid_dirs = path_dirs(enc.HEADER_NUM_FIELDS, enc.LAST_BLOCK_ID_INDEX)
    dh_dirs = path_dirs(enc.HEADER_NUM_FIELDS, enc.DATA_HASH_INDEX)
    prev_root = trusted_root
    for i in range(len(range_heights)):
        total, psh = proof.link_fields[i]
        if not isinstance(psh, bytes) or len(psh) != 32 or total < 0:
            return False
        leaf = (
            enc.encode_bytes_field(1, prev_root)
            + enc.encode_bytes_field(
                2,
                enc.encode_varint_field(1, total) + enc.encode_bytes_field(2, psh),
            )
        )
        leaf_dg = cur.expect(LEAF + leaf)
        if leaf_dg is None:
            return False
        root_i = cur.path(leaf_dg, bid_dirs)
        if root_i is None:
            return False
        dh_dg = cur.expect(LEAF + bytes(range_data_hashes[i]))
        if dh_dg is None:
            return False
        if cur.path(dh_dg, dh_dirs) != root_i:
            return False
        prev_root = root_i
    if prev_root != target_root:
        return False

    # (e) tuple tree -> public data commitment
    leaves = [
        gmerkle.data_root_tuple(int(h), d)
        for h, d in zip(range_heights, range_data_hashes)
    ]
    if cur.tree(leaves) != data_commitment:
        return False

    # every remaining block must be (verified) shard padding
    return cur.finish()


def verify_skip_sha_stark(
    proof: SkipShaProof,
    *,
    trusted_root: bytes,
    target_root: bytes,
    trusted_vals: list[tuple[bytes, int]],
    target_vals: list[tuple[bytes, int]],
    range_heights: list[int],
    range_data_hashes: list[bytes],
    data_commitment: bytes,
    config: StarkConfig | None = None,
) -> bool:
    """Host verifier. Checks (hashing nothing itself):

      (a) the batched SHA STARK of each shard holds for the claimed
          (message, digest) pairs under the verifier-derived block layout;
      (b) both validator-set trees assemble from the claimed validator lists,
          and their roots sit at VALIDATORS_HASH under the PUBLIC trusted /
          target roots;
      (c) the header chain links: each link leaf embeds the previous proven
          root (anchored at trusted_root), folds to root_i, and root_R ==
          target_root;
      (d) each data_hash folds to the SAME root_i;
      (e) the tuple tree over (range_heights, range_data_hashes) yields the
          public data_commitment.

    The claim walk (b)-(e), host arithmetic, runs before the STARK checks
    (a), the pure-Python transcript and Merkle paths of every shard, so a
    wrong claim fails in about a second instead of after every shard's
    STARK; the verdict needs all of them either way.
    """
    config = config or StarkConfig(rate_bits=2)
    n = len(range_heights)
    if n == 0 or len(range_data_hashes) != n or len(proof.link_fields) != n:
        return False
    if not trusted_vals or not target_vals:
        return False

    lengths = skip_message_lengths(trusted_vals, target_vals, proof.link_fields)
    mb = int(getattr(proof, "max_blocks", DEFAULT_MAX_SHARD_BLOCKS))
    if mb < 2 or mb & (mb - 1):
        return False
    if any(_n_blocks(L) > mb for L in lengths):
        return False
    shards = plan_shards(lengths, mb)
    if len(proof.starks) != len(shards):
        return False
    # the verifier-derived layout of every shard
    chains: list[tuple[bool, ...]] = []
    pad_ranges: list[tuple[int, int]] = []
    base = 0
    for lo, hi, padded in shards:
        chains.append(_shard_chain(lengths, lo, hi, padded))
        if len(proof.aux[base : base + padded]) != padded:
            return False
        real = sum(_n_blocks(L) for L in lengths[lo:hi])
        if real < padded:
            pad_ranges.append((base + real, base + padded))
        base += padded
    if proof.n_rows != 64 * base or len(proof.aux) != base:
        return False

    cur = _Cursor(proof.aux, tuple(c for chain in chains for c in chain), pad_ranges)
    if not _walk_claims(cur, proof, trusted_root, target_root, trusted_vals, target_vals,
                        range_heights, range_data_hashes, data_commitment):
        return False

    # (a) per-shard STARK verification over the verifier-derived layout
    base = 0
    for chain_s, sp in zip(chains, proof.starks):
        aux_s = proof.aux[base : base + len(chain_s)]
        air = sha_air.Sha256Air(chain_s)
        if not stark.verify(air, sp, [], config, 64 * len(chain_s), aux=aux_s):
            return False
        base += len(chain_s)
    return True
