"""Witness generation: host-side packing of every device input of the skip
relation.

The schedule is fixed and statically shaped: build_skip_witness walks a
ChainFixture (or any object with the same accessors — a live loader drops
in) and packs every device input the skip relation needs:

  - SHA block tensors for both validator sets,
  - audit paths + direction bits for validators_hash / data_hash /
    last_block_id inclusions,
  - the Ed25519 batch (pubkey, sign_bytes, signature) triples,
  - u32 power/mask vectors for the threshold sums,
  - heights + data hashes of the commitment range.

Everything here is O(range) host byte-shuffling; all hashing/curve math runs
on device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from blobstreamx_tpu_torch.circuits import headers as hdr
from blobstreamx_tpu_torch.circuits import validators as vals
from blobstreamx_tpu_torch.circuits.fixtures import ChainFixture, SignedHeader, ValidatorSet
from blobstreamx_tpu_torch.golden import encoding as enc
from blobstreamx_tpu_torch.ops import sha256 as sha_ops


@dataclass
class ValSetWitness:
    """One validator set, packed for device hashing + power sums."""

    pubkeys: list[bytes]
    powers: np.ndarray  # (n,) uint64
    blocks: np.ndarray  # (B, 16, n) SHA blocks of 0x00-prefixed SimpleValidator leaves
    n_blocks: np.ndarray  # (n,) int32
    expected_root: bytes  # golden validators_hash (cross-check only)


@dataclass
class InclusionWitness:
    """Batched 32-byte-leaf inclusion proofs, packed (see headers.verify_inclusions)."""

    values: np.ndarray  # (8, N)
    siblings: np.ndarray  # (D, 8, N)
    dirs: np.ndarray  # (D, N)
    roots: np.ndarray  # (8, N)


@dataclass
class ChainLinkWitness:
    """Per-header last_block_id leaves (variable-length) proving the chain
    link root_{i-1} -> root_i, plus their audit paths under root_i."""

    blocks: np.ndarray  # (B, 16, N) SHA blocks of 0x00-prefixed BlockID leaves
    n_blocks: np.ndarray
    siblings: np.ndarray  # (D, 8, N)
    dirs: np.ndarray  # (D, N)
    roots: np.ndarray  # (8, N) root_i words


@dataclass
class SkipWitness:
    trusted_height: int
    target_height: int
    trusted_root: bytes
    target_root: bytes
    # consensus
    trusted_set: ValSetWitness
    target_set: ValSetWitness
    sign_bytes: bytes
    signatures: list[bytes]  # aligned with target_set.pubkeys; b"" if absent
    target_signed: np.ndarray  # (n_target,) bool — signed target commit
    trusted_signed: np.ndarray  # (n_trusted,) bool — trusted member signed target
    # structure
    valset_inclusions: InclusionWitness  # both validators_hash leaves
    data_hash_inclusions: InclusionWitness  # data_hash(i) under root_i, i in (t0, t1]
    chain_links: ChainLinkWitness  # last_block_id(i) under root_i
    # data commitment range
    range_heights: np.ndarray  # (R,) uint64, trusted+1 .. target
    range_data_hashes: list[bytes]


def build_valset_witness(vset: ValidatorSet) -> ValSetWitness:
    pairs = [(v.pubkey, v.power) for v in vset.validators]
    blocks, n_blocks = vals.pack_validator_leaves(pairs)
    return ValSetWitness(
        pubkeys=[v.pubkey for v in vset.validators],
        powers=np.array([v.power for v in vset.validators], dtype=np.uint64),
        blocks=blocks,
        n_blocks=n_blocks,
        expected_root=vset.hash(),
    )


def _inclusion(header: SignedHeader, field_index: int):
    leaves = header.header.field_leaves()
    sibs, dirs = hdr.merkle_proof_with_dirs(leaves, field_index)
    return leaves[field_index], sibs, dirs, header.header_hash


def block_id_leaf_bytes(prev_hash: bytes, part_set_total: int, part_set_hash: bytes) -> bytes:
    """The last_block_id header leaf, built FROM the previous root so the
    chain link holds by construction (witness soundness note in skip.py)."""
    return enc.encode_bytes_field(1, prev_hash) + enc.encode_bytes_field(
        2,
        enc.encode_varint_field(1, part_set_total) + enc.encode_bytes_field(2, part_set_hash),
    )


def build_skip_witness(chain: ChainFixture, trusted_height: int, target_height: int) -> SkipWitness:
    assert trusted_height < target_height
    trusted = chain.header_at(trusted_height)
    target = chain.header_at(target_height)
    trusted_set = chain.val_set_at(trusted_height)
    target_set = chain.val_set_at(target_height)

    # who signed the target commit (by pubkey), and which trusted members did
    signed_pubkeys = {
        v.pubkey
        for v, s in zip(target_set.validators, target.signed)
        if s
    }
    target_signed = np.array(list(target.signed), dtype=bool)
    trusted_signed = np.array(
        [v.pubkey in signed_pubkeys for v in trusted_set.validators], dtype=bool
    )

    # validators_hash inclusions: trusted set under trusted root, target set
    # under target root (both depth-4 leaves in the 14-leaf header tree)
    incl = [
        _inclusion(trusted, enc.VALIDATORS_HASH_INDEX),
        _inclusion(target, enc.VALIDATORS_HASH_INDEX),
    ]

    # range (trusted, target]
    rng = [chain.header_at(h) for h in range(trusted_height + 1, target_height + 1)]
    data_incl = [_inclusion(h, enc.DATA_HASH_INDEX) for h in rng]
    values, sibs, dirs, roots = hdr.pack_proofs_host(incl)
    d_values, d_sibs, d_dirs, d_roots = hdr.pack_proofs_host(data_incl)

    # chain links: for header i in (t0, t1], its last_block_id leaf embeds
    # root_{i-1}; leaf bytes rebuilt from the PREVIOUS verified root
    link_msgs = []
    link_proofs = []
    prev_root = trusted.header_hash
    for h in rng:
        leaf = block_id_leaf_bytes(
            prev_root, h.header.last_part_set_total, h.header.last_part_set_hash
        )
        link_msgs.append(b"\x00" + leaf)
        sibs_i, dirs_i = hdr.merkle_proof_with_dirs(
            h.header.field_leaves(), enc.LAST_BLOCK_ID_INDEX
        )
        link_proofs.append((sibs_i, dirs_i, h.header_hash))
        prev_root = h.header_hash
    l_blocks, l_nblocks = sha_ops.pack_messages_host(link_msgs)
    depth = len(link_proofs[0][0])
    l_sibs = np.stack(
        [sha_ops.bytes32_to_words([p[0][d] for p in link_proofs]) for d in range(depth)]
    )
    l_dirs = np.array([[p[1][d] for p in link_proofs] for d in range(depth)], dtype=np.uint32)
    l_roots = sha_ops.bytes32_to_words([p[2] for p in link_proofs])

    return SkipWitness(
        trusted_height=trusted_height,
        target_height=target_height,
        trusted_root=trusted.header_hash,
        target_root=target.header_hash,
        trusted_set=build_valset_witness(trusted_set),
        target_set=build_valset_witness(target_set),
        sign_bytes=target.sign_bytes(),
        signatures=list(target.signatures),
        target_signed=target_signed,
        trusted_signed=trusted_signed,
        valset_inclusions=InclusionWitness(values, sibs, dirs, roots),
        data_hash_inclusions=InclusionWitness(d_values, d_sibs, d_dirs, d_roots),
        chain_links=ChainLinkWitness(l_blocks, l_nblocks, l_sibs, l_dirs, l_roots),
        range_heights=np.arange(trusted_height + 1, target_height + 1, dtype=np.uint64),
        range_data_hashes=[h.header.data_hash for h in rng],
    )


def _valset_from_fields(d) -> ValSetWitness:
    return ValSetWitness(
        pubkeys=[bytes(pk) for pk in d["pubkeys"]],
        powers=np.asarray(d["powers"], dtype=np.uint64),
        blocks=np.asarray(d["blocks"], dtype=np.uint32),
        n_blocks=np.asarray(d["n_blocks"], dtype=np.int32),
        expected_root=bytes(d["expected_root"]),
    )


def _inclusion_from_fields(d) -> InclusionWitness:
    return InclusionWitness(
        *(np.asarray(d[k], dtype=np.uint32) for k in ("values", "siblings", "dirs", "roots"))
    )


def _chain_link_from_fields(d) -> ChainLinkWitness:
    return ChainLinkWitness(
        blocks=np.asarray(d["blocks"], dtype=np.uint32),
        n_blocks=np.asarray(d["n_blocks"], dtype=np.int32),
        siblings=np.asarray(d["siblings"], dtype=np.uint32),
        dirs=np.asarray(d["dirs"], dtype=np.uint32),
        roots=np.asarray(d["roots"], dtype=np.uint32),
    )


def witness_from_reference(fields: dict) -> SkipWitness:
    """A SkipWitness from the JAX package's witness fields, e.g.
    ``dataclasses.asdict(jax_witness)``: numpy arrays, bytes and ints, with
    the nested witnesses as dicts. The two packages then prove the same
    input."""
    f = fields
    return SkipWitness(
        trusted_height=int(f["trusted_height"]),
        target_height=int(f["target_height"]),
        trusted_root=bytes(f["trusted_root"]),
        target_root=bytes(f["target_root"]),
        trusted_set=_valset_from_fields(f["trusted_set"]),
        target_set=_valset_from_fields(f["target_set"]),
        sign_bytes=bytes(f["sign_bytes"]),
        signatures=[bytes(s) for s in f["signatures"]],
        target_signed=np.asarray(f["target_signed"], dtype=bool),
        trusted_signed=np.asarray(f["trusted_signed"], dtype=bool),
        valset_inclusions=_inclusion_from_fields(f["valset_inclusions"]),
        data_hash_inclusions=_inclusion_from_fields(f["data_hash_inclusions"]),
        chain_links=_chain_link_from_fields(f["chain_links"]),
        range_heights=np.asarray(f["range_heights"], dtype=np.uint64),
        range_data_hashes=[bytes(h) for h in f["range_data_hashes"]],
    )


def step_witness_from_reference(fields: dict):
    """A circuits.step.StepWitness from the JAX package's step witness
    fields (``dataclasses.asdict(jax_step_witness)``), as
    witness_from_reference does for the skip witness."""
    from blobstreamx_tpu_torch.circuits.step import StepWitness

    f = fields
    return StepWitness(
        prev_height=int(f["prev_height"]),
        prev_root=bytes(f["prev_root"]),
        new_root=bytes(f["new_root"]),
        new_set=_valset_from_fields(f["new_set"]),
        sign_bytes=bytes(f["sign_bytes"]),
        signatures=[bytes(s) for s in f["signatures"]],
        signed=np.asarray(f["signed"], dtype=bool),
        inclusions=_inclusion_from_fields(f["inclusions"]),
        chain_link=_chain_link_from_fields(f["chain_link"]),
    )
