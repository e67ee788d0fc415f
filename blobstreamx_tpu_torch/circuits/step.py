"""The step workload: prove header h -> h+1: more than 2/3 of the new
validator set signed, and the validators-hash chain links the two headers.

Relation:
  1. hash(new valset) included at VALIDATORS_HASH in header h+1
  2. the SAME hash included at NEXT_VALIDATORS_HASH in header h — the
     validators-hash chain link
  3. Ed25519 batch over the h+1 commit
  4. signed power > 2/3 of new-set total
  5. header h+1's last_block_id leaf embeds root_h (chain link, as in skip)

Shares all device passes with skip.py; the witness is a 2-header slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from blobstreamx_tpu_torch.circuits import headers as hdr
from blobstreamx_tpu_torch.circuits import validators as vals
from blobstreamx_tpu_torch.circuits.fixtures import ChainFixture
from blobstreamx_tpu_torch.circuits.skip import _power_sums, _valset_root, _verify_link_leaves
from blobstreamx_tpu_torch.circuits.witness import (
    ChainLinkWitness,
    InclusionWitness,
    ValSetWitness,
    _inclusion,
    block_id_leaf_bytes,
    build_valset_witness,
)
from blobstreamx_tpu_torch.device import resolve
from blobstreamx_tpu_torch.golden import encoding as enc
from blobstreamx_tpu_torch.ops import ed25519 as ed_ops, sha256 as sha_ops
from blobstreamx_tpu_torch.utils.timing import maybe_scope, open_tree


@dataclass
class StepWitness:
    prev_height: int
    prev_root: bytes
    new_root: bytes
    new_set: ValSetWitness
    sign_bytes: bytes
    signatures: list[bytes]
    signed: np.ndarray  # (n,) bool
    inclusions: InclusionWitness  # lane 0: valhash in h+1; lane 1: nextvalhash in h
    chain_link: ChainLinkWitness  # h+1's last_block_id under new_root


@dataclass
class StepPublicOutputs:
    prev_height: int
    prev_root: bytes
    new_height: int
    new_root: bytes


@dataclass
class StepCheckResult:
    ok: bool
    reasons: list[str]
    outputs: StepPublicOutputs | None
    powers: np.ndarray
    signed: np.ndarray
    signed_power: int
    total_power: int


def build_step_witness(chain: ChainFixture, prev_height: int) -> StepWitness:
    prev = chain.header_at(prev_height)
    new = chain.header_at(prev_height + 1)
    new_set = chain.val_set_at(prev_height + 1)

    incl = [
        _inclusion(new, enc.VALIDATORS_HASH_INDEX),
        _inclusion(prev, enc.NEXT_VALIDATORS_HASH_INDEX),
    ]
    values, sibs, dirs, roots = hdr.pack_proofs_host(incl)

    leaf = block_id_leaf_bytes(
        prev.header_hash, new.header.last_part_set_total, new.header.last_part_set_hash
    )
    blocks, n_blocks = sha_ops.pack_messages_host([b"\x00" + leaf])
    sibs_l, dirs_l = hdr.merkle_proof_with_dirs(
        new.header.field_leaves(), enc.LAST_BLOCK_ID_INDEX
    )
    link = ChainLinkWitness(
        blocks=blocks,
        n_blocks=n_blocks,
        siblings=np.stack([sha_ops.bytes32_to_words([s]) for s in sibs_l]),
        dirs=np.array([[d] for d in dirs_l], dtype=np.uint32),
        roots=sha_ops.bytes32_to_words([new.header_hash]),
    )

    return StepWitness(
        prev_height=prev_height,
        prev_root=prev.header_hash,
        new_root=new.header_hash,
        new_set=build_valset_witness(new_set),
        sign_bytes=new.sign_bytes(),
        signatures=list(new.signatures),
        signed=np.array(list(new.signed), dtype=bool),
        inclusions=InclusionWitness(values, sibs, dirs, roots),
        chain_link=link,
    )


def verify_step(witness: StepWitness, device=None) -> StepCheckResult:
    """Run the step relation on `device` (default: the card; raises when
    CUDA is missing unless device="cpu" is passed). The TimingTree open on
    this thread (utils.timing.open_tree), if any, gets a scope a step
    (valsets, signatures, powers, links), each ending on a host readback
    and a synchronised card."""
    device = resolve(device)
    timing = open_tree()
    reasons: list[str] = []
    w = witness

    def dev(arr):
        return sha_ops.to_device(arr, device)

    def step(name, items, unit):
        return maybe_scope(timing, name, items=items, unit=unit, sync=device)

    n_vals = len(w.new_set.pubkeys)
    with step("valsets", n_vals, "validators"):
        new_vh = sha_ops.digests_to_bytes(_valset_root(w.new_set, device))[0]

        inc = w.inclusions
        inc_ok = hdr.verify_inclusions(
            dev(inc.values), dev(inc.siblings), dev(inc.dirs), dev(inc.roots)
        ).cpu().numpy()
        leaf_vals = sha_ops.digests_to_bytes(inc.values)
        inc_roots = sha_ops.digests_to_bytes(inc.roots)
        if not inc_ok[0] or leaf_vals[0] != new_vh or inc_roots[0] != w.new_root:
            reasons.append("new validators_hash mismatch or not included in h+1")
        if not inc_ok[1] or leaf_vals[1] != new_vh or inc_roots[1] != w.prev_root:
            reasons.append("next_validators_hash chain link broken in h")

    with step("signatures", int(np.count_nonzero(w.signed)), "signatures"):
        items = [
            (pk, w.sign_bytes, sig)
            for pk, sig, s in zip(w.new_set.pubkeys, w.signatures, w.signed)
            if s
        ]
        sig_ok = bool(items) and ed_ops.batch_verify(items, device=device)[0]
        if not sig_ok:
            reasons.append("commit signature batch failed")

    with step("powers", n_vals, "validators"):
        signed_p, total_p = _power_sums(w.new_set, w.signed, device)
        if not vals.threshold_gt(signed_p, total_p, 2, 3):
            reasons.append("commit power <= 2/3")

    cl = w.chain_link
    with step("links", cl.roots.shape[1], "headers"):
        prev_roots = sha_ops.bytes32_to_words([w.prev_root])
        link_ok = _verify_link_leaves(
            dev(cl.blocks), dev(cl.n_blocks), dev(cl.siblings), dev(cl.dirs),
            dev(cl.roots), dev(prev_roots),
        ).cpu().numpy()
        if not link_ok.all() or sha_ops.digests_to_bytes(cl.roots)[0] != w.new_root:
            reasons.append("last_block_id chain link failed")

    outputs = StepPublicOutputs(
        prev_height=w.prev_height,
        prev_root=w.prev_root,
        new_height=w.prev_height + 1,
        new_root=w.new_root,
    )
    return StepCheckResult(
        ok=not reasons,
        reasons=reasons,
        outputs=outputs if not reasons else None,
        powers=w.new_set.powers,
        signed=w.signed,
        signed_power=signed_p,
        total_power=total_p,
    )
