"""The skip workload: prove trusted header h1 -> target header h2 given
sufficient voting power, plus the data commitment over (h1, h2].

Relation checked, as a fixed schedule of device passes:

  1. hash(trusted valset) included at VALIDATORS_HASH in trusted header
  2. hash(target valset)  included at VALIDATORS_HASH in target header
  3. Ed25519: every claimed signer of the target commit verifies over the
     canonical sign-bytes (batched MSM)
  4. signed power > 2/3 of target-set total power
  5. trusted-set members who signed > 1/3 of trusted total  (skip condition)
  6. header chain: for every i in (h1, h2], header i's last_block_id leaf —
     rebuilt from the previous verified root — is included under root_i
  7. data_hash(i) included under root_i for the whole range
  8. data commitment = tuple-tree root over (height_i, data_hash_i)

Soundness note on 6: the witness does not get to choose the embedded
previous hash — block_id_leaf_bytes() constructs the leaf FROM root_{i-1}
(anchored at the trusted root), so inclusion under root_i proves the link.

The verifier is one host function running device passes on `device`; its
scalar outcome feeds SkipAir (prover/pipeline.py), whose STARK binds the
consensus arithmetic and public outputs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from blobstreamx_tpu_torch.circuits import headers as hdr
from blobstreamx_tpu_torch.circuits import validators as vals
from blobstreamx_tpu_torch.circuits.data_commitment import data_commitment_device
from blobstreamx_tpu_torch.circuits.witness import SkipWitness, ValSetWitness
from blobstreamx_tpu_torch.device import resolve_with_mesh
from blobstreamx_tpu_torch.ops import ed25519 as ed_ops, sha256 as sha_ops
from blobstreamx_tpu_torch.utils.timing import maybe_scope, open_tree


@dataclass
class SkipPublicOutputs:
    """The public outputs of a skip proof."""

    trusted_height: int
    trusted_root: bytes
    target_height: int
    target_root: bytes
    data_commitment: bytes


@dataclass
class SkipCheckResult:
    ok: bool
    reasons: list[str]
    outputs: SkipPublicOutputs | None
    # scalar consensus facts consumed by SkipAir
    target_powers: np.ndarray
    target_signed: np.ndarray
    trusted_powers: np.ndarray
    trusted_signed: np.ndarray
    signed_target_power: int
    total_target_power: int
    signed_trusted_power: int
    total_trusted_power: int


def _valset_root(w: ValSetWitness, device):
    return vals.leaf_and_root(sha_ops.to_device(w.blocks, device), sha_ops.to_device(w.n_blocks, device))


def _power_sums(w: ValSetWitness, signed_mask: np.ndarray, device) -> tuple[int, int]:
    lo, hi = vals.powers_to_u32(w.powers)
    s, t = vals.signed_power_sum(
        sha_ops.to_device(lo, device), sha_ops.to_device(hi, device),
        torch.from_numpy(np.asarray(signed_mask, dtype=bool)).to(device),
    )
    return vals.limb_sums_to_int(s), vals.limb_sums_to_int(t)


def _verify_link_leaves(blocks, n_blocks, siblings, dirs, roots, prev_roots):
    """Chain-link check, sound against witness packing: (a) the 0x00-prefixed
    BlockID leaf message hashes and folds to the per-lane root_i; (b) the
    32 bytes EMBEDDED in the leaf at the fixed protobuf offset (message bytes
    3..34: 0x00 prefix, 0x0a tag, 0x20 len, then the hash) equal root_{i-1}."""
    leaf_digests = sha_ops.sha256_packed(blocks, n_blocks)
    computed = hdr.fold_paths(leaf_digests, siblings, dirs)
    included = (computed == roots).all(dim=0)
    w0 = blocks[0]  # (16, N): first block holds bytes 0..63 of the message
    embedded = ((w0[:8] & 0xFF) << 24) | (w0[1:9] >> 8)
    linked = (embedded == prev_roots).all(dim=0)
    return included & linked


def verify_skip(witness: SkipWitness, device=None, mesh=None) -> SkipCheckResult:
    """Run the full skip relation on `device` (default: the card); returns
    scalar facts + outputs. mesh: the data commitment runs over its ranks
    (data_commitment_device), the rest on every rank. The TimingTree open on
    this thread (utils.timing.open_tree), if any, gets a scope a step
    (valsets, signatures, powers, links, data), each ending on a host
    readback and a synchronised card."""
    device = resolve_with_mesh(device, mesh)
    timing = open_tree()
    reasons: list[str] = []
    w = witness

    def dev(arr):
        return sha_ops.to_device(arr, device)

    def step(name, items, unit):
        return maybe_scope(timing, name, items=items, unit=unit, sync=device)

    # --- 1+2: validator-set hashing and inclusion ---------------------------
    n_vals = len(w.trusted_set.pubkeys) + len(w.target_set.pubkeys)
    with step("valsets", n_vals, "validators"):
        trusted_vh = sha_ops.digests_to_bytes(_valset_root(w.trusted_set, device))[0]
        target_vh = sha_ops.digests_to_bytes(_valset_root(w.target_set, device))[0]

        inc = w.valset_inclusions
        inc_ok = hdr.verify_inclusions(
            dev(inc.values), dev(inc.siblings), dev(inc.dirs), dev(inc.roots)
        ).cpu().numpy()
        # lane 0 = trusted valset leaf under trusted root; lane 1 = target.
        # Anchor the witnessed roots to the public trusted/target roots.
        leaf_vals = sha_ops.digests_to_bytes(inc.values)
        inc_roots = sha_ops.digests_to_bytes(inc.roots)
        if not inc_ok[0] or leaf_vals[0] != trusted_vh or inc_roots[0] != w.trusted_root:
            reasons.append("trusted validators_hash mismatch or not included")
        if not inc_ok[1] or leaf_vals[1] != target_vh or inc_roots[1] != w.target_root:
            reasons.append("target validators_hash mismatch or not included")

    # --- 3: Ed25519 batch over the target commit ----------------------------
    with step("signatures", int(np.count_nonzero(w.target_signed)), "signatures"):
        items = [
            (pk, w.sign_bytes, sig)
            for pk, sig, s in zip(w.target_set.pubkeys, w.signatures, w.target_signed)
            if s
        ]
        if items:
            sig_ok, _ = ed_ops.batch_verify(items, device=device)
        else:
            sig_ok = False
        if not sig_ok:
            reasons.append("target commit signature batch failed")

    # --- 4+5: voting-power thresholds ---------------------------------------
    with step("powers", n_vals, "validators"):
        signed_t, total_t = _power_sums(w.target_set, w.target_signed, device)
        signed_tr, total_tr = _power_sums(w.trusted_set, w.trusted_signed, device)
        if not vals.threshold_gt(signed_t, total_t, 2, 3):
            reasons.append("target commit power <= 2/3")
        if not vals.threshold_gt(signed_tr, total_tr, 1, 3):
            reasons.append("trusted-intersection power <= 1/3")

    # --- 6: header chain links ----------------------------------------------
    # prev_roots lane i = root_{i-1}, anchored at the PUBLIC trusted root
    cl = w.chain_links
    with step("links", cl.roots.shape[1], "headers"):
        prev_roots = np.concatenate(
            [sha_ops.bytes32_to_words([w.trusted_root]), cl.roots[:, :-1]], axis=1
        )
        links_ok = _verify_link_leaves(
            dev(cl.blocks), dev(cl.n_blocks), dev(cl.siblings), dev(cl.dirs),
            dev(cl.roots), dev(prev_roots),
        ).cpu().numpy()
        if not links_ok.all():
            reasons.append(f"header chain broken at {int(np.argmin(links_ok))}")
        # the last root in the chain must be the (signed) target root
        if sha_ops.digests_to_bytes(cl.roots[:, -1:])[0] != w.target_root:
            reasons.append("chain does not end at target root")

    # --- 7: data_hash inclusions --------------------------------------------
    dh = w.data_hash_inclusions
    with step("data", len(w.range_heights), "headers"):
        dh_ok = hdr.verify_inclusions(
            dev(dh.values), dev(dh.siblings), dev(dh.dirs), dev(dh.roots)
        ).cpu().numpy()
        if not dh_ok.all():
            reasons.append(f"data_hash inclusion failed at {int(np.argmin(dh_ok))}")
        if sha_ops.digests_to_bytes(dh.roots) != sha_ops.digests_to_bytes(cl.roots):
            reasons.append("data-hash roots disagree with chain-link roots")
        # the committed values must be exactly the verified data hashes and the
        # contiguous height range (trusted, target]
        if sha_ops.digests_to_bytes(dh.values) != list(w.range_data_hashes):
            reasons.append("committed data hashes disagree with verified leaves")
        expect_heights = np.arange(w.trusted_height + 1, w.target_height + 1, dtype=np.uint64)
        if not np.array_equal(np.asarray(w.range_heights, dtype=np.uint64), expect_heights):
            reasons.append("height range is not (trusted, target]")

        # --- 8: data commitment over the range ------------------------------
        commitment = data_commitment_device(w.range_heights, w.range_data_hashes, device, mesh=mesh)

    # signature bit mask must cover exactly the claimed target signers
    # (trusted_signed is derived from target signers by pubkey — recheck)
    signed_pk = {pk for (pk, _, _) in items}
    derived = np.array([pk in signed_pk for pk in w.trusted_set.pubkeys], dtype=bool)
    if not np.array_equal(derived, w.trusted_signed):
        reasons.append("trusted_signed mask inconsistent with target signers")

    outputs = SkipPublicOutputs(
        trusted_height=int(w.trusted_height),
        trusted_root=w.trusted_root,
        target_height=int(w.target_height),
        target_root=w.target_root,
        data_commitment=commitment,
    )
    return SkipCheckResult(
        ok=not reasons,
        reasons=reasons,
        outputs=outputs if not reasons else None,
        target_powers=w.target_set.powers,
        target_signed=w.target_signed,
        trusted_powers=w.trusted_set.powers,
        trusted_signed=w.trusted_signed,
        signed_target_power=signed_t,
        total_target_power=total_t,
        signed_trusted_power=signed_tr,
        total_trusted_power=total_tr,
    )
