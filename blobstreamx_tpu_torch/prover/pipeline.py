"""The skip prover pipeline at the default trust tier.

Pipeline for one skip proof:

  witness   host: pack the ChainFixture slice into device inputs
  consensus device: valset hashing, Ed25519 MSM batch, inclusion folds,
            chain links, power sums, data commitment
  trace     host: lay out the consensus-arithmetic execution trace
  stark     device: DEEP-ALI prove over SkipAir

Trust model (the default tier): the DEEP-ALI STARK proves the *consensus
arithmetic* — boolean signer masks, voting-power accumulators, their claimed
totals — over a committed trace whose public inputs bind the trusted/target
roots, heights, and the data commitment into the Fiat-Shamir transcript.
Hash/signature facts are established by bit-exact deterministic device
recomputation. The proof bytes equal the JAX package's default-tier proof
for the same witness and config, and either package's verifier accepts the
other's proofs.

verify_skip_proof() re-checks the STARK, the threshold inequalities over the
public integers, the (zero) aux-claim digest words, and — given the claimed
witness data — the signer/power binding.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from blobstreamx_tpu_torch.circuits.skip import SkipCheckResult, SkipPublicOutputs, verify_skip
from blobstreamx_tpu_torch.circuits.witness import SkipWitness
from blobstreamx_tpu_torch.device import resolve
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.prover import stark
from blobstreamx_tpu_torch.prover.air import Air
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.utils.timing import TimingTree

P = gold.P

# the aux-claim digest words of publics[30:46] are zero at the default tier
NO_AUX_DIGEST = bytes(32)


class SkipAir(Air):
    """Consensus arithmetic of the skip relation, one validator per row
    (rows padded with power=0, bit=0 to a power of two).

    Columns: 0 tp (target-set power), 1 tb (signed bit), 2 ta (signed acc),
    3 tt (total acc), 4 rp (trusted power), 5 rb (trusted-signed bit),
    6 ra (signed acc), 7 rt (total acc).

    Publics: [0] signed_target, [1] total_target, [2] signed_trusted,
    [3] total_trusted, then 8 u32 words each of trusted_root, target_root,
    data_commitment, then trusted_height, target_height, then 8 u32 words
    each of the SHA and Ed25519 aux-claim digests (zero when the aux STARK
    is absent) — 46 total. Only 0-3 appear in constraints; the rest are
    transcript-bound (stark.prove observes every public before sampling
    alpha), which is what binds the aux STARKs' claim lists to THIS proof.
    """

    n_cols = 8
    max_degree = 2
    N_PUBLICS = 46

    def eval_constraints(self, local, nxt, publics, alg, **frame):
        tp, tb, ta, tt, rp, rb, ra, rt = local
        tp_n, tb_n, ta_n, tt_n, rp_n, rb_n, ra_n, rt_n = nxt
        one = alg.const(1)
        cs = []
        for b in (tb, rb):  # booleanity
            cs.append((alg.mul(b, alg.sub(b, one)), "all"))
        # first-row accumulator initialisation
        cs.append((alg.sub(ta, alg.mul(tb, tp)), "first"))
        cs.append((alg.sub(tt, tp), "first"))
        cs.append((alg.sub(ra, alg.mul(rb, rp)), "first"))
        cs.append((alg.sub(rt, rp), "first"))
        # transitions: acc' = acc + bit' * power'
        cs.append((alg.sub(ta_n, alg.add(ta, alg.mul(tb_n, tp_n))), "transition"))
        cs.append((alg.sub(tt_n, alg.add(tt, tp_n)), "transition"))
        cs.append((alg.sub(ra_n, alg.add(ra, alg.mul(rb_n, rp_n))), "transition"))
        cs.append((alg.sub(rt_n, alg.add(rt, rp_n)), "transition"))
        # last row pins the four public sums
        cs.append((alg.sub(ta, publics[0]), "last"))
        cs.append((alg.sub(tt, publics[1]), "last"))
        cs.append((alg.sub(ra, publics[2]), "last"))
        cs.append((alg.sub(rt, publics[3]), "last"))
        return cs


def _pack_bytes32(b: bytes) -> list[int]:
    return [int.from_bytes(b[i : i + 4], "big") for i in range(0, 32, 4)]


def skip_publics(
    res_outputs: SkipPublicOutputs,
    res: SkipCheckResult,
    sha_digest: bytes = NO_AUX_DIGEST,
    ed_digest: bytes = NO_AUX_DIGEST,
) -> list[int]:
    return (
        [
            res.signed_target_power,
            res.total_target_power,
            res.signed_trusted_power,
            res.total_trusted_power,
        ]
        + _pack_bytes32(res_outputs.trusted_root)
        + _pack_bytes32(res_outputs.target_root)
        + _pack_bytes32(res_outputs.data_commitment)
        + [res_outputs.trusted_height, res_outputs.target_height]
        + _pack_bytes32(sha_digest)
        + _pack_bytes32(ed_digest)
    )


def build_skip_trace(res: SkipCheckResult) -> np.ndarray:
    n = max(len(res.target_powers), len(res.trusted_powers), 2)
    n = 1 << (n - 1).bit_length()

    def cols(powers, signed):
        p = np.zeros(n, dtype=np.uint64)
        b = np.zeros(n, dtype=np.uint64)
        p[: len(powers)] = powers
        b[: len(signed)] = signed.astype(np.uint64)
        acc = np.cumsum((p * b).astype(object))  # python-int cumsum, no overflow
        tot = np.cumsum(p.astype(object))
        return p, b, np.array([int(x) % P for x in acc], np.uint64), np.array(
            [int(x) % P for x in tot], np.uint64
        )

    tp, tb, ta, tt = cols(res.target_powers, res.target_signed)
    rp, rb, ra, rt = cols(res.trusted_powers, res.trusted_signed)
    return np.stack([tp, tb, ta, tt, rp, rb, ra, rt], axis=1)


@dataclass
class SkipProof:
    outputs: SkipPublicOutputs
    publics: list[int]
    n_rows: int
    stark: stark.StarkProof
    timing: str  # rendered TimingTree


def signature_items(witness: SkipWitness) -> list[tuple[bytes, bytes, bytes]]:
    """The (pubkey, message, signature) triples of the target commit's
    claimed signers — the batch the device MSM verifies (same construction
    as circuits.skip.verify_skip)."""
    return [
        (pk, witness.sign_bytes, sig)
        for pk, sig, s in zip(
            witness.target_set.pubkeys, witness.signatures, witness.target_signed
        )
        if s
    ]


def witness_fingerprint(witness: SkipWitness) -> bytes:
    """Digest of every witness field that influences the proof (equal to the
    JAX package's for the same witness)."""
    w = witness
    h = hashlib.sha256()
    h.update(int(w.trusted_height).to_bytes(8, "big"))
    h.update(int(w.target_height).to_bytes(8, "big"))
    h.update(w.trusted_root)
    h.update(w.target_root)
    for vs in (w.trusted_set, w.target_set):
        for pk, p in zip(vs.pubkeys, vs.powers):
            h.update(pk)
            h.update(int(p).to_bytes(8, "big"))
    h.update(w.sign_bytes)
    for sig in w.signatures:
        h.update(len(sig).to_bytes(2, "big"))
        h.update(sig)
    h.update(np.asarray(w.target_signed, np.uint8).tobytes())
    h.update(np.asarray(w.trusted_signed, np.uint8).tobytes())
    for arr in (
        w.valset_inclusions.siblings,
        w.data_hash_inclusions.siblings,
        w.chain_links.blocks,
        w.chain_links.siblings,
    ):
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(np.asarray(w.range_heights, np.uint64).tobytes())
    for d in w.range_data_hashes:
        h.update(d)
    return h.digest()


def prove_skip(
    witness: SkipWitness,
    config: StarkConfig | None = None,
    device=None,
) -> SkipProof:
    """The default-tier skip pipeline on `device` (default: the card; raises
    when CUDA is missing unless device="cpu" is passed). Raises ValueError
    (fail-stop) if the witness does not satisfy the skip relation."""
    device = resolve(device)
    config = config or StarkConfig()
    timing = TimingTree("prove_skip")
    with timing.scope("consensus", items=len(witness.range_heights), unit="headers", sync=device):
        res = verify_skip(witness, device=device)
    if not res.ok:
        raise ValueError(f"skip relation unsatisfied: {res.reasons}")
    with timing.scope("trace"):
        trace = build_skip_trace(res)
    publics = skip_publics(res.outputs, res)
    with timing.scope("stark", items=trace.shape[0], unit="rows", sync=device):
        proof = stark.prove(SkipAir(), trace, publics, config, device=device)
    timing.finish()
    return SkipProof(
        outputs=res.outputs,
        publics=publics,
        n_rows=trace.shape[0],
        stark=proof,
        timing=timing.render(),
    )


@dataclass
class SkipClaimData:
    """Claimed witness data for the signer/power binding check (untrusted
    hints — checked against the public inputs before they influence the
    verdict)."""

    range_heights: list[int] | None = None
    range_data_hashes: list[bytes] | None = None
    sign_items: list[tuple[bytes, bytes, bytes]] | None = None  # (pk, msg, sig)
    trusted_vals: list[tuple[bytes, int]] | None = None  # (pubkey, power)
    target_vals: list[tuple[bytes, int]] | None = None


def claim_data_from_witness(witness: SkipWitness) -> SkipClaimData:
    """The claim hints a proof carrier would ship alongside a skip proof."""
    return SkipClaimData(
        range_heights=[int(h) for h in witness.range_heights],
        range_data_hashes=list(witness.range_data_hashes),
        sign_items=signature_items(witness),
        trusted_vals=[
            (pk, int(p))
            for pk, p in zip(witness.trusted_set.pubkeys, witness.trusted_set.powers)
        ],
        target_vals=[
            (pk, int(p))
            for pk, p in zip(witness.target_set.pubkeys, witness.target_set.powers)
        ],
    )


def _check_signer_binding(proof: SkipProof, claims: SkipClaimData) -> str:
    """Cross-check the claimed signature batch against the claimed validator
    lists and the PUBLIC power sums — pure host arithmetic + strict protobuf
    parsing, no hashing, no curve ops.

    Together with the full SHA STARK (validator lists hash to the public
    header roots) and the Ed25519 STARK (those signatures verify), this
    closes the binding loop: publics[0..3], which the consensus STARK pins to
    its accumulator trace, must equal the sums derived from the proven lists
    and signer set. Returns "ok" or a failure reason."""
    from blobstreamx_tpu_torch.golden import encoding as enc

    out = proof.outputs
    items = claims.sign_items
    # one shared canonical message naming the target header
    msgs = {msg for _, msg, _ in items}
    if len(msgs) != 1:
        return "signers disagree on the signed message"
    vote = enc.parse_canonical_vote(next(iter(msgs)))
    if vote is None:
        return "sign-bytes is not a canonical precommit vote"
    height, _round, block_hash = vote[0], vote[1], vote[2]
    if block_hash != out.target_root:
        return "vote does not name the public target root"
    if height != out.target_height:
        return "vote height mismatch"
    # distinct signers, all members of the claimed target set
    target_power = dict()
    for pk, p in claims.target_vals:
        if pk in target_power:
            return "duplicate pubkey in target validator list"
        target_power[pk] = int(p)
    trusted_power = dict()
    for pk, p in claims.trusted_vals:
        if pk in trusted_power:
            return "duplicate pubkey in trusted validator list"
        trusted_power[pk] = int(p)
    signers = set()
    for pk, _msg, _sig in items:
        if pk in signers:
            return "duplicate signer"
        if pk not in target_power:
            return "signer not in target validator set"
        signers.add(pk)
    signed_t = sum(target_power[pk] for pk in signers)
    total_t = sum(target_power.values())
    signed_r = sum(p for pk, p in trusted_power.items() if pk in signers)
    total_r = sum(trusted_power.values())
    if [signed_t, total_t, signed_r, total_r] != proof.publics[:4]:
        return "claimed lists disagree with the public power sums"
    return "ok"


def verify_skip_proof_detailed(
    proof: SkipProof,
    config: StarkConfig | None = None,
    claims: SkipClaimData | None = None,
) -> tuple[bool, dict]:
    """Host verifier of a default-tier skip proof. Returns (ok, detail).

    Always checked: the threshold inequalities, public consistency with the
    outputs, the zero aux-claim digest words (publics 30..45: this tier
    carries no aux STARKs) and the STARK transcript. With claims supplied:
    the signer/power binding between the claimed lists and the public sums."""
    config = config or StarkConfig()
    detail = {
        "stark": "unchecked",
        "claims": "supplied" if claims is not None else "none",
        "binding": "skipped: claim data not supplied",
    }
    pub = proof.publics
    if len(pub) != SkipAir.N_PUBLICS:
        detail["stark"] = "failed: wrong public count"
        return False, detail
    signed_t, total_t, signed_r, total_r = pub[:4]
    if not (signed_t * 3 > total_t * 2 and signed_r * 3 > total_r):
        detail["stark"] = "failed: threshold inequality"
        return False, detail
    out = proof.outputs
    if (
        pub[4:12] != _pack_bytes32(out.trusted_root)
        or pub[12:20] != _pack_bytes32(out.target_root)
        or pub[20:28] != _pack_bytes32(out.data_commitment)
        or pub[28:30] != [out.trusted_height, out.target_height]
    ):
        detail["stark"] = "failed: outputs disagree with publics"
        return False, detail
    if out.target_height <= out.trusted_height:
        detail["stark"] = "failed: non-increasing height"
        return False, detail
    if pub[30:46] != _pack_bytes32(NO_AUX_DIGEST) * 2:
        detail["stark"] = "failed: aux-claim digests bound, but this tier has no aux STARKs"
        return False, detail
    if not stark.verify(SkipAir(), proof.stark, pub, config, proof.n_rows):
        detail["stark"] = "failed: STARK rejected"
        return False, detail
    detail["stark"] = "ok"

    if (
        claims is not None
        and claims.sign_items is not None
        and claims.trusted_vals is not None
        and claims.target_vals is not None
    ):
        r = _check_signer_binding(proof, claims)
        detail["binding"] = r if r == "ok" else f"failed: {r}"
        if r != "ok":
            return False, detail
    return True, detail


def verify_skip_proof(
    proof: SkipProof,
    config: StarkConfig | None = None,
    claims: SkipClaimData | None = None,
) -> bool:
    """Boolean wrapper over verify_skip_proof_detailed."""
    ok, _ = verify_skip_proof_detailed(proof, config, claims)
    return ok
