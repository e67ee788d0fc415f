"""The skip and step prover pipelines: the skip proof at the default, the
SHA-256 and the full-coverage SHA-256 tiers, each with or without the
Ed25519 STARK, and the step proof.

Pipeline for one skip proof:

  witness   host: pack the ChainFixture slice into device inputs
  consensus device: valset hashing, Ed25519 MSM batch, inclusion folds,
            chain links, power sums, data commitment
  trace     host: lay out the consensus-arithmetic execution trace
  sha_stark device (with_sha_stark=True or "full"): the batched SHA-256
            STARK over every hash of the data-commitment tuple tree, or
            over every hash of the skip relation, one STARK a block shard
  ed_stark  device (with_ed_stark=True): the Ed25519 scalar-mul STARK over
            every scalar multiplication of the signature batch equation
  stark     device: DEEP-ALI prove over SkipAir

A step proof (header h -> h+1, prove_step) runs the step relation's
consensus (circuits.step) and a DEEP-ALI prove over StepAir.

Trust model:

  default              the DEEP-ALI STARK proves the *consensus arithmetic*
                       — boolean signer masks, voting-power accumulators,
                       their claimed totals — over a committed trace whose
                       public inputs bind the trusted/target roots, heights,
                       and the data commitment into the Fiat-Shamir
                       transcript. Hash/signature facts are established by
                       bit-exact deterministic device recomputation.
  with_sha_stark=True  additionally proves the data-commitment tuple tree's
                       hashes in the batched SHA-256 STARK (prover.sha_claims).
  with_sha_stark="full" proves EVERY SHA-256 of the skip relation — both
                       validator-set trees, the validators_hash inclusion
                       paths, every chain link and data_hash path, and the
                       tuple tree — in batched SHA-256 STARKs, one a block
                       shard (prover.skip_claims).
  with_ed_stark=True   additionally proves every scalar multiplication of
                       the signature batch equation in the Ed25519 STARK
                       (prover.ed_claims); the verifier re-derives the
                       scalars and points and sums the claimed results.
                       With with_sha_stark="full" this is the strongest
                       tier: every hash and every signature proven.

Bundle binding: the aux STARKs are proven FIRST and a SHA-256 digest of each
claim list enters the main SkipAir STARK's public inputs (publics 30..37;
38..45 for the Ed25519 STARK), so the transcripts form one tamper-evident
object. The proof bytes equal the JAX package's for the same witness,
config and tier, and either package's verifier accepts the other's proofs.

verify_skip_proof() re-checks the STARK(s), the threshold inequalities over
the public integers, the digest binding, and — given the claimed witness
data, passed or embedded in the proof — the tuple-tree or full-coverage
claim walk, the Ed25519 batch equation and the signer/power binding.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

import numpy as np

from blobstreamx_tpu_torch.circuits.skip import SkipCheckResult, SkipPublicOutputs, verify_skip
from blobstreamx_tpu_torch.circuits.step import StepCheckResult, StepPublicOutputs, verify_step
from blobstreamx_tpu_torch.circuits.witness import SkipWitness
from blobstreamx_tpu_torch.device import resolve, resolve_with_mesh
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.prover import ed_claims, serialize, sha_claims, skip_claims, stark
from blobstreamx_tpu_torch.prover.air import Air
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.utils.checkpoint import PhaseCheckpointer
from blobstreamx_tpu_torch.utils.metrics import MetricsWriter
from blobstreamx_tpu_torch.utils.timing import TimingTree

P = gold.P


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


class StepAir(Air):
    """Consensus arithmetic of the step relation, one validator of the NEW
    set per row: p (power), b (signed bit), a (signed acc), t (total acc).
    Publics: [0] signed, [1] total, then 8 u32 words each of prev_root and
    new_root, then prev_height, new_height (20)."""

    n_cols = 4
    max_degree = 2
    N_PUBLICS = 20

    def eval_constraints(self, local, nxt, publics, alg, **frame):
        p, b, a, t = local
        p_n, b_n, a_n, t_n = nxt
        one = alg.const(1)
        return [
            (alg.mul(b, alg.sub(b, one)), "all"),
            (alg.sub(a, alg.mul(b, p)), "first"),
            (alg.sub(t, p), "first"),
            (alg.sub(a_n, alg.add(a, alg.mul(b_n, p_n))), "transition"),
            (alg.sub(t_n, alg.add(t, p_n)), "transition"),
            (alg.sub(a, publics[0]), "last"),
            (alg.sub(t, publics[1]), "last"),
        ]


def _pack_bytes32(b: bytes) -> list[int]:
    return [int.from_bytes(b[i : i + 4], "big") for i in range(0, 32, 4)]


def sha_claim_digest(sha_proof) -> bytes:
    """Canonical SHA-256 digest of a batched-SHA STARK's claim list (the aux
    (message-words, digest) stream plus, for the full-coverage proof, its
    claimed link fields). Bound into the main STARK's publics so the aux
    proof cannot be swapped across skip proofs. bytes(32) when absent."""
    if sha_proof is None:
        return bytes(32)
    h = hashlib.sha256()
    h.update(b"full" if hasattr(sha_proof, "link_fields") else b"tree")
    h.update(int(sha_proof.n_rows).to_bytes(8, "big"))
    for w, o in sha_proof.aux:
        for v in list(w) + list(o):
            h.update(int(v).to_bytes(4, "big"))
    for total, psh in getattr(sha_proof, "link_fields", []):
        h.update(int(total).to_bytes(8, "big"))
        h.update(bytes(psh))
    return h.digest()


def ed_claim_digest(ed_proof) -> bytes:
    """Canonical digest of the Ed25519 scalar-mul STARK's claim list
    ((scalar, point, result) per segment). bytes(32) when absent."""
    if ed_proof is None:
        return bytes(32)
    h = hashlib.sha256()
    h.update(int(ed_proof.n_rows).to_bytes(8, "big"))
    for s, pt, out in ed_proof.aux:
        h.update(int(s).to_bytes(32, "little"))
        h.update(int(pt[0]).to_bytes(32, "little"))
        h.update(int(pt[1]).to_bytes(32, "little"))
        for v in out:
            h.update(int(v).to_bytes(32, "little"))
    return h.digest()


def skip_publics(
    res_outputs: SkipPublicOutputs,
    res: SkipCheckResult,
    sha_digest: bytes = bytes(32),
    ed_digest: bytes = bytes(32),
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
    # the batched-SHA STARK proving every hash of the data-commitment tuple
    # tree (prover.sha_claims.ShaStarkProof, with_sha_stark=True) or every
    # hash of the skip relation (prover.skip_claims.SkipShaProof, "full")
    sha_stark: object | None = None
    # the Ed25519 scalar-mul STARK over the signature batch equation
    # (prover.ed_claims.EdStarkProof, with_ed_stark=True)
    ed_stark: object | None = None
    # the embedded claim bundle (SkipClaimData): UNTRUSTED hints that make
    # the serialized proof self-contained — the verifier re-derives the claim
    # digests bound in publics[30:46] from the aux proofs, and walks the
    # claims against the STARK-proven digests before they count
    claims: object | None = None


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


def _proof_bytes_arr(obj_dict: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(obj_dict, separators=(",", ":")).encode(), np.uint8)


def _proof_from_arr(arr: np.ndarray) -> dict:
    return json.loads(bytes(arr.tobytes()).decode())


def prove_skip(
    witness: SkipWitness,
    config: StarkConfig | None = None,
    device=None,
    metrics: MetricsWriter | None = None,
    checkpoint_dir: str | None = None,
    with_sha_stark: bool | str = False,
    with_ed_stark: bool = False,
    mesh=None,
) -> SkipProof:
    """The skip pipeline on `device` (default: the card; raises when CUDA is
    missing unless device="cpu" is passed). Raises ValueError (fail-stop) if
    the witness does not satisfy the skip relation.

    mesh (parallel.mesh.Mesh): every rank calls prove_skip with the same
    arguments and gets the same proof, byte for byte the single-device one:
    the data commitment, the Ed25519 STARK and the SkipAir STARK run over
    the ranks, the rest (the SHA tiers too) on every rank. device= must
    agree with the mesh's device (ValueError). Checkpoints are written by
    rank 0 alone and read by every rank.

    with_sha_stark=True also proves the data-commitment tuple tree in the
    batched SHA-256 STARK (through stark_stream.prove_auto, which streams it
    when the standard prover would not fit the device); with_sha_stark="full"
    proves every hash of the skip relation, one STARK a shard of at most
    skip_claims.DEFAULT_MAX_SHARD_BLOCKS blocks, each through prove_auto.
    with_ed_stark=True also proves every scalar multiplication of the
    signature batch equation in the Ed25519 STARK (through prove_auto).
    Any aux STARK embeds the claim bundle in the proof.

    Resume: with checkpoint_dir set, every completed phase (consensus,
    trace, sha_stark, ed_stark, stark) is saved under
    <checkpoint_dir>/skip-<key>, keyed by the witness fingerprint, the
    config and the tier flags, in the JAX package's layout; a later call
    with the same directory and key loads the completed phases, whole aux
    STARK proofs included, instead of proving them again (see
    utils.failure.run_with_retry). metrics receives the closing "timing"
    record, and "skip_rejected" before the fail-stop."""
    device = resolve_with_mesh(device, mesh)
    config = config or StarkConfig()
    metrics = metrics or MetricsWriter(None)
    with TimingTree("prove_skip") as timing:
        key = hashlib.sha256(
            witness_fingerprint(witness)
            + repr(config).encode()
            + f"|sha={with_sha_stark}|ed={with_ed_stark}".encode()
        ).hexdigest()[:32]
        # keyed by the proof's identity, not by a run id: a retry of the same
        # (witness, config, flags), in this process or another, finds the
        # completed phases of the attempt before it
        ckpt = PhaseCheckpointer(checkpoint_dir, f"skip-{key}", read_only=mesh is not None and mesh.rank != 0)

        def load(phase: str):
            r = ckpt.load(phase)
            return r if r is not None and r[1].get("key") == key else None

        saved_trace = load("trace")
        saved_cons = load("consensus")
        if saved_trace is not None and saved_cons is not None:
            arrays, scalars = saved_cons
            outputs = SkipPublicOutputs(
                trusted_height=int(scalars["trusted_height"]),
                trusted_root=bytes.fromhex(scalars["trusted_root"]),
                target_height=int(scalars["target_height"]),
                target_root=bytes.fromhex(scalars["target_root"]),
                data_commitment=bytes.fromhex(scalars["data_commitment"]),
            )
            res = SkipCheckResult(
                ok=True,
                reasons=[],
                outputs=outputs,
                target_powers=arrays["target_powers"],
                target_signed=arrays["target_signed"].astype(bool),
                trusted_powers=arrays["trusted_powers"],
                trusted_signed=arrays["trusted_signed"].astype(bool),
                signed_target_power=int(scalars["signed_target"]),
                total_target_power=int(scalars["total_target"]),
                signed_trusted_power=int(scalars["signed_trusted"]),
                total_trusted_power=int(scalars["total_trusted"]),
            )
            trace = saved_trace[0]["trace"]
            timing.note("consensus+trace resumed from checkpoint")
        else:
            with timing.scope("consensus", items=len(witness.range_heights), unit="headers", sync=device):
                res = verify_skip(witness, device=device, mesh=mesh)
            if not res.ok:
                metrics.emit("skip_rejected", reasons=res.reasons)
                raise ValueError(f"skip relation unsatisfied: {res.reasons}")
            ckpt.save(
                "consensus",
                arrays={
                    "target_powers": np.asarray(res.target_powers, np.uint64),
                    "target_signed": np.asarray(res.target_signed, np.uint8),
                    "trusted_powers": np.asarray(res.trusted_powers, np.uint64),
                    "trusted_signed": np.asarray(res.trusted_signed, np.uint8),
                },
                scalars={
                    "key": key,
                    "signed_target": int(res.signed_target_power),
                    "total_target": int(res.total_target_power),
                    "signed_trusted": int(res.signed_trusted_power),
                    "total_trusted": int(res.total_trusted_power),
                    "trusted_height": int(res.outputs.trusted_height),
                    "trusted_root": res.outputs.trusted_root.hex(),
                    "target_height": int(res.outputs.target_height),
                    "target_root": res.outputs.target_root.hex(),
                    "data_commitment": res.outputs.data_commitment.hex(),
                },
            )
            with timing.scope("trace"):
                trace = build_skip_trace(res)
            ckpt.save("trace", arrays={"trace": trace}, scalars={"key": key})

        # the aux STARKs are proven BEFORE the main STARK so their claim
        # digests enter the main transcript
        sha_proof = None
        if with_sha_stark:
            saved = load("sha_stark")
            if saved is not None:
                sha_proof = serialize.sha_claims_from_dict(_proof_from_arr(saved[0]["proof"]))
                timing.note("sha_stark resumed from checkpoint")
            elif with_sha_stark == "full":
                with timing.scope("sha_stark", items=len(witness.range_heights), unit="headers", sync=device):
                    sha_proof = skip_claims.prove_skip_sha_stark(witness, config, device=device, timing=timing)
            else:
                heights = [int(h) for h in witness.range_heights]
                with timing.scope("sha_stark", items=len(heights), unit="leaves", sync=device):
                    sha_proof, sha_root = sha_claims.prove_data_commitment_stark(
                        heights, witness.range_data_hashes, config, device=device, timing=timing
                    )
                if sha_root != res.outputs.data_commitment:
                    raise ValueError("sha-stark root mismatch vs device data commitment")
            if saved is None:
                ckpt.save(
                    "sha_stark",
                    arrays={"proof": _proof_bytes_arr(serialize.sha_claims_to_dict(sha_proof))},
                    scalars={"key": key},
                )

        ed_proof = None
        if with_ed_stark:
            saved = load("ed_stark")
            if saved is not None:
                ed_proof = serialize.ed_claims_from_dict(_proof_from_arr(saved[0]["proof"]))
                timing.note("ed_stark resumed from checkpoint")
            else:
                items = signature_items(witness)
                with timing.scope("ed_stark", items=len(items), unit="signatures", sync=device):
                    ed_proof = ed_claims.prove_batch_stark(items, config=config, device=device, timing=timing,
                                                           mesh=mesh)
                ckpt.save(
                    "ed_stark",
                    arrays={"proof": _proof_bytes_arr(serialize.ed_claims_to_dict(ed_proof))},
                    scalars={"key": key},
                )

        publics = skip_publics(res.outputs, res, sha_claim_digest(sha_proof), ed_claim_digest(ed_proof))
        saved = load("stark")
        if saved is not None and saved[1].get("publics") == [int(v) for v in publics]:
            proof = serialize.stark_proof_from_dict(_proof_from_arr(saved[0]["proof"]))
            timing.note("stark resumed from checkpoint")
        else:
            with timing.scope("stark", items=trace.shape[0], unit="rows", sync=device):
                proof = stark.prove(SkipAir(), trace, publics, config, device=device, mesh=mesh, timing=timing)
            ckpt.save(
                "stark",
                arrays={"proof": _proof_bytes_arr(serialize.stark_proof_to_dict(proof))},
                scalars={"key": key, "publics": [int(v) for v in publics]},
            )

    metrics.emit_timing(
        timing,
        n_headers=int(len(witness.range_heights)),
        n_validators=int(len(res.target_powers)),
        n_rows=int(trace.shape[0]),
    )
    return SkipProof(
        outputs=res.outputs,
        publics=publics,
        n_rows=trace.shape[0],
        stark=proof,
        timing=timing.render(),
        sha_stark=sha_proof,
        ed_stark=ed_proof,
        # the untrusted hint bundle rides along whenever an aux STARK is
        # present, so the serialized proof verifies self-contained
        claims=claim_data_from_witness(witness)
        if (sha_proof is not None or ed_proof is not None)
        else None,
    )


@dataclass
class StepProof:
    outputs: StepPublicOutputs
    publics: list[int]
    n_rows: int
    stark: stark.StarkProof
    timing: str  # rendered TimingTree


def step_publics(res: StepCheckResult) -> list[int]:
    out = res.outputs
    return (
        [res.signed_power, res.total_power]
        + _pack_bytes32(out.prev_root)
        + _pack_bytes32(out.new_root)
        + [out.prev_height, out.new_height]
    )


def build_step_trace(res: StepCheckResult) -> np.ndarray:
    n = max(len(res.powers), 2)
    n = 1 << (n - 1).bit_length()
    p = np.zeros(n, dtype=np.uint64)
    b = np.zeros(n, dtype=np.uint64)
    p[: len(res.powers)] = res.powers
    b[: len(res.signed)] = res.signed.astype(np.uint64)
    acc = np.cumsum((p * b).astype(object))
    tot = np.cumsum(p.astype(object))
    return np.stack(
        [
            p,
            b,
            np.array([int(x) % P for x in acc], np.uint64),
            np.array([int(x) % P for x in tot], np.uint64),
        ],
        axis=1,
    )


def prove_step(witness, config: StarkConfig | None = None, device=None) -> StepProof:
    """The step pipeline (header h -> h+1) on `device` (default: the card;
    raises when CUDA is missing unless device="cpu" is passed): the step
    relation's consensus checks, then the DEEP-ALI STARK over StepAir.
    Raises ValueError (fail-stop) if the witness does not satisfy it."""
    device = resolve(device)
    config = config or StarkConfig()
    with TimingTree("prove_step") as timing:
        with timing.scope("consensus", sync=device):
            res = verify_step(witness, device=device)
        if not res.ok:
            raise ValueError(f"step relation unsatisfied: {res.reasons}")
        with timing.scope("trace"):
            trace = build_step_trace(res)
            publics = step_publics(res)
        with timing.scope("stark", items=trace.shape[0], unit="rows", sync=device):
            proof = stark.prove(StepAir(), trace, publics, config, device=device, timing=timing)
    return StepProof(
        outputs=res.outputs,
        publics=publics,
        n_rows=trace.shape[0],
        stark=proof,
        timing=timing.render(),
    )


def verify_step_proof(proof: StepProof, config: StarkConfig | None = None) -> bool:
    """Host verifier for a step proof: >2/3 threshold over the public sums,
    public consistency with the claimed outputs, and the STARK."""
    config = config or StarkConfig()
    pub = proof.publics
    if len(pub) != StepAir.N_PUBLICS:
        return False
    signed, total = pub[:2]
    if not signed * 3 > total * 2:
        return False
    out = proof.outputs
    if pub[2:10] != _pack_bytes32(out.prev_root):
        return False
    if pub[10:18] != _pack_bytes32(out.new_root):
        return False
    if pub[18:] != [out.prev_height, out.new_height]:
        return False
    if out.new_height != out.prev_height + 1:
        return False
    return stark.verify(StepAir(), proof.stark, pub, config, proof.n_rows)


@dataclass
class SkipClaimData:
    """Claimed witness data the verifier needs to walk the aux STARK claims
    and check the signer/power binding (all untrusted hints — every field is
    checked against the STARK-proven claims and the public inputs before it
    influences the verdict)."""

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
    """Host verifier. Returns (ok, detail) where detail records what was
    checked vs skipped for each sub-proof.

    Always checked: the main STARK transcript, threshold inequalities,
    public consistency, and the aux-claim DIGEST binding (publics 30..45) —
    a stripped or swapped aux proof fails here even without claim data.

    With claims (supplied, or else embedded in the proof): the SHA STARK's
    claim walk (the tuple tree, or for a "full" proof the full-coverage walk
    — validator trees, inclusion paths, chain links — anchored at the public
    roots), the Ed25519 STARK's batch equation over the claimed signature
    items, and the signer/power binding between the claimed lists and the
    public sums. An aux STARK without the claim data its check needs fails
    closed, and so does an Ed25519 STARK whose embedded bundle lacks the
    validator lists of the binding."""
    config = config or StarkConfig()
    claims_src = "supplied"
    if claims is None:
        claims = getattr(proof, "claims", None)
        claims_src = "embedded" if claims is not None else "none"
    detail = {
        "stark": "unchecked",
        "sha_stark": "absent" if proof.sha_stark is None else "present",
        "ed_stark": "absent" if proof.ed_stark is None else "present",
        "claims": claims_src,
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
    # digest binding: the aux claim lists this proof was made with
    if pub[30:38] != _pack_bytes32(sha_claim_digest(proof.sha_stark)):
        detail["sha_stark"] = "failed: claim digest not bound in transcript"
        return False, detail
    if pub[38:46] != _pack_bytes32(ed_claim_digest(proof.ed_stark)):
        detail["ed_stark"] = "failed: claim digest not bound in transcript"
        return False, detail
    if not stark.verify(SkipAir(), proof.stark, pub, config, proof.n_rows):
        detail["stark"] = "failed: STARK rejected"
        return False, detail
    detail["stark"] = "ok"

    if proof.sha_stark is not None:
        is_full = hasattr(proof.sha_stark, "link_fields")
        have_range = claims is not None and claims.range_heights is not None
        if is_full and have_range and claims.trusted_vals is not None:
            if not skip_claims.verify_skip_sha_stark(
                proof.sha_stark,
                trusted_root=out.trusted_root,
                target_root=out.target_root,
                trusted_vals=claims.trusted_vals,
                target_vals=claims.target_vals,
                range_heights=[int(h) for h in claims.range_heights],
                range_data_hashes=claims.range_data_hashes,
                data_commitment=out.data_commitment,
                config=config,
            ):
                detail["sha_stark"] = "failed: full claim walk rejected"
                return False, detail
            detail["sha_stark"] = "ok: full coverage"
        elif not is_full and have_range:
            if not sha_claims.verify_data_commitment_stark(
                proof.sha_stark,
                [int(h) for h in claims.range_heights],
                claims.range_data_hashes,
                out.data_commitment,
                config,
            ):
                detail["sha_stark"] = "failed: tuple-tree claim walk rejected"
                return False, detail
            detail["sha_stark"] = "ok: tuple tree"
        else:
            # FAIL CLOSED: a proof carrying an aux STARK promises its hash
            # claims were proven; without the claim data they cannot be
            # checked, and "present but unverified" must not read as ok
            detail["sha_stark"] = "failed: claim data unavailable (fail closed)"
            return False, detail

    if proof.ed_stark is not None:
        if claims is not None and claims.sign_items is not None:
            if not ed_claims.verify_batch_stark(proof.ed_stark, claims.sign_items, config=config):
                detail["ed_stark"] = "failed: batch equation rejected"
                return False, detail
            detail["ed_stark"] = "ok"
        else:
            # FAIL CLOSED (see sha_stark above)
            detail["ed_stark"] = "failed: claim data unavailable (fail closed)"
            return False, detail

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
    elif proof.ed_stark is not None and claims_src == "embedded":
        # the batch equation alone does not tie the signers to the public
        # power sums. The prover always embeds the validator lists with the
        # signature items, so an embedded bundle without them was truncated:
        # fail closed. (A caller SUPPLYING partial claims chose to;
        # detail["binding"] records the skip.)
        detail["binding"] = "failed: embedded claims lack binding inputs (fail closed)"
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
