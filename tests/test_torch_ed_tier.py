"""The port's Ed25519 STARK tier, prove_skip(with_ed_stark=True), against the
JAX package on the CPU.

Tier-1 (host code, in-process): a skip proof of the 3-header, 1-validator
chain at the default tier carrying Ed25519 claims that the golden model
computed (the scalar multiplications of the signature batch equation; the
Ed STARK inside it is a stand-in, so each package's stark.verify is patched
to accept and only the claim checks decide): the serializer gives the JAX
package's bytes in both directions and refuses a malformed ed_stark; the
pipeline's verifier gives the JAX package's detail on the honest proof and
on changed claims (the digest binding, the batch equation with the digest
re-bound, a changed signature in the bundle), without claim data (fail
closed) and without the validator lists (fail closed when embedded); and
prove_batch_stark fails stop on a malformed signature batch, as the JAX
package's does.

The slow test proves the same chain at the Ed25519 tier on the CPU (one
signature: 3 scalar multiplications, a 4-segment Ed STARK of 2048 rows),
holds the proof's SHA-256 to chip_smoke.TINY_ED_PROOF_SHA256 (phase 4
proves the chain on the card and asserts the same constant), has the JAX
package's verifier accept it, both serializers give equal bytes, both
packages reject each of chip_smoke.ED_TAMPERS with its verdict, and
tests/test_ed_claims.py's tampers (another message, a changed result point)
are rejected by both packages' verify_batch_stark."""

import dataclasses
import hashlib
import json

import pytest
import torch

from blobstreamx_tpu.prover import ed_claims as jax_ed_claims, pipeline as jax_pipeline
from blobstreamx_tpu.prover import serialize as jax_serialize, stark as jax_stark
from blobstreamx_tpu.prover.config import StarkConfig as JaxStarkConfig
from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
from blobstreamx_tpu_torch.golden import ed25519 as ged
from blobstreamx_tpu_torch.prover import ed_claims, pipeline, serialize, stark
from blobstreamx_tpu_torch.prover.config import StarkConfig
from chip_smoke import ED_TAMPERS, TINY_CFG, TINY_CHAIN, TINY_ED_PROOF_SHA256, ed_tamper

torch.set_num_threads(1)
CFG = StarkConfig(**TINY_CFG)
JAX_CFG = JaxStarkConfig(**TINY_CFG)


@pytest.fixture(scope="module")
def witness():
    return wit.build_skip_witness(fx.generate_chain(**TINY_CHAIN), trusted_height=1, target_height=2)


def _golden_ed_stark(items, stand_in):
    """EdStarkProof with the batch equation's claims from the golden model
    and `stand_in` for its STARK."""
    aux = []
    for s, (px, py) in ed_claims.batch_msm_pairs(items):
        aux.append((s, (px, py), ged.point_mul(s, (px, py, 1, px * py % ged.Q))))
    return ed_claims.EdStarkProof(stark=stand_in, aux=aux, n_rows=512 * len(aux))


def _bind(proof, ed):
    """The proof with `ed` as its Ed STARK and its digest in publics 38..45."""
    publics = proof.publics[:38] + pipeline._pack_bytes32(pipeline.ed_claim_digest(ed))
    return dataclasses.replace(proof, ed_stark=ed, publics=publics)


@pytest.fixture(scope="module")
def claimed(witness):
    """A default-tier proof with golden Ed claims bound and the claim bundle
    embedded (its Ed STARK: the main STARK's proof as a stand-in)."""
    proof = pipeline.prove_skip(witness, CFG, device="cpu")
    items = pipeline.signature_items(witness)
    proof = _bind(proof, _golden_ed_stark(items, proof.stark))
    return dataclasses.replace(proof, claims=pipeline.claim_data_from_witness(witness))


def test_serializer_equals_jax_both_ways(claimed):
    blob = serialize.skip_proof_to_bytes(claimed)
    j_proof = jax_serialize.skip_proof_from_bytes(blob)
    assert jax_serialize.skip_proof_to_bytes(j_proof) == blob
    back = serialize.skip_proof_from_bytes(jax_serialize.skip_proof_to_bytes(j_proof))
    assert serialize.skip_proof_to_bytes(back) == blob
    assert (back.ed_stark.aux, back.ed_stark.n_rows) == (claimed.ed_stark.aux, claimed.ed_stark.n_rows)
    d = serialize.ed_claims_to_dict(claimed.ed_stark)
    assert d == jax_serialize.ed_claims_to_dict(j_proof.ed_stark)
    assert serialize.ed_claims_to_dict(serialize.ed_claims_from_dict(d)) == d


# malformed ed_stark entries: none of its keys, a point of one coordinate,
# not an object, a row count that is not a number
MALFORMED_ED = {
    "empty": lambda d: {},
    "aux_arity": lambda d: dict(d, aux=[[1, [2], [3]]]),
    "not_an_object": lambda d: "x",
    "n_rows": lambda d: dict(d, n_rows="z"),
}


@pytest.mark.parametrize("bad", MALFORMED_ED)
def test_malformed_ed_stark_refused(claimed, bad):
    d = json.loads(serialize.skip_proof_to_bytes(claimed))
    d["ed_stark"] = MALFORMED_ED[bad](d["ed_stark"])
    with pytest.raises(serialize.ProofDecodeError, match="malformed"):
        serialize.skip_proof_from_bytes(json.dumps(d).encode())


def _claim_cases(proof):
    """name -> (proof, claims passed to the verifier) for the walk test."""
    ed = proof.ed_stark
    (s, pt, out), *rest = ed.aux
    moved = (s, pt, ged.point_add(out, ged.BASE))
    items = list(proof.claims.sign_items)
    pk, msg, sig = items[0]
    other_msg = dataclasses.replace(proof.claims, sign_items=[(pk, msg + b"x", sig)] + items[1:])
    return {
        "honest": (proof, None),
        "result_point": (ed_tamper(proof, "result_point"), None),
        "scalar": (ed_tamper(proof, "scalar"), None),
        "strip_ed_stark": (ed_tamper(proof, "strip_ed_stark"), None),
        "no_validator_lists": (ed_tamper(proof, "no_validator_lists"), None),
        "result_point_rebound": (_bind(proof, dataclasses.replace(ed, aux=[moved] + rest)), None),
        "signature_message": (dataclasses.replace(proof, claims=other_msg), None),
        "no_claims": (dataclasses.replace(proof, claims=None), None),
        "supplied_items_only": (dataclasses.replace(proof, claims=None),
                                pipeline.SkipClaimData(sign_items=proof.claims.sign_items)),
    }


WALK_CASES = ["honest", "result_point", "scalar", "strip_ed_stark", "no_validator_lists",
              "result_point_rebound", "signature_message", "no_claims", "supplied_items_only"]


@pytest.mark.parametrize("case", WALK_CASES)
def test_pipeline_walk_and_fail_closed_match_jax(claimed, monkeypatch, case):
    monkeypatch.setattr(stark, "verify", lambda *a, **k: True)
    monkeypatch.setattr(jax_stark, "verify", lambda *a, **k: True)
    proof, claims = _claim_cases(claimed)[case]
    ok, detail = pipeline.verify_skip_proof_detailed(proof, CFG, claims)
    j_proof = jax_serialize.skip_proof_from_bytes(serialize.skip_proof_to_bytes(proof))
    j_claims = None if claims is None else jax_pipeline.SkipClaimData(sign_items=claims.sign_items)
    j_ok, j_detail = jax_pipeline.verify_skip_proof_detailed(j_proof, JAX_CFG, j_claims)
    assert (ok, detail) == (j_ok, j_detail)
    want = {
        "honest": ("ed_stark", "ok"),
        "result_point_rebound": ("ed_stark", "failed: batch equation rejected"),
        "signature_message": ("ed_stark", "failed: batch equation rejected"),
        "no_claims": ("ed_stark", "failed: claim data unavailable (fail closed)"),
        "supplied_items_only": ("binding", "skipped: claim data not supplied"),
    }.get(case) or ED_TAMPERS[case]
    assert detail[want[0]] == want[1], detail
    assert ok == (case in ("honest", "supplied_items_only"))
    if case == "honest":
        assert detail["binding"] == "ok"


def test_prove_batch_stark_fails_stop_on_a_malformed_batch(witness):
    """prove_batch_stark raises as the JAX package's does when the batch
    cannot be proven (here: every signature's s set to L)."""
    bad = [sig[:32] + ged.L.to_bytes(32, "little") for sig in witness.signatures]
    items = [(pk, witness.sign_bytes, sig) for pk, sig in zip(witness.target_set.pubkeys, bad)]
    with pytest.raises(ValueError, match="malformed"):
        ed_claims.prove_batch_stark(items, config=CFG, device="cpu")
    with pytest.raises(ValueError, match="malformed"):
        jax_ed_claims.prove_batch_stark(items, config=JAX_CFG)


@pytest.mark.slow
def test_ed_tier_end_to_end_tiny_chain(witness):
    proof = pipeline.prove_skip(witness, CFG, device="cpu", with_ed_stark=True)
    assert len(proof.ed_stark.aux) == 4 and proof.ed_stark.n_rows == 2048 and "ed_stark" in proof.timing
    blob = serialize.skip_proof_to_bytes(proof)
    digest = hashlib.sha256(blob).hexdigest()
    assert digest == TINY_ED_PROOF_SHA256, digest
    ok, detail = pipeline.verify_skip_proof_detailed(proof, CFG)
    assert ok and detail["ed_stark"] == "ok" and detail["binding"] == "ok", detail

    j_proof = jax_serialize.skip_proof_from_bytes(blob)
    assert jax_serialize.skip_proof_to_bytes(j_proof) == blob
    ok, detail = jax_pipeline.verify_skip_proof_detailed(j_proof, JAX_CFG)
    assert ok and detail["ed_stark"] == "ok" and detail["binding"] == "ok", detail
    for how, (field, verdict) in ED_TAMPERS.items():
        for verify, p, cfg in ((pipeline.verify_skip_proof_detailed, proof, CFG),
                               (jax_pipeline.verify_skip_proof_detailed, j_proof, JAX_CFG)):
            ok, detail = verify(ed_tamper(p, how), cfg)
            assert not ok and detail[field] == verdict, (how, detail)

    items = pipeline.signature_items(witness)
    pk, msg, sig = items[0]
    for verify, ed, cfg in ((ed_claims.verify_batch_stark, proof.ed_stark, CFG),
                            (jax_ed_claims.verify_batch_stark, j_proof.ed_stark, JAX_CFG)):
        assert verify(ed, items, config=cfg)
        assert not verify(ed, [(pk, b"other", sig)], config=cfg)
        for how in ("result_point", "scalar"):
            assert not verify(ed_tamper(dataclasses.replace(proof, ed_stark=ed), how).ed_stark, items, config=cfg)
