"""The port's SHA-256 trust tier, prove_skip(with_sha_stark=True), against
the JAX package on the CPU: the port's verifier reports "ok: tuple tree",
the JAX verifier accepts the port's blob, both packages serialize the proof
to equal bytes, and both verifiers reject the three tampers that
chip_smoke.py's phase 8 applies on the card. The chain is the smallest one:
one leaf (trusted 9 -> target 10 of test_pipeline's fixture), a 128-row
SHA STARK; the main and the SHA STARK share the config below.

The slow test compares proof bytes with the JAX package's own prove_skip on
a two-leaf chain, the JAX side in one 1-device subprocess."""

import dataclasses
import json

import pytest
import torch

from blobstreamx_tpu.prover import pipeline as jax_pipeline, serialize as jax_serialize
from blobstreamx_tpu.prover.config import StarkConfig as JaxStarkConfig
from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
from blobstreamx_tpu_torch.prover import pipeline, serialize
from blobstreamx_tpu_torch.prover.config import StarkConfig
from chip_smoke import sha_tamper

torch.set_num_threads(1)
CFG_FIELDS = dict(rate_bits=2, cap_height=1, num_query_rounds=4, proof_of_work_bits=4, final_poly_len=4)
CFG = StarkConfig(**CFG_FIELDS)
JAX_CFG = JaxStarkConfig(**CFG_FIELDS)
TAMPERS = ["digest_word", "strip_sha_stark", "range_data_hash"]  # chip_smoke.py phase 8's


def _witness(trusted: int, target: int):
    chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4,
                              sign_fraction=0.75, sign_heights={10})
    return wit.build_skip_witness(chain, trusted_height=trusted, target_height=target)


@pytest.fixture(scope="module")
def run():
    w = _witness(9, 10)
    proof = pipeline.prove_skip(w, CFG, device="cpu", with_sha_stark=True)
    return dict(witness=w, proof=proof, blob=serialize.skip_proof_to_bytes(proof))


def test_port_verifier_accepts_tuple_tree(run):
    proof = run["proof"]
    assert proof.sha_stark.n_rows == 128 and proof.claims is not None
    assert "sha_stark" in proof.timing
    ok, detail = pipeline.verify_skip_proof_detailed(proof, CFG)
    assert ok, detail
    assert detail["sha_stark"] == "ok: tuple tree" and detail["claims"] == "embedded"
    assert detail["binding"] == "ok"


def test_serialized_bytes_equal_and_jax_verifier_accepts(run):
    j_proof = jax_serialize.skip_proof_from_bytes(run["blob"])
    assert jax_serialize.skip_proof_to_bytes(j_proof) == run["blob"]
    assert serialize.skip_proof_to_bytes(serialize.skip_proof_from_bytes(run["blob"])) == run["blob"]
    ok, detail = jax_pipeline.verify_skip_proof_detailed(j_proof, JAX_CFG)
    assert ok, detail
    assert detail["sha_stark"] == "ok: tuple tree"


@pytest.mark.parametrize("how", TAMPERS)
@pytest.mark.parametrize("package", ["port", "jax"])
def test_verifiers_reject_tampers(run, package, how):
    if package == "port":
        proof, verify, cfg = run["proof"], pipeline.verify_skip_proof_detailed, CFG
    else:
        proof = jax_serialize.skip_proof_from_bytes(run["blob"])
        verify, cfg = jax_pipeline.verify_skip_proof_detailed, JAX_CFG
    ok, detail = verify(sha_tamper(proof, how), cfg)
    assert not ok
    want = "tuple-tree claim walk rejected" if how == "range_data_hash" else "claim digest not bound"
    assert want in detail["sha_stark"], detail


def test_fail_closed_without_claims(run):
    ok, detail = pipeline.verify_skip_proof_detailed(dataclasses.replace(run["proof"], claims=None), CFG)
    assert not ok and detail["sha_stark"] == "failed: claim data unavailable (fail closed)"


def test_unported_tiers_refused(run):
    """Malformed blobs of the other tiers are refused at decode: a
    full-coverage blob without its shard STARKs, and an Ed25519 STARK entry
    with none of its fields."""
    d = json.loads(run["blob"])
    d["sha_stark"]["link_fields"] = []
    with pytest.raises(serialize.ProofDecodeError, match="lacks starks"):
        serialize.skip_proof_from_bytes(json.dumps(d).encode())
    d = json.loads(run["blob"])
    d["ed_stark"] = {}
    with pytest.raises(serialize.ProofDecodeError, match="malformed"):
        serialize.skip_proof_from_bytes(json.dumps(d).encode())


JAX_SIDE = """
from blobstreamx_tpu.circuits import fixtures as fx, witness as wit
from blobstreamx_tpu.prover import pipeline
from blobstreamx_tpu.prover.config import StarkConfig
from blobstreamx_tpu.prover.serialize import skip_proof_to_bytes

chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4,
                          sign_fraction=0.75, sign_heights={{10}})
w = wit.build_skip_witness(chain, trusted_height=8, target_height=10)
proof = pipeline.prove_skip(w, StarkConfig(**{cfg!r}), with_sha_stark=True)
open({out!r}, "wb").write(skip_proof_to_bytes(proof))
"""


@pytest.mark.slow
def test_proof_bytes_equal_jax_two_leaves(tmp_path):
    from subproc import run_py

    out = tmp_path / "jax.bin"
    run_py(JAX_SIDE.format(cfg=CFG_FIELDS, out=str(out)))
    proof = pipeline.prove_skip(_witness(8, 10), CFG, device="cpu", with_sha_stark=True)
    assert proof.sha_stark.n_rows == 512
    assert serialize.skip_proof_to_bytes(proof) == out.read_bytes()
    ok, detail = pipeline.verify_skip_proof_detailed(serialize.skip_proof_from_bytes(out.read_bytes()), CFG)
    assert ok and detail["sha_stark"] == "ok: tuple tree", detail
