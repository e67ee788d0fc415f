"""The port's default-tier prove_skip and its prove_step on the CPU vs the
JAX package, on the chain and config of tests/test_pipeline.py (the skip
2 -> 10 and the step 9 -> 10): identical proof bytes, and each package's
verifier accepts the other's proof and rejects tampered publics.

All JAX work (prove_skip, prove_step, the cross-verification, verify_step on
the step witness and on one with a flipped signature byte, and a signature
batch with a flipped byte) runs in ONE 1-device subprocess
(tests/subproc.py), which shares test_pipeline's compiled programs; the port
runs in-process."""

import dataclasses
import json
import pickle

import pytest
import torch

from blobstreamx_tpu_torch.circuits import fixtures as fx, step, witness as wit
from blobstreamx_tpu_torch.circuits.skip import verify_skip
from blobstreamx_tpu_torch.ops import ed25519 as ted
from blobstreamx_tpu_torch.prover import pipeline
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.prover.serialize import (
    skip_proof_from_bytes,
    skip_proof_to_bytes,
    step_proof_from_bytes,
    step_proof_to_bytes,
)

torch.set_num_threads(1)
CFG = StarkConfig(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=4, final_poly_len=4)

STEP_FROM = 9  # the step 9 -> 10 of tests/test_pipeline.py

JAX_SIDE = """
import dataclasses, json, pickle
from blobstreamx_tpu.circuits import fixtures as fx, step as jstep, witness as wit
from blobstreamx_tpu.ops import ed25519 as jed
from blobstreamx_tpu.prover import pipeline
from blobstreamx_tpu.prover.config import StarkConfig
from blobstreamx_tpu.prover.serialize import (skip_proof_from_bytes, skip_proof_to_bytes,
                                             step_proof_from_bytes, step_proof_to_bytes)

OUT = {out!r}
CFG = StarkConfig(rate_bits=2, cap_height=1, num_query_rounds=12,
                  proof_of_work_bits=4, final_poly_len=4)
chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4,
                          rotate_every=4, sign_fraction=0.75, sign_heights={{10}})
w = wit.build_skip_witness(chain, trusted_height=2, target_height=10)
proof = pipeline.prove_skip(w, CFG)
open(OUT + "/jax.bin", "wb").write(skip_proof_to_bytes(proof))

port = skip_proof_from_bytes(open(OUT + "/port.bin", "rb").read())
pub = list(port.publics); pub[0] = pub[1]
items = pipeline.signature_items(w)
pk, msg, sig = items[0]
flipped = [(pk, msg, sig[:7] + bytes([sig[7] ^ 1]) + sig[8:])] + items[1:]
res = {{
    "jax_accepts_port": pipeline.verify_skip_proof(port, CFG),
    "jax_accepts_tampered_port": pipeline.verify_skip_proof(dataclasses.replace(port, publics=pub), CFG),
    "jax_batch_valid": jed.batch_verify(items, streams=4)[0],
    "jax_batch_flipped": jed.batch_verify(flipped, streams=4)[0],
}}

ws = jstep.build_step_witness(chain, prev_height={step_from})
pickle.dump(dataclasses.asdict(ws), open(OUT + "/jax_step_witness.pkl", "wb"))
open(OUT + "/jax_step.bin", "wb").write(step_proof_to_bytes(pipeline.prove_step(ws, CFG)))
port_step = step_proof_from_bytes(open(OUT + "/port_step.bin", "rb").read())
pub = list(port_step.publics); pub[0] = pub[1] * 2 // 3
checks = {{"valid": jstep.verify_step(ws), "flipped_signature": jstep.verify_step(
    dataclasses.replace(ws, signatures=[ws.signatures[0][:7] + bytes([ws.signatures[0][7] ^ 1])
                                        + ws.signatures[0][8:]] + ws.signatures[1:]))}}
res.update(
    jax_accepts_port_step=pipeline.verify_step_proof(port_step, CFG),
    jax_accepts_tampered_port_step=pipeline.verify_step_proof(dataclasses.replace(port_step, publics=pub), CFG),
    jax_verify_step={{k: [bool(r.ok), list(r.reasons)] for k, r in checks.items()}},
)
json.dump(res, open(OUT + "/jax.json", "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from subproc import run_py

    out = tmp_path_factory.mktemp("pipeline")
    chain = fx.generate_chain(
        seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75, sign_heights={10}
    )
    w = wit.build_skip_witness(chain, trusted_height=2, target_height=10)
    proof = pipeline.prove_skip(w, CFG, device="cpu")
    (out / "port.bin").write_bytes(skip_proof_to_bytes(proof))
    ws = step.build_step_witness(chain, prev_height=STEP_FROM)
    step_proof = pipeline.prove_step(ws, CFG, device="cpu")
    (out / "port_step.bin").write_bytes(step_proof_to_bytes(step_proof))
    run_py(JAX_SIDE.format(out=str(out), step_from=STEP_FROM))
    # the pickle was written by this test's own subprocess above
    carried = wit.step_witness_from_reference(pickle.loads((out / "jax_step_witness.pkl").read_bytes()))
    return dict(
        witness=w,
        port=proof,
        port_bytes=(out / "port.bin").read_bytes(),
        jax_bytes=(out / "jax.bin").read_bytes(),
        jax=json.loads((out / "jax.json").read_text()),
        step_witness=ws,
        step_carried=carried,
        port_step=step_proof,
        port_step_bytes=(out / "port_step.bin").read_bytes(),
        jax_step_bytes=(out / "jax_step.bin").read_bytes(),
    )


def test_port_proof_bytes_equal_jax(runs):
    got, want = json.loads(runs["port_bytes"]), json.loads(runs["jax_bytes"])
    # bisect a mismatch by phase: trace cap, quotient cap, FRI caps, then all
    assert got["stark"]["trace_cap"] == want["stark"]["trace_cap"]
    assert got["stark"]["quotient_cap"] == want["stark"]["quotient_cap"]
    assert got["stark"]["fri"]["caps"] == want["stark"]["fri"]["caps"]
    assert runs["port_bytes"] == runs["jax_bytes"]


def test_jax_verifier_accepts_port_proof(runs):
    assert runs["jax"]["jax_accepts_port"]
    assert not runs["jax"]["jax_accepts_tampered_port"]


def test_port_verifier_accepts_jax_proof(runs):
    jax_proof = skip_proof_from_bytes(runs["jax_bytes"])
    assert pipeline.verify_skip_proof(jax_proof, CFG)
    pub = list(jax_proof.publics)
    pub[0] = pub[1]  # claim every validator signed
    assert not pipeline.verify_skip_proof(dataclasses.replace(jax_proof, publics=pub), CFG)


@pytest.mark.parametrize("tamper", ["signed_power", "two_thirds", "data_commitment", "aux_digest"])
def test_port_verifier_rejects_tampering(runs, tamper):
    proof = runs["port"]
    assert pipeline.verify_skip_proof(proof, CFG)
    pub = list(proof.publics)
    out = proof.outputs
    if tamper == "signed_power":
        pub[0] = pub[1]
    elif tamper == "two_thirds":
        pub[0] = pub[1] * 2 // 3
    elif tamper == "data_commitment":
        out = dataclasses.replace(out, data_commitment=bytes(32))
    else:
        pub[30] = 1
    assert not pipeline.verify_skip_proof(dataclasses.replace(proof, publics=pub, outputs=out), CFG)


def test_config_from_reference():
    from blobstreamx_tpu.prover.config import StarkConfig as JaxStarkConfig

    jcfg = JaxStarkConfig(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=4, final_poly_len=4)
    assert StarkConfig.from_reference(dataclasses.asdict(jcfg)) == CFG
    assert StarkConfig.from_reference(dataclasses.asdict(JaxStarkConfig())) == StarkConfig()


def test_signer_binding_and_roundtrip(runs):
    proof = runs["port"]
    claims = pipeline.claim_data_from_witness(runs["witness"])
    ok, detail = pipeline.verify_skip_proof_detailed(proof, CFG, claims)
    assert ok and detail["binding"] == "ok", detail
    assert skip_proof_to_bytes(skip_proof_from_bytes(runs["port_bytes"])) == runs["port_bytes"]


def test_consensus_matches_jax(runs):
    """verify_skip's outputs and power sums equal the JAX package's (which
    its proof carries as outputs and publics[0:4]); the signature batch
    verdicts agree, valid and with a flipped signature byte."""
    w = runs["witness"]
    res = verify_skip(w, device="cpu")
    jax_proof = skip_proof_from_bytes(runs["jax_bytes"])
    assert res.outputs == jax_proof.outputs
    assert [res.signed_target_power, res.total_target_power, res.signed_trusted_power,
            res.total_trusted_power] == jax_proof.publics[:4]
    items = pipeline.signature_items(w)
    pk, msg, sig = items[0]
    flipped = [(pk, msg, sig[:7] + bytes([sig[7] ^ 1]) + sig[8:])] + items[1:]
    assert ted.batch_verify(items, device="cpu")[0] == runs["jax"]["jax_batch_valid"] is True
    assert ted.batch_verify(flipped, device="cpu")[0] == runs["jax"]["jax_batch_flipped"] is False


def test_port_step_proof_bytes_equal_jax(runs):
    """The step 9 -> 10: the port's bytes from the witness rebuilt from the
    seed and from the JAX package's witness carried across both equal the
    JAX package's prove_step bytes."""
    got, want = json.loads(runs["port_step_bytes"]), json.loads(runs["jax_step_bytes"])
    assert got["stark"]["trace_cap"] == want["stark"]["trace_cap"]
    assert got["stark"]["quotient_cap"] == want["stark"]["quotient_cap"]
    assert runs["port_step_bytes"] == runs["jax_step_bytes"]
    carried = pipeline.prove_step(runs["step_carried"], CFG, device="cpu")
    assert step_proof_to_bytes(carried) == runs["jax_step_bytes"]
    assert step_proof_to_bytes(step_proof_from_bytes(runs["jax_step_bytes"])) == runs["jax_step_bytes"]


def test_step_cross_verification(runs):
    assert runs["jax"]["jax_accepts_port_step"]
    assert not runs["jax"]["jax_accepts_tampered_port_step"]
    jax_step = step_proof_from_bytes(runs["jax_step_bytes"])
    assert jax_step.outputs.new_height == STEP_FROM + 1
    assert pipeline.verify_step_proof(jax_step, CFG)
    for tamper in ("signed_power", "two_thirds", "new_height"):
        pub, out = list(jax_step.publics), jax_step.outputs
        if tamper == "signed_power":
            pub[0] = pub[1]
        elif tamper == "two_thirds":
            pub[0] = pub[1] * 2 // 3
        else:
            pub[19] += 1
            out = dataclasses.replace(out, new_height=out.new_height + 1)
        for proof in (jax_step, runs["port_step"]):
            assert not pipeline.verify_step_proof(dataclasses.replace(proof, publics=pub, outputs=out), CFG), tamper


def test_verify_step_matches_jax(runs):
    """verify_step's verdict and reasons equal the JAX package's, on the
    step witness and on one with a flipped signature byte."""
    ws = runs["step_witness"]
    sig = ws.signatures[0]
    flipped = dataclasses.replace(ws, signatures=[sig[:7] + bytes([sig[7] ^ 1]) + sig[8:]] + ws.signatures[1:])
    got = {}
    for name, w in (("valid", ws), ("flipped_signature", flipped)):
        r = step.verify_step(w, device="cpu")
        got[name] = [r.ok, r.reasons]
    assert got == runs["jax"]["jax_verify_step"]
    assert got["valid"] == [True, []] and got["flipped_signature"][0] is False
