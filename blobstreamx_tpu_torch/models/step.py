"""User-facing facade for the step workload: prove one header transition
h -> h+1 under the >2/3 rule.

    from blobstreamx_tpu_torch.models import step
    chain = step.generate_chain(seed=7, n_headers=6, n_validators=4)
    w = step.build_witness(chain, prev_height=4)
    proof = step.prove(w)                 # on the card; device="cpu" for the plain path
    assert step.verify(proof)
"""

from __future__ import annotations

from blobstreamx_tpu_torch.circuits.fixtures import generate_chain
from blobstreamx_tpu_torch.circuits.step import build_step_witness as build_witness
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.prover.pipeline import (
    StepProof,
    prove_step as prove,
    verify_step_proof as verify,
)
from blobstreamx_tpu_torch.prover.serialize import (
    step_proof_from_bytes as from_bytes,
    step_proof_to_bytes as to_bytes,
)

__all__ = [
    "generate_chain",
    "build_witness",
    "prove",
    "verify",
    "to_bytes",
    "from_bytes",
    "StepProof",
    "StarkConfig",
]
