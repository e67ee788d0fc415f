"""User-facing facade for the skip workload: prove that a trusted
Tendermint header h1 hands off to a target header h2, with a data commitment
over (h1, h2]:

    from blobstreamx_tpu_torch.models import skip
    chain = skip.generate_chain(seed=7, n_headers=10, n_validators=5)
    w = skip.build_witness(chain, trusted_height=2, target_height=10)
    proof = skip.prove(w)                 # on the card; device="cpu" for the
    assert skip.verify(proof)             # plain PyTorch path
    blob = skip.to_bytes(proof)
"""

from __future__ import annotations

from blobstreamx_tpu_torch.circuits.fixtures import generate_chain
from blobstreamx_tpu_torch.circuits.witness import build_skip_witness as build_witness
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.prover.pipeline import (
    SkipProof,
    prove_skip as prove,
    verify_skip_proof as verify,
)
from blobstreamx_tpu_torch.prover.serialize import (
    skip_proof_from_bytes as from_bytes,
    skip_proof_to_bytes as to_bytes,
)

__all__ = [
    "generate_chain",
    "build_witness",
    "prove",
    "verify",
    "to_bytes",
    "from_bytes",
    "SkipProof",
    "StarkConfig",
]
