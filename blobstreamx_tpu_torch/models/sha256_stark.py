"""User-facing facade for the batched SHA-256 STARK workloads:

    from blobstreamx_tpu_torch.models import sha256_stark
    proof, root = sha256_stark.prove_data_commitment(heights, data_hashes)
    assert sha256_stark.verify_data_commitment(proof, heights, data_hashes, root)
"""

from __future__ import annotations

from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.prover.sha_air import (
    Sha256Air,
    build_sha_trace,
    digests_from_aux,
    plan_blocks,
)
from blobstreamx_tpu_torch.prover.sha_claims import (
    ShaStarkProof,
    prove_data_commitment_stark as prove_data_commitment,
    verify_data_commitment_stark as verify_data_commitment,
)

__all__ = [
    "Sha256Air",
    "plan_blocks",
    "build_sha_trace",
    "digests_from_aux",
    "ShaStarkProof",
    "prove_data_commitment",
    "verify_data_commitment",
    "StarkConfig",
]
