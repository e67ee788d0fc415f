"""Prover configuration: frozen dataclasses mirroring the roles of upstream
CircuitConfig/FriConfig, with the JAX package's fields and defaults."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from blobstreamx_tpu_torch.golden.fri import FriConfig


@dataclass(frozen=True)
class StarkConfig:
    """Static shape/soundness parameters of one STARK prove.

    rate_bits must satisfy 2^rate_bits >= max constraint degree so the
    quotient polynomial fits the extended evaluation domain.
    """

    rate_bits: int = 3
    cap_height: int = 1
    num_query_rounds: int = 28
    proof_of_work_bits: int = 8
    final_poly_len: int = 8

    def fri(self) -> FriConfig:
        return FriConfig(
            rate_bits=self.rate_bits,
            cap_height=self.cap_height,
            num_query_rounds=self.num_query_rounds,
            proof_of_work_bits=self.proof_of_work_bits,
            final_poly_len=self.final_poly_len,
        )

    def blowup(self) -> int:
        return 1 << self.rate_bits

    @classmethod
    def from_reference(cls, fields: dict) -> "StarkConfig":
        """The config with the JAX package's StarkConfig fields, e.g.
        ``dataclasses.asdict(jax_config)``."""
        return cls(**{f.name: int(fields[f.name]) for f in dataclasses.fields(cls)})
