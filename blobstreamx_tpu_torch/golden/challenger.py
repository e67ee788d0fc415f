"""Golden Fiat–Shamir challenger: a duplex Poseidon sponge over Goldilocks.

Deterministic convention shared by prover and verifier (device implementation
in blobstreamx_tpu_torch.prover.challenger must match bit-exactly). Mirrors the role
of plonky2's Challenger (SURVEY.md §3.4 step 3) without copying its API.

Duplex rules:
- observe(x): append to input buffer; an observe never permutes by itself.
- sample(): if any observed input is pending (or no squeezed output remains),
  overwrite state[0:k] with the k<=RATE pending inputs, permute, refill the
  output buffer from state[0:RATE]; then pop one output element.
- Inputs longer than RATE are absorbed RATE elements at a time.
"""

from __future__ import annotations

from .goldilocks import P
from .poseidon import RATE, WIDTH, permute


class Challenger:
    def __init__(self) -> None:
        self.state = [0] * WIDTH
        self.input_buffer: list[int] = []
        self.output_buffer: list[int] = []

    def observe(self, x: int) -> None:
        self.output_buffer = []  # any new observation invalidates pending outputs
        self.input_buffer.append(x % P)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_many(self, xs) -> None:
        for x in xs:
            self.observe(x)

    def observe_digest(self, digest) -> None:
        self.observe_many(digest)

    def observe_bytes32(self, data: bytes) -> None:
        """Absorb a 32-byte hash as four 64-bit little-endian limbs reduced mod p."""
        assert len(data) == 32
        for i in range(4):
            self.observe(int.from_bytes(data[i * 8 : i * 8 + 8], "little") % P)

    def _duplex(self) -> None:
        for i, x in enumerate(self.input_buffer):
            self.state[i] = x
        self.input_buffer = []
        self.state = permute(self.state)
        self.output_buffer = list(self.state[:RATE])

    def sample(self) -> int:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def sample_ext(self) -> tuple[int, int]:
        return (self.sample(), self.sample())

    def sample_indices(self, n: int, bound: int) -> list[int]:
        """n query indices in [0, bound); bound must be a power of two."""
        assert bound & (bound - 1) == 0
        return [self.sample() & (bound - 1) for _ in range(n)]
