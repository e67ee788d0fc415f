"""The Fiat-Shamir challenger: a duplex Poseidon sponge over Goldilocks.

observe() buffers an element (a full buffer of RATE elements is absorbed at
once); sample() absorbs what is pending, or permutes when the squeezed
outputs are used up, and pops the last output element.
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
        self.output_buffer = []
        self.input_buffer.append(x % P)
        if len(self.input_buffer) == RATE:
            self._duplex()

    def observe_many(self, xs) -> None:
        for x in xs:
            self.observe(x)

    def observe_ext(self, v) -> None:
        self.observe(v[0])
        self.observe(v[1])

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
        return [self.sample() & (bound - 1) for _ in range(n)]
