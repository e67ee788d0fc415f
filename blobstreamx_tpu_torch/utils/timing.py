"""Hierarchical phase timers (SURVEY.md §5.1: the TPU-native analog of
plonky2's util::timing::TimingTree — scoped timers printed per prove, plus
derived per-kernel rates that feed the metrics file).

Every scope given ``sync=device`` ends with torch.cuda.synchronize() on a
CUDA device, so a scope's wall-clock includes the device time it launched
(asynchronous launches would otherwise be charged to a later scope).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class TimingNode:
    name: str
    seconds: float = 0.0
    children: list["TimingNode"] = field(default_factory=list)
    items: int = 0  # optional unit count (hashes, butterflies, rows ...)
    unit: str = ""

    def lines(self, depth: int = 0) -> list[str]:
        rate = f" ({self.items / self.seconds:.3e} {self.unit}/s)" if self.items and self.seconds else ""
        out = [f"{'  ' * depth}{self.seconds * 1e3:9.1f} ms  {self.name}{rate}"]
        for c in self.children:
            out.extend(c.lines(depth + 1))
        return out


class TimingTree:
    def __init__(self, name: str = "prove"):
        self.root = TimingNode(name)
        self._stack = [self.root]
        self._t0 = time.perf_counter()

    @contextmanager
    def scope(self, name: str, items: int = 0, unit: str = "", sync=None):
        """sync: optional torch.device to synchronize at scope exit."""
        node = TimingNode(name, items=items, unit=unit)
        self._stack[-1].children.append(node)
        self._stack.append(node)
        t0 = time.perf_counter()
        try:
            yield node
        finally:
            if sync is not None and sync.type == "cuda":
                import torch

                torch.cuda.synchronize(sync)
            node.seconds = time.perf_counter() - t0
            self._stack.pop()

    def note(self, text: str) -> None:
        """Zero-duration annotation node (e.g. 'phase resumed from checkpoint')."""
        self._stack[-1].children.append(TimingNode(text))

    def finish(self) -> "TimingTree":
        self.root.seconds = time.perf_counter() - self._t0
        return self

    def render(self) -> str:
        return "\n".join(self.root.lines())

    def flat(self) -> dict[str, float]:
        """Seconds by node path ("prove_skip/stark/quotient"), the record
        utils.metrics writes."""
        out = {}

        def walk(node: TimingNode, prefix: str):
            key = f"{prefix}{node.name}"
            out[key] = node.seconds
            for c in node.children:
                walk(c, key + "/")

        walk(self.root, "")
        return out
