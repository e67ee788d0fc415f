"""Hierarchical phase timers (SURVEY.md §5.1: the TPU-native analog of
plonky2's util::timing::TimingTree — scoped timers printed per prove, plus
derived per-kernel rates that feed the metrics file).

Every scope given ``sync=device`` ends with torch.cuda.synchronize() on a
CUDA device, so a scope's wall-clock includes the device time it launched
(asynchronous launches would otherwise be charged to a later scope).

Every scope is also a torch.profiler range (utils.profiling.annotate) named
by its node's path, "prove_skip/consensus/links", and so is the root of a
tree used as a context manager: under a profiler the tree's nodes sit on the
trace's own timeline, nested as the tree nests. With no profiler running a
range costs a few microseconds. A node's name holds no "/" (the path's
separator) and no " (" (where a rendered line's rate begins).
"""

from __future__ import annotations

import time
from contextlib import contextmanager, nullcontext
from contextvars import ContextVar
from dataclasses import dataclass, field

from blobstreamx_tpu_torch.utils.profiling import annotate


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


_OPEN: ContextVar["TimingTree | None"] = ContextVar("timing_tree", default=None)


def _checked(name: str) -> str:
    if "/" in name or " (" in name:
        raise ValueError(f"a timing node's name holds no '/' and no ' (': {name!r}")
    return name


class TimingTree:
    def __init__(self, name: str = "prove"):
        self.root = TimingNode(_checked(name))
        self._stack = [self.root]
        self._t0 = time.perf_counter()
        self._range = self._token = None

    def __enter__(self) -> "TimingTree":
        """The root's profiler range, open until the block ends, which
        finishes the tree; meanwhile open_tree() returns it."""
        self._range = annotate(self.root.name)
        self._range.__enter__()
        self._token = _OPEN.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _OPEN.reset(self._token)
        self.finish()
        self._range.__exit__(*exc)

    @contextmanager
    def scope(self, name: str, items: int = 0, unit: str = "", sync=None):
        """sync: optional torch.device to synchronize at scope exit (inside
        the scope's profiler range)."""
        node = TimingNode(_checked(name), items=items, unit=unit)
        self._stack[-1].children.append(node)
        self._stack.append(node)
        with annotate("/".join(n.name for n in self._stack)):
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


def open_tree() -> TimingTree | None:
    """The innermost tree open as a context manager on this thread, if any:
    how code a prover calls without its tree (verify_skip, verify_step)
    adds its scopes to the prover's tree."""
    return _OPEN.get()


def maybe_scope(timing: TimingTree | None, name: str, items: int = 0, unit: str = "", sync=None):
    """timing.scope(...) when a tree is given, else a no-op context."""
    return nullcontext() if timing is None else timing.scope(name, items=items, unit=unit, sync=sync)
