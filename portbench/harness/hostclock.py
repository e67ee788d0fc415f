"""What the host did during a stretch of a run, for reading the proof cells'
spread: the prover thread's CPU time (beside the stretch's wall it shows
whether the prover waited or ran slower), the whole process's CPU time
(the worker thread's witness builds among it), and the time Python's
garbage collector ran with its full collections. Nothing here is a metric;
the harness logs it beside each request on standard error.

Read from the prover's thread: ``start()`` and ``mark()`` set the origins,
``since_start()`` and ``since_mark()`` give the differences.
"""

from __future__ import annotations

import gc
import time

_GC = {"s": 0.0, "full": 0, "t0": None}


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _GC["t0"] = time.perf_counter()
    elif _GC["t0"] is not None:
        _GC["s"] += time.perf_counter() - _GC["t0"]
        _GC["full"] += info.get("generation") == 2
        _GC["t0"] = None


def _now() -> dict:
    return {"wall": time.perf_counter(), "thread_cpu": time.thread_time(), "proc_cpu": time.process_time(),
            "gc": _GC["s"], "gc_full": _GC["full"]}


def _diff(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


class HostClock:
    def __init__(self):
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)
        self._start = self._mark = _now()

    def start(self) -> None:
        self._start = self._mark = _now()

    def mark(self) -> None:
        self._mark = _now()

    def since_mark(self) -> dict:
        return _diff(self._mark, _now())

    def since_start(self) -> dict:
        return _diff(self._start, _now())


def describe(d: dict) -> str:
    return (f"thread cpu {d['thread_cpu']:.3f} s, process cpu {d['proc_cpu']:.3f} s, "
            f"gc {d['gc']:.3f} s / {d['gc_full']} full")
