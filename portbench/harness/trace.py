"""The traced stretch of a ``--trace 1`` run: torch.profiler over whole
requests after the measured window, reduced to what the per-layer readers
take.

``Tracer.start()`` / ``Tracer.stop()`` bracket the stretch (the card is
synchronised at both ends, so no kernel of another stretch falls inside).
``summarize(events, window_s)`` reduces the profiler's raw events, given as
plain tuples, so that a canned trace tests it on the CPU:

    (name, kind, on_device, thread, start_ns, end_ns)

kind is the profiler's activity type ("kernel", "gpu_memcpy", "gpu_memset",
"cpu_op", "user_annotation", ...). It gives

- ``busy_s``: the union of the device operations' intervals;
- ``window_s``: the stretch's length on the host clock;
- ``kernels``: kernel launches recorded; ``kernel_s``: their summed time;
- ``device_ops``: the 10 device operations that took most time, by name;
- ``idle_gaps``: the device's idle time by what the host was doing, the 10
  largest: the harness's annotation around it and the innermost host
  operator open at the gap's middle ("python" when none was).
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

ANNOTATION_PREFIX = "portbench."
DEVICE_KINDS_KERNEL = "kernel"
_WALK = 512  # siblings passed over when looking for the operator open at a gap


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def _kind(e, name: str, on_device: bool) -> str:
    """The event's activity type; where the profiler's events do not carry
    it (torch before 2.13), worked out from the name and the flags they do."""
    if hasattr(e, "activity_type"):
        return str(e.activity_type())
    if on_device:
        low = name.lower()
        return "gpu_memcpy" if low.startswith("memcpy") else "gpu_memset" if low.startswith("memset") else "kernel"
    if name.startswith(ANNOTATION_PREFIX) or (hasattr(e, "is_user_annotation") and e.is_user_annotation()):
        return "user_annotation"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def raw_events(prof) -> list[tuple]:
    """The profiler's events as (name, kind, on_device, thread, start, end)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_device = "CUDA" in str(e.device_type())
        start = _ns(e, "start")
        if hasattr(e, "end_ns"):
            end = int(e.end_ns())
        elif hasattr(e, "duration_ns"):
            end = start + int(e.duration_ns())
        else:
            end = start + int(e.duration_us() * 1000)
        thread = int(e.start_thread_id()) if hasattr(e, "start_thread_id") else 0
        out.append((name, _kind(e, name, on_device), on_device, thread, start, end))
    return out


def _merge(intervals: list[tuple[int, int]]) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_label(ops, starts, mid: int) -> str:
    """The innermost host operator open at `mid` (latest start among those
    that contain it), or "python"."""
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - _WALK, -1), -1):
        if ops[j][2] >= mid:
            return ops[j][0]
    return "python"


def summarize(events: list[tuple], window_s: float, top: int = 10) -> dict:
    # a host annotation's span is mirrored on the device's timeline, from its
    # first kernel to its last: that is no device operation of its own
    host_names = {n for n, _, d, *_ in events if not d}
    device = [(n, k, s, e) for n, k, d, _, s, e in events
              if d and e > s and "annotation" not in k and n not in host_names
              and not n.startswith(ANNOTATION_PREFIX)]
    kernels = [x for x in device if DEVICE_KINDS_KERNEL in x[1]]
    by_name: dict[str, float] = defaultdict(float)
    for n, _, s, e in device:
        by_name[n] += (e - s) / 1e9
    merged = _merge([(s, e) for _, _, s, e in device])
    busy_s = sum(e - s for s, e in merged) / 1e9

    annotations = [(n, s, e) for n, k, d, _, s, e in events
                   if not d and "annotation" in k and n.startswith(ANNOTATION_PREFIX)]
    main_threads = {t for n, k, d, t, s, e in events
                    if not d and "annotation" in k and n.startswith(ANNOTATION_PREFIX)}
    ops = sorted(((n, s, e) for n, k, d, t, s, e in events
                  if not d and "cpu_op" in k and (not main_threads or t in main_threads)), key=lambda o: o[1])
    op_starts = [o[1] for o in ops]
    annotations.sort(key=lambda a: a[1])
    ann_starts = [a[1] for a in annotations]

    gaps: dict[str, float] = defaultdict(float)
    if merged:
        edges = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
        host = [x for x in events if not x[2]]
        if host:
            first = min(x[4] for x in host)
            last = max(x[5] for x in host)
            edges = [(first, merged[0][0])] + edges + [(merged[-1][1], last)]
        for g0, g1 in edges:
            if g1 <= g0:
                continue
            mid = (g0 + g1) // 2
            ann = _host_label(annotations, ann_starts, mid)
            ann = ann if ann != "python" else "outside"
            gaps[f"{ann}/{_host_label(ops, op_starts, mid)}"] += (g1 - g0) / 1e9

    return {
        "window_s": window_s,
        "busy_s": busy_s,
        "kernels": len(kernels),
        "kernel_s": sum(e - s for _, _, s, e in kernels) / 1e9,
        "device_ops": sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:top],
        "idle_gaps": sorted(([n, t] for n, t in gaps.items()), key=lambda x: -x[1])[:top],
    }


class Tracer:
    """torch.profiler (host and device activity) over a stretch of
    requests. Disabled, start() and stop() do nothing and summary() is None."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.requests = 0
        self._summary = None
        self._t1 = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self._t0 = time.perf_counter()
        self._t1 = None

    def stop(self) -> None:
        if self.prof is None or self._t1 is not None:
            return
        self._sync()
        self._t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.window_s = self._t1 - self._t0

    def summary(self) -> dict | None:
        if self._summary is None and self.prof is not None:
            self._summary = summarize(raw_events(self.prof), self.window_s)
            self._summary["requests"] = self.requests
            self.prof = None
        return self._summary
