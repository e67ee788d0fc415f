"""torch.profiler integration: the trace half of the phase timer
(utils.timing.TimingTree is the other half).

Usage:
    with maybe_trace("trace_dir"):     # a no-op when the directory is None or empty
        proof = skip.prove(w)

The directory receives a Chrome trace (`*.pt.trace.json`, readable by
Perfetto or chrome://tracing) of host operators and, with a card, of the
device kernels. Host phases show up as ranges opened with annotate().
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext


@contextmanager
def _trace(log_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # a profiler that cannot start raises here: the run does not go on unprofiled
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def maybe_trace(log_dir: str | None):
    """Context manager: a torch.profiler trace written into log_dir when it
    is set, else a no-op."""
    return _trace(log_dir) if log_dir else nullcontext()


def annotate(name: str):
    """Named host-side region, visible on the profiler timeline."""
    from torch.profiler import record_function

    return record_function(name)


def device_memory_stats() -> dict:
    """Per-card memory: {"cuda:<i>": {bytes_in_use, peak_bytes_in_use,
    bytes_limit}} from the caching allocator's counters and the card's
    total memory; {} when no card is visible."""
    import torch

    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
