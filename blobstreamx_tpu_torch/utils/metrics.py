"""Structured JSONL metrics: one record a line, written by rank 0, with the
JAX package's keys (event, run_id, t, then the fields)."""

from __future__ import annotations

import json
import os
import time


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class MetricsWriter:
    """Append-only JSONL; every record carries the run id and a wall-clock
    timestamp. The rank is torch.distributed's when a process group is
    initialized, else 0; processes other than rank 0 write nothing."""

    def __init__(self, path: str | None, run_id: str = "", rank: int | None = None):
        self.rank = _rank() if rank is None else rank
        self.run_id = run_id or f"run-{int(time.time())}-{os.getpid()}"
        self.path = path if self.rank == 0 and path else None

    def emit(self, event: str, **fields) -> dict:
        rec = {"event": event, "run_id": self.run_id, "t": time.time(), **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def emit_timing(self, tree, **fields) -> dict:
        return self.emit("timing", phases=tree.flat(), **fields)
