"""Failure detection and phase-checkpoint resume: fail-stop per prove
attempt, a host heartbeat, and a retry loop that runs a failed prove again
from its last completed phase checkpoint.

  Heartbeat          background thread appending {"event": "heartbeat"}
                     JSONL records every `interval` seconds while a prove
                     runs; an external watchdog (or read_last_heartbeat)
                     declares the process stalled when the file goes quiet.
  read_last_heartbeat / is_stalled
                     the watchdog half: pure file inspection, usable from
                     another process or host.
  run_with_retry     the fail-stop retry loop: runs a prove callable up to
                     `attempts` times; each attempt passes the same
                     checkpoint_dir, so prover.pipeline.prove_skip (which
                     saves after every phase) skips the completed phases.

The records have the JAX package's keys (event, run_id, pid, t, n).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable


class Heartbeat:
    """Append-only heartbeat JSONL. Start/stop around a prove attempt:

        hb = Heartbeat(path, run_id="skip-7", interval=5.0).start()
        try: ...
        finally: hb.stop()
    """

    def __init__(self, path: str | None, run_id: str = "", interval: float = 5.0):
        self.path = path
        self.run_id = run_id
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.beats = 0

    def _emit(self, event: str) -> None:
        if not self.path:
            return
        rec = {
            "event": event,
            "run_id": self.run_id,
            "pid": os.getpid(),
            "t": time.time(),
            "n": self.beats,
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.beats += 1
            self._emit("heartbeat")

    def start(self) -> "Heartbeat":
        self._emit("start")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1)
        self._emit("stop")


def read_last_heartbeat(path: str) -> dict | None:
    """Last heartbeat/start/stop record in the file, or None."""
    if not os.path.exists(path):
        return None
    last = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("event") in ("heartbeat", "start", "stop"):
                last = rec
    return last


def is_stalled(path: str, timeout: float, now: float | None = None) -> bool:
    """Watchdog predicate: True when the newest heartbeat is older than
    `timeout` seconds (or the file is missing) and no clean stop was
    recorded."""
    rec = read_last_heartbeat(path)
    if rec is None:
        return True
    if rec.get("event") == "stop":
        return False
    return ((now if now is not None else time.time()) - rec["t"]) > timeout


def run_with_retry(
    fn: Callable[[], object],
    attempts: int = 2,
    heartbeat_path: str | None = None,
    run_id: str = "",
    interval: float = 5.0,
    on_failure: Callable[[int, BaseException], None] | None = None,
):
    """Fail-stop retry loop. fn is the whole prove attempt (it should pass
    a stable checkpoint_dir into prove_skip so completed phases persist
    across attempts). Raises the last exception if every attempt fails."""
    last: BaseException | None = None
    for attempt in range(attempts):
        hb = Heartbeat(heartbeat_path, run_id=f"{run_id}#{attempt}", interval=interval)
        hb.start()
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 (the fail-stop boundary: the next attempt resumes)
            last = e
            if on_failure is not None:
                on_failure(attempt, e)
        finally:
            hb.stop()
    assert last is not None
    raise last
