"""The table of peaks (peaks.json) and the roofline bound.

bound_s(bytes, ops, row) is the least time a call could take: the larger of
its bytes over the card's memory bandwidth and its integer operations over
its operation rate, with the name of the one that bounds it.
"""

from __future__ import annotations

import json
from pathlib import Path

TABLE = Path(__file__).resolve().parent / "peaks.json"


def of(kind: str) -> dict | None:
    return json.loads(TABLE.read_text()).get(kind)


def bound_s(bytes_moved: float, ops: float, row: dict) -> tuple[float, str]:
    t_bytes = bytes_moved / row["hbm_bytes_per_s"]
    t_ops = ops / row["int_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
