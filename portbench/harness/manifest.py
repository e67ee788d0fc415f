"""BENCHMARK.json and the files it names, found by name.

- a configuration ``c``: its entry's ``file`` (``portbench/configs/<c>.json``);
- a traffic mix ``t``: ``portbench/traffic/<t>.json``, which names the
  operation (``op``) that ``portbench/ops/<op>.py`` drives;
- a metric ``m``: its reader ``portbench/metrics/<m>.py``.

A later cell, configuration, traffic mix or metric is new files and new
entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def op_path(op: str) -> Path:
    return BENCH_DIR / "ops" / f"{op}.py"


def metric_path(name: str) -> Path:
    return BENCH_DIR / "metrics" / f"{name}.py"


def resolve(cell_name: str, manifest: dict | None = None) -> Cell:
    """The cell's entry with its configuration, traffic and metrics loaded.
    Raises KeyError for an unknown cell, FileNotFoundError for a missing file."""
    m = manifest if manifest is not None else load_manifest()
    cells = {w["name"]: w for w in m["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json (have: {sorted(cells)})")
    w = cells[cell_name]
    configs = {c["name"]: c for c in m["configs"]}
    cfg_entry = configs[w["config"]]
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads(traffic_path(w["traffic"]).read_text())
    return Cell(
        name=cell_name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[x for x in m["end_to_end"] if _applies(x, cell_name)],
        per_layer=[x for x in m["per_layer"] if _applies(x, cell_name)],
    )


def load_module(path: Path, name: str):
    """Import a file under portbench/ by its path (metric names hold dots)."""
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_op(op: str):
    return load_module(op_path(op), f"portbench_op_{op}")


def load_reader(metric: str):
    return load_module(metric_path(metric), "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))
