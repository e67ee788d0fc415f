"""BENCHMARK.json against the benchmark's contract, every file it names,
and a cell, configuration, traffic mix and metric added as files and
entries alone."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench() -> dict:
    raw = (ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    return json.loads(raw)


def test_top_level_and_paths(bench):
    assert set(bench) == KEYS["top"]
    assert bench["paths"] == ["portbench"]
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("part", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_keys_and_names(bench, part):
    entries = bench[part]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        extra = set(e) - KEYS[part]
        assert extra <= ({"workloads"} if part in ("end_to_end", "per_layer") else set()), extra
        assert KEYS[part] <= set(e)
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        if part in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in (("host_clock", "device_trace") if part == "end_to_end" else
                                   ("device_trace", "program_span", "program_counter", "host_clock"))


def test_metric_and_cell_rules(bench):
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(1, len(cells) // 4)
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    used = {w["config"] for w in cells.values()}
    assert used == configs
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for c in m.get("workloads", cells):
            mv = e2e[m["moves"]]
            assert c in cells and c in mv.get("workloads", cells), (m["name"], c)
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for c in cells:
        reported = [m for m in e2e.values() if c in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"])


def test_every_named_file_resolves(bench):
    for c in bench["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("portbench/")
        cfg = json.loads(path.read_text())
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg
    for w in bench["workloads"]:
        cell = manifest.resolve(w["name"], bench)
        assert manifest.op_path(cell.traffic["op"]).is_file()
        op = manifest.load_op(cell.traffic["op"])
        assert {"control", "stale", "half", "altered"} <= set(op.FAULTS)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.load_reader(m["name"]).read)


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a metric reader as new files and new entries; the copied harness
    resolves the cell and reads the metric without any file edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "portbench/configs/celestia-256.json").write_text(json.dumps(
        {**json.loads((ROOT / "portbench/configs/celestia-mainnet.json").read_text()), "n_validators": 256}))
    (tmp_path / "portbench/traffic/skip256.json").write_text(json.dumps(
        {**json.loads((ROOT / "portbench/traffic/skip1000.json").read_text()), "range": 256}))
    (tmp_path / "portbench/metrics/throwaway_share.py").write_text(
        "def read(run):\n    return 100.0 * run['window_s'] / 2\n")
    bench["configs"].append({"name": "celestia-256", "source": "a throwaway configuration",
                             "file": "portbench/configs/celestia-256.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "celestia256.skip256", "config": "celestia-256", "traffic": "skip256",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "throwaway_share", "unit": "%", "better": "lower", "source": "host_clock",
                               "layer": "Pipeline", "moves": "proof_s", "workloads": ["celestia256.skip256"]})
    bench["end_to_end"][0]["workloads"].append("celestia256.skip256")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench.harness import manifest\n"
        "c = manifest.resolve('celestia256.skip256')\n"
        "assert c.config['n_validators'] == 256 and c.traffic['range'] == 256 and c.traffic['op'] == 'skip'\n"
        "assert [m['name'] for m in c.per_layer] == ['throwaway_share']\n"
        "assert [m['name'] for m in c.end_to_end] == ['proof_s', 'setup_s']\n"
        "assert manifest.load_reader('throwaway_share').read({'window_s': 1.0}) == 50.0\n"
        "assert manifest.load_op('skip').Op is not None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
