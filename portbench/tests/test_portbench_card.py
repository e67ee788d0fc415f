"""Runs of every cell on the card, as the benchmark's command runs them
(marked ``cuda``; skipped where no card is visible). On a machine with an
H100:

    python -m pytest -m cuda portbench/tests/test_portbench_card.py -q

Each run is a short window at the cell's own size; the result line has to
carry the contract's keys, the cell's metrics and ``correct`` true, and
under ``--fault control`` ``correct`` false, as under the proof cells'
faults that leave a consensus check out (``nosig``, ``nolinks``,
``novalset``), which only the forged requests catch.
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.harness import manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible")


def _run(cell: str, seed: int, trace: int = 0, fault: str | None = None) -> tuple[int, dict | None, str]:
    cmd = [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(seed), "--seconds", "3",
           "--trace", str(trace)] + (["--fault", fault] if fault else [])
    out = subprocess.run(cmd, cwd=manifest.ROOT, capture_output=True, text=True, timeout=600)
    lines = out.stdout.strip().splitlines()
    return out.returncode, json.loads(lines[-1]) if lines else None, out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell, trace):
    _card()
    rc, r, err = _run(cell, 2**31 + 77, trace)
    assert rc == 0 and r is not None, err[-3000:]
    assert r["correct"], r["checked"]
    assert list(r)[-1] == "checked" and r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    c = manifest.resolve(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(r["metrics"]) == want
    if trace:
        assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(cell):
    _card()
    rc, r, err = _run(cell, 2**31 + 78, fault="control")
    assert rc == 0 and r is not None, err[-3000:]
    assert not r["correct"], r["checked"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["nosig", "nolinks", "novalset"])
@pytest.mark.parametrize("cell", [c for c in CELLS if manifest.resolve(c).traffic.get("forged")])
def test_a_skipped_consensus_check_on_the_card_is_not_correct(cell, fault):
    _card()
    rc, r, err = _run(cell, 2**31 + 79, fault=fault)
    assert rc == 0 and r is not None, err[-3000:]
    assert not r["correct"] and r["checked"]["wrong_verdicts"]["value"] > 0, r["checked"]
