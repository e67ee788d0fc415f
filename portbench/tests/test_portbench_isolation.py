"""What the harness and the reference import, by whole top-level name, and
how the run behaves where it must print no result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import isolation, manifest

BENCH = manifest.BENCH_DIR
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)
REFERENCE = sorted((BENCH / "reference").glob("*.py"))
STDLIB_AND_NUMPY = {"__future__", "dataclasses", "functools", "hashlib", "numpy"}


def test_whole_names():
    assert isolation.top_level("blobstreamx_tpu_torch.ops.ntt") == "blobstreamx_tpu_torch"
    assert isolation.forbidden_loaded(["blobstreamx_tpu_torch", "blobstreamx_tpu_torch.ops", "jaxtyping"]) == []
    assert isolation.forbidden_loaded(["blobstreamx_tpu.ops", "jax", "jaxlib.xla", "flax.linen"]) == [
        "blobstreamx_tpu.ops", "flax.linen", "jax", "jaxlib.xla"]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_the_harness_imports_no_jax(path):
    assert not isolation.imports_of(path) & isolation.JAX_SIDE


@pytest.mark.parametrize("path", REFERENCE, ids=lambda p: p.name)
def test_the_reference_imports_neither_jax_nor_the_port(path):
    names = isolation.imports_of(path)
    assert not names & (isolation.JAX_SIDE | {isolation.PROGRAM, "portbench", "torch"})
    assert names <= STDLIB_AND_NUMPY, names - STDLIB_AND_NUMPY


def test_the_reference_loads_nothing_of_the_port():
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench.reference import challenger, consensus, ed25519, goldilocks, ntt, poseidon, "
        "stark_verify, tendermint\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'blobstreamx_tpu', 'blobstreamx_tpu_torch', 'torch'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", script, str(manifest.ROOT)], capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stdout + out.stderr


def test_a_harness_run_loads_no_jax():
    """A whole run (the NTT cell, small, on the host) loads nothing of JAX."""
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench.harness import isolation, main\n"
        "r = main.run_cell('gl2e22.ntt', 3, 0.1, False, device='cpu', overrides={'config': {'log_n': 6},"
        " 'traffic': {'sync_every': 2, 'check_sample': 2}})\n"
        "assert r['correct']\n"
        "print(isolation.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", script, str(manifest.ROOT)], capture_output=True, text=True)
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "[]", out.stderr


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "gl2e22.ntt", "--seed", str(2**31 + 7),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
    )


def test_no_result_without_a_card_or_without_the_port(tmp_path):
    """Where the card is missing, and in a directory that holds only
    BENCHMARK.json and portbench/, the run exits non-zero and prints no
    result."""
    shutil.copytree(BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.MANIFEST, tmp_path / "BENCHMARK.json")
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == "", out.stdout
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench.harness import main\n"
        "main.run_cell('gl2e22.ntt', 3, 0.1, False, device='cpu', overrides={'config': {'log_n': 6}})\n"
    )
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and "blobstreamx_tpu_torch" in out.stderr


def test_the_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(manifest.ROOT)
    assert out.returncode == 2 and out.stdout == "" and "no CUDA card" in out.stderr


def test_json_line_keys_are_the_contract_s():
    """The result object's keys, in order, as run_cell builds them (checked
    last)."""
    from portbench.harness import main

    r = main.run_cell("gl2e22.ntt", 5, 0.1, False, device="cpu",
                      overrides={"config": {"log_n": 5}, "traffic": {"sync_every": 2, "check_sample": 1}})
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert json.loads(json.dumps(r)) == r
    assert set(r["metrics"]) == {"ntt_butterflies_per_s", "setup_s"}
