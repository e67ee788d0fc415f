"""Whole runs on the host at a small size: each cell comes out correct, and
comes out not correct under its control and under every fault put under
its timed path (a request answered with the previous answer, half of the
work left out, an answer altered where it is made, and in the proof cells
a signature batch, header link or validator-set hash left unchecked). One card: there is no
exchange between chips to leave out.

The cells run the port's plain path on CPU tensors here: the skip over
8-header ranges and the step on 4-validator chains, the NTT at 2^10. About
90 s in one process; ``-n 4`` (pytest-xdist) brings it under 30 s.
"""

from __future__ import annotations

import pytest
import torch

from portbench.harness.main import run_cell

torch.set_num_threads(2)  # several test workers share the host

SMALL = {
    "celestia.skip1000": {"config": {"n_validators": 4}, "traffic": {"range": 7, "check_sample": 1}},
    "celestia.step": {"config": {"n_validators": 4}, "traffic": {"check_sample": 1}},
    "gl2e22.ntt": {"config": {"log_n": 10}, "traffic": {"sync_every": 4, "check_sample": 4, "warmup_calls": 1}},
}
SEED = 2**31 + 101


def _run(cell, fault=None, seconds=0.0):
    overrides = {k: dict(v) for k, v in SMALL[cell].items()}
    return run_cell(cell, SEED, seconds, False, device="cpu", fault=fault, overrides=overrides)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    r = _run(cell, seconds=0.5 if cell == "gl2e22.ntt" else 0.0)
    assert r["correct"], r["checked"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] <= c["limit"] if c["is"] == "at_most" else c["value"] >= c["limit"]
               for c in r["checked"].values())


def _failed(r):
    return {k for k, c in r["checked"].items() if c["is"] == "at_most" and c["value"] > c["limit"]}


@pytest.mark.parametrize("fault", ["control", "stale", "half", "altered"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_timed_path_is_not_correct(cell, fault):
    r = _run(cell, fault=fault)
    assert not r["correct"], (fault, r["checked"])
    bad = _failed(r)
    assert bad <= {"wrong_outputs", "stark_rejected", "wrong_verdicts", "mismatched_elements"} and bad, r["checked"]


@pytest.mark.parametrize("fault", ["nosig", "nolinks", "novalset"])
@pytest.mark.parametrize("cell", ["celestia.skip1000", "celestia.step"])
def test_a_skipped_consensus_check_is_not_correct(cell, fault):
    """The window's honest requests prove alike with or without the check;
    the forged request that breaks it is what catches the skip."""
    r = _run(cell, fault=fault)
    assert not r["correct"], (fault, r["checked"])
    assert _failed(r) == {"wrong_verdicts"}, r["checked"]
