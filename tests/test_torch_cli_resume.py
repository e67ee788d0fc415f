"""The port's operator surface on the CPU, against the JAX package where it
has a counterpart: PhaseCheckpointer (each package loads the other's
files), Heartbeat / is_stalled / run_with_retry and MetricsWriter (same
behaviour, same record keys), TimingTree.note / flat, prove_skip's phase
resume under run_with_retry, prove_pipelined, the CLI (`python -m
blobstreamx_tpu_torch`, `--device cpu`) and utils.profiling.

The proofs are of tests/test_pipeline.py's seed-11 chain (skip 2 -> 10) on
the CPU; one uninterrupted prove is shared by the module."""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from blobstreamx_tpu.utils import checkpoint as jax_checkpoint, failure as jax_failure, metrics as jax_metrics
from blobstreamx_tpu.utils import timing as jax_timing
from blobstreamx_tpu_torch import __main__ as cli
from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
from blobstreamx_tpu_torch.prover import pipeline, stark
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.prover.overlap import prove_pipelined
from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes
from blobstreamx_tpu_torch.utils import checkpoint, failure, metrics, profiling, timing
from chip_smoke import timing_names

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CFG = StarkConfig(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=4, final_poly_len=4)
FAILURE = {"port": failure, "jax": jax_failure}
CHECKPOINTER = {"port": checkpoint.PhaseCheckpointer, "jax": jax_checkpoint.PhaseCheckpointer}


@pytest.fixture(scope="module")
def chain():
    return fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75,
                             sign_heights={10})


@pytest.fixture(scope="module")
def uninterrupted(chain, tmp_path_factory):
    """(witness, proof bytes, checkpoint directory) of the skip 2 -> 10."""
    w = wit.build_skip_witness(chain, trusted_height=2, target_height=10)
    ckpt = tmp_path_factory.mktemp("uninterrupted")
    return w, skip_proof_to_bytes(pipeline.prove_skip(w, CFG, device="cpu", checkpoint_dir=str(ckpt))), ckpt


# --- PhaseCheckpointer -------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_checkpointer_files_load_in_the_other_package(tmp_path, writer, reader):
    arrays = {"trace": np.arange(24, dtype=np.uint64).reshape(6, 4) * np.uint64(0xFFFFFFFF00000000),
              "signed": np.array([1, 0, 1], np.uint8)}
    scalars = {"key": "k", "publics": [1, 2**63]}
    w = CHECKPOINTER[writer](str(tmp_path), "run")
    r = CHECKPOINTER[reader](str(tmp_path), "run")
    assert r.load("consensus") is None
    w.save("consensus", arrays=arrays, scalars=scalars)
    got_arrays, got_scalars = r.load("consensus")
    assert got_scalars == scalars
    assert sorted(got_arrays) == sorted(arrays)
    for k, v in arrays.items():
        assert got_arrays[k].dtype == v.dtype and np.array_equal(got_arrays[k], v)
    w.save("trace")
    assert r.last_phase(["consensus", "trace", "stark"]) == "trace"
    assert r.last_phase(["stark", "consensus"]) is None
    # a process killed between the .npz and the .json leaves a phase that is not resumed
    os.remove(tmp_path / "run" / "trace.json")
    assert r.load("trace") is None and w.load("trace") is None


def test_checkpointer_without_directory_is_a_no_op():
    c = checkpoint.PhaseCheckpointer(None, "run")
    c.save("consensus", arrays={"a": np.zeros(2)}, scalars={"key": "k"})
    assert c.load("consensus") is None and c.last_phase(["consensus"]) is None


# --- Heartbeat, is_stalled, run_with_retry (the JAX package's tests, both packages) ---

@pytest.mark.parametrize("package", ["port", "jax"])
def test_heartbeat_records(tmp_path, package):
    path = str(tmp_path / "hb.jsonl")
    hb = FAILURE[package].Heartbeat(path, run_id="t", interval=0.05).start()
    time.sleep(0.2)
    hb.stop()
    events = [json.loads(line)["event"] for line in open(path)]
    assert events[0] == "start" and events[-1] == "stop"
    assert events.count("heartbeat") >= 1


def test_heartbeat_record_keys_equal_jax(tmp_path):
    keys = {}
    for package, mod in FAILURE.items():
        path = str(tmp_path / f"{package}.jsonl")
        hb = mod.Heartbeat(path, run_id="t", interval=0.02).start()
        time.sleep(0.1)
        hb.stop()
        recs = [json.loads(line) for line in open(path)]
        keys[package] = {r["event"]: sorted(r) for r in recs}
        assert mod.read_last_heartbeat(path)["event"] == "stop"
    assert keys["port"] == keys["jax"]
    assert keys["port"]["heartbeat"] == ["event", "n", "pid", "run_id", "t"]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_stall_detection(tmp_path, package):
    mod = FAILURE[package]
    path = str(tmp_path / "hb.jsonl")
    assert mod.is_stalled(path, timeout=1)  # missing file
    hb = mod.Heartbeat(path, run_id="t", interval=0.05).start()
    time.sleep(0.1)
    assert not mod.is_stalled(path, timeout=5)
    assert mod.is_stalled(path, timeout=5, now=time.time() + 60)
    hb.stop()
    # a clean stop is not a stall, however old
    assert not mod.is_stalled(path, timeout=0)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_run_with_retry_recovers(tmp_path, package):
    calls = {"n": 0}

    def attempt():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected fault")
        return "proof"

    failures = []
    out = FAILURE[package].run_with_retry(
        attempt, attempts=2, heartbeat_path=str(tmp_path / "hb.jsonl"), run_id="r", interval=10,
        on_failure=lambda i, e: failures.append((i, str(e))),
    )
    assert out == "proof" and calls["n"] == 2
    assert failures == [(0, "injected fault")]
    recs = [json.loads(line) for line in open(tmp_path / "hb.jsonl")]
    assert [(r["event"], r["run_id"]) for r in recs] == [("start", "r#0"), ("stop", "r#0"), ("start", "r#1"),
                                                         ("stop", "r#1")]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_run_with_retry_exhausted(package):
    def attempt():
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="always"):
        FAILURE[package].run_with_retry(attempt, attempts=2)


# --- MetricsWriter and TimingTree ---------------------------------------------

def _tree(mod):
    t = mod.TimingTree("prove_skip")
    with t.scope("consensus"):
        pass
    t.note("consensus+trace resumed from checkpoint")
    with t.scope("stark", items=4, unit="rows"):
        with t.scope("fri"):
            pass
    return t.finish()


def test_timing_note_and_flat_equal_jax():
    port, ref = _tree(timing), _tree(jax_timing)
    assert list(port.flat()) == list(ref.flat()) == [
        "prove_skip", "prove_skip/consensus", "prove_skip/consensus+trace resumed from checkpoint",
        "prove_skip/stark", "prove_skip/stark/fri"]
    assert port.flat()["prove_skip/consensus+trace resumed from checkpoint"] == 0.0
    assert "resumed from checkpoint" in port.render()
    assert timing_names(port.render()) == timing_names(ref.render()) == [
        "prove_skip", "consensus", "consensus+trace resumed from checkpoint", "stark", "fri"]


def test_metrics_records_equal_jax(tmp_path):
    recs, tree = {}, _tree(timing)
    for package, mod in (("port", metrics), ("jax", jax_metrics)):
        path = tmp_path / f"{package}.jsonl"
        w = mod.MetricsWriter(str(path), run_id="r", rank=0)
        w.emit("skip_rejected", reasons=["x"])
        w.emit_timing(tree, n_headers=8)
        mod.MetricsWriter(str(tmp_path / f"{package}-rank1.jsonl"), rank=1).emit("timing")
        assert not (tmp_path / f"{package}-rank1.jsonl").exists()
        recs[package] = [json.loads(line) for line in path.read_text().splitlines()]
    for got, want in zip(recs["port"], recs["jax"]):
        assert list(got) == list(want)
        assert {k: v for k, v in got.items() if k != "t"} == {k: v for k, v in want.items() if k != "t"}
    assert metrics.MetricsWriter(None).rank == 0  # no process group: rank 0


# --- prove_skip's resume under run_with_retry ---------------------------------

def test_retry_resumes_from_checkpoint_dir(uninterrupted, tmp_path, monkeypatch):
    """A failed attempt leaves its phases behind; the retry with the same
    directory proves nothing (stark.prove counted once over both attempts)
    and gives the uninterrupted proof's bytes."""
    w, want, _ = uninterrupted
    ckpt = str(tmp_path / "ckpt")
    state = {"tries": 0, "proves": 0}
    orig = stark.prove

    def counting(*a, **k):
        state["proves"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(stark, "prove", counting)
    rec = str(tmp_path / "metrics.jsonl")

    def attempt():
        state["tries"] += 1
        proof = pipeline.prove_skip(w, CFG, device="cpu", checkpoint_dir=ckpt, metrics=metrics.MetricsWriter(rec))
        if state["tries"] == 1:
            raise RuntimeError("killed after prove")  # a host that died before it returned
        return proof

    proof = failure.run_with_retry(attempt, attempts=2, heartbeat_path=str(tmp_path / "hb.jsonl"))
    assert state == {"tries": 2, "proves": 1}, "the retry proved again instead of resuming"
    assert {"consensus+trace resumed from checkpoint", "stark resumed from checkpoint"} <= set(
        timing_names(proof.timing))
    assert skip_proof_to_bytes(proof) == want
    assert pipeline.verify_skip_proof(proof, CFG)
    first, second = [json.loads(line) for line in open(rec)]
    assert first["event"] == second["event"] == "timing"
    assert (second["n_headers"], second["n_validators"], second["n_rows"]) == (8, 4, 4)
    assert "prove_skip/stark" in first["phases"] and "prove_skip/stark" not in second["phases"]


def test_checkpoint_of_another_key_is_not_resumed(uninterrupted, tmp_path):
    """Phase files whose stored key differs from the proof's are proven
    again, never loaded."""
    w, want, ckpt = uninterrupted
    (run,) = ckpt.iterdir()
    copy = tmp_path / "ckpt" / run.name
    shutil.copytree(run, copy)
    for js in copy.glob("*.json"):
        scalars = json.loads(js.read_text())
        js.write_text(json.dumps({**scalars, "key": "0" * 32}))
    proof = pipeline.prove_skip(w, CFG, device="cpu", checkpoint_dir=str(tmp_path / "ckpt"))
    assert "resumed" not in proof.timing
    assert skip_proof_to_bytes(proof) == want


# --- prove_pipelined ------------------------------------------------------------

def test_pipelined_order_with_a_stub_prover():
    built = []

    def builder(i):
        def build():
            time.sleep(0.01 * (3 - i))  # the later jobs build faster
            built.append(i)
            return i
        return build

    out = list(prove_pipelined((builder(i) for i in range(4)), prove_fn=lambda w, tag: (tag, w), prefetch=2,
                               tag="p"))
    assert out == [("p", 0), ("p", 1), ("p", 2), ("p", 3)]
    assert built == [0, 1, 2, 3]  # one worker thread: builds in job order


def test_pipelined_builder_exception_propagates_in_order():
    def boom():
        raise ValueError("bad witness")

    gen = prove_pipelined([lambda: 1, boom, lambda: 3], prove_fn=lambda w: w)
    assert next(gen) == 1
    with pytest.raises(ValueError, match="bad witness"):
        next(gen)
    with pytest.raises(ValueError, match="prefetch"):
        next(prove_pipelined([lambda: 1], prove_fn=lambda w: w, prefetch=0))


def test_pipelined_early_close_does_not_block():
    release = threading.Event()

    def slow():
        release.wait(10)
        return 2

    gen = prove_pipelined([lambda: 1, slow, lambda: 3], prove_fn=lambda w: w)
    try:
        assert next(gen) == 1  # the slow build is now in flight
        t0 = time.perf_counter()
        gen.close()
        assert time.perf_counter() - t0 < 1.0
    finally:
        release.set()


def test_pipelined_proofs_equal_serial(chain, uninterrupted):
    w, want, _ = uninterrupted
    jobs = [(2, 10), (9, 10)]
    builders = ((lambda a=a, b=b: wit.build_skip_witness(chain, a, b)) for a, b in jobs)
    got = [skip_proof_to_bytes(p) for p in prove_pipelined(builders, config=CFG, device="cpu")]
    serial = [want, skip_proof_to_bytes(pipeline.prove_skip(wit.build_skip_witness(chain, 9, 10), CFG,
                                                                     device="cpu"))]
    assert got == serial


# --- the CLI ----------------------------------------------------------------------

COMMON = ["--rate-bits", "2", "--queries", "8", "--pow-bits", "2"]


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_prove_and_verify_roundtrip(tmp_path, capsys):
    out, claims, rec = (str(tmp_path / n) for n in ("proof.bin", "claims.bin", "metrics.jsonl"))
    args = ["--device", "cpu", "--metrics", rec, "prove-skip", "--headers", "10", "--validators", "4", "--seed",
            "5", "--trusted", "1", "--target", "9", "--out", out, "--claims-out", claims, "--checkpoint-dir",
            str(tmp_path / "ckpt")] + COMMON
    assert cli.main(args) == 0
    got = _last_json(capsys)
    assert got["workload"] == "skip" and got["sha_stark"] == "off" and got["ed_stark"] is False
    assert len(got["data_commitment"]) == 64 and got["out"] == out and got["proof_bytes"] is None
    (timing_rec,) = [json.loads(line) for line in open(rec)]
    assert timing_rec["event"] == "timing" and timing_rec["n_headers"] == 8 and timing_rec["n_validators"] == 4
    (run,) = (tmp_path / "ckpt").iterdir()
    assert sorted(p.name for p in run.iterdir()) == sorted(
        f"{ph}.{ext}" for ph in ("consensus", "trace", "stark") for ext in ("npz", "json"))

    assert cli.main(["verify-skip", "--proof", out, "--claims", claims] + COMMON) == 0
    got = _last_json(capsys)
    assert got["ok"] is True and got["claims"] == "supplied" and got["binding"] == "ok"
    blob = Path(out).read_bytes()
    Path(out).write_bytes(blob[:-40])
    assert cli.main(["verify-skip", "--proof", out] + COMMON) == 1
    got = _last_json(capsys)
    assert got["ok"] is False and got["reason"].startswith("malformed proof")


def test_cli_prove_step(capsys):
    assert cli.main(["--device", "cpu", "prove-step", "--validators", "4"] + COMMON) == 0
    got = _last_json(capsys)
    assert got["workload"] == "step" and got["ok"] is True


def test_cli_selftest(capsys):
    assert cli.main(["--device", "cpu", "selftest"]) == 0
    assert _last_json(capsys) == {"ok": True}


def test_cli_config_plumbing():
    class A:
        rate_bits, cap_height, queries, pow_bits = 2, None, 9, None

    cfg = cli._stark_config(A())
    assert cfg.rate_bits == 2 and cfg.num_query_rounds == 9
    assert cfg.cap_height == StarkConfig().cap_height

    class B:
        rate_bits = cap_height = queries = pow_bits = None

    assert cli._stark_config(B()) == StarkConfig()


@pytest.mark.parametrize("cmd", [["selftest"], ["prove-step", "--validators", "4"],
                                 ["prove-skip", "--headers", "10", "--validators", "4"]])
def test_cli_without_a_card_exits_nonzero(cmd, capsys):
    """The default device is the card: without one and without --device
    cpu the proving subcommands exit non-zero before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(SystemExit) as e:
        cli.main(cmd)
    assert e.value.code != 0 and "CUDA is not available" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_python_dash_m_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    r = subprocess.run([sys.executable, "-m", "blobstreamx_tpu_torch", "selftest"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "CUDA is not available" in r.stderr


# --- profiling ---------------------------------------------------------------------

def test_maybe_trace_none_is_a_no_op(tmp_path):
    with profiling.maybe_trace(None):
        pass
    with profiling.maybe_trace(""):
        pass
    assert not any(tmp_path.iterdir())


def test_maybe_trace_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.maybe_trace(str(log_dir)):
        with profiling.annotate("unit-test-region"):
            torch.arange(64).sum()
    (trace,) = log_dir.glob("*.pt.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "unit-test-region" for e in events)

