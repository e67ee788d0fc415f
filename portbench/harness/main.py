"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, and the result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``) runs from the harness's start to the window's: the
program's import and CUDA's start, its kernels loaded from the build
directory inside the checkout (built there by the first run), the inputs
made from the seed, and the warm-up of the cell's own shape. Then the
window measures for ``--seconds``; with ``--trace 1`` a stretch of it runs
under torch.profiler. Once the window has closed the peak device memory is
read, the op's probes (the proof cells' forged requests) go through the
program, the program's device state is freed, and the reference judges what
the window and the probes produced. The result is the last line of standard output; each
number that decided ``correct`` is printed beside its limit as the last
lines of standard error, and again under ``checked``, the line's last key.

Without a CUDA card (or with fewer than the cell asks for) the run exits 2
and prints no result; after a failure it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

from portbench.harness import isolation, manifest
from portbench.harness.trace import Tracer


class NoCard(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cache_dirs() -> None:
    """Every compiler cache the run could touch, at fixed paths inside the
    checkout (the program's own kernel builds go to build/kernels and
    build/native, also inside it)."""
    base = manifest.ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(base / sub)


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _device(chips: int, device):
    import torch

    if device is not None and str(device) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise NoCard("no CUDA card: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, {torch.cuda.device_count()} visible")
    return torch.device("cuda", 0)


def _passes(c: dict) -> bool:
    return c["value"] <= c["limit"] if c["is"] == "at_most" else c["value"] >= c["limit"]


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device=None, fault: str | None = None,
             overrides: dict | None = None, t0: float | None = None) -> dict:
    """The result line's object for one run (see the module's docstring).
    device="cpu" runs the plain path on the host (the harness's own tests);
    fault names one of the op's FAULTS, put under the timed path."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = manifest.resolve(cell_name)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    import torch

    dev = _device(cell.chips, device)
    dev_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                "count": cell.chips if dev.type == "cuda" else 0}
    if dev.type == "cuda":
        limit = card_power_limit()
        dev_info["power_limit"] = limit
        log(f"card: {limit}")
        torch.cuda.reset_peak_memory_stats(dev)

    op_mod = manifest.load_op(cell.traffic["op"])
    op = op_mod.Op(cell, seed, dev)
    op.setup()
    undo = op_mod.FAULTS[fault](op) if fault else None
    setup_s = time.perf_counter() - t0
    log(f"set-up: {setup_s:.3f} s")

    tracer = Tracer(trace, dev)
    try:
        rec = op.window(seconds, tracer)
        log(f"window: {rec['window_s']:.3f} s, {rec['attempted']} attempted, {rec['failed']} failed")
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
        if hasattr(op, "probe"):
            t_probe = time.perf_counter()
            op.probe()
            log(f"probes: {time.perf_counter() - t_probe:.3f} s")
    finally:
        if undo:
            undo()
    traced = tracer.summary()
    op.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = op.check()
    log(f"check: {time.perf_counter() - t_check:.3f} s")

    run = {"cell": cell.name, "seed": seed, "seconds": seconds, "setup_s": setup_s,
           "config": cell.config, "traffic": cell.traffic, "device": dev_info, "traced": traced,
           **rec, **op.record()}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = manifest.load_reader(m["name"]).read(run)
        if value is None:
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {
        "correct": all(_passes(c) for c in checks.values()) and rec["failed"] == 0,
        "attempted": rec["attempted"],
        "failed": rec["failed"],
        "metrics": metrics,
        "device": dev_info,
    }
    if traced is not None:
        dev_info["busy_s"] = traced["busy_s"]
        dev_info["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": traced["device_ops"], "idle_gaps": traced["idle_gaps"]}
    for err in getattr(op, "errors", []):
        log(f"error: {err}")
    result["checked"] = checks
    return result


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None, help=argparse.SUPPRESS)  # the control and the harness's tests
    args = p.parse_args(argv)
    cache_dirs()
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), fault=args.fault, t0=t0)
    except NoCard as e:
        log(f"portbench: {e}")
        return 2
    loaded = isolation.forbidden_loaded()
    if loaded:
        log(f"portbench: the process has loaded JAX or the JAX package: {', '.join(loaded)}")
        return 1
    for name, c in result["checked"].items():
        rel = "<=" if c["is"] == "at_most" else ">="
        log(f"check {name}: {c['value']} (must be {rel} {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0
