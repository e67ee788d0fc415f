"""The readers of the program's spans inside consensus and the STARK, on
canned rendered trees of both roots, and the trace's reduction with the
program's profiler ranges and their device mirrors in it."""

from __future__ import annotations

import pytest

from portbench.harness import manifest
from portbench.harness.trace import summarize

MS = 1_000_000  # ns
# (name, kind, on_device, thread, start_ns, end_ns): the harness's prove
# annotation, host operators and kernels, as test_portbench_metrics.py's
CANNED = [
    ("portbench.prove", "user_annotation", False, 1, 1 * MS, 10 * MS),
    ("aten::add", "cpu_op", False, 1, 2 * MS, 3 * MS),
    ("aten::mul", "cpu_op", False, 1, 5 * MS, 8 * MS),
    ("bsx_kernel", "kernel", True, 0, 1 * MS, 2 * MS),
    ("add_kernel", "kernel", True, 0, int(4.5 * MS), 6 * MS),
    ("Memcpy HtoD", "gpu_memcpy", True, 0, 9 * MS, 10 * MS),
    ("portbench.prove", "gpu_user_annotation", True, 0, 1 * MS, 10 * MS),
]

SKIP = "\n".join([
    "   4572.6 ms  prove_skip",
    "     3871.2 ms  consensus (2.583e+02 headers/s)",
    "        402.0 ms  valsets (4.975e+02 validators/s)",
    "       1101.0 ms  signatures (9.083e+01 signatures/s)",
    "         12.0 ms  powers (1.667e+04 validators/s)",
    "       1310.0 ms  links (7.634e+02 headers/s)",
    "       1040.0 ms  data (9.615e+02 headers/s)",
    "        0.3 ms  trace",
    "      636.2 ms  stark (1.609e+02 rows/s)",
    "        101.0 ms  commit",
    "        202.0 ms  quotient",
    "         31.0 ms  openings",
    "         50.0 ms  deep",
    "        240.0 ms  fri",
    "         10.0 ms  queries",
])
STEP = "\n".join([
    "   2153.2 ms  prove_step",
    "     1592.8 ms  consensus",
    "        201.0 ms  valsets (4.975e+02 validators/s)",
    "       1102.0 ms  signatures (9.074e+01 signatures/s)",
    "          6.0 ms  powers (1.667e+04 validators/s)",
    "        280.0 ms  links (3.571e+00 headers/s)",
    "        0.3 ms  trace",
    "      572.2 ms  stark (1.789e+02 rows/s)",
    "         99.0 ms  commit",
    "        201.0 ms  quotient",
    "        239.0 ms  fri",
])
# the parent's tree: the phases without spans inside them
FLAT = "\n".join([
    "   2153.2 ms  prove_step",
    "     1592.8 ms  consensus",
    "        0.3 ms  trace",
    "      572.2 ms  stark (1.789e+02 rows/s)",
])

WANT = {
    "consensus.valsets_s": (0.402, 0.201),
    "consensus.signatures_s": (1.101, 1.102),
    "consensus.links_s": (1.310, 0.280),
    "consensus.data_s": (1.040, None),
    "stark.commit_s": (0.101, 0.099),
    "stark.quotient_s": (0.202, 0.201),
    "stark.fri_s": (0.240, 0.239),
}


def _run(*trees, traced=1):
    reqs = [{"request": i + 1, "timing": t, "traced": False} for i, t in enumerate(trees)]
    reqs += [{"request": len(trees) + 1, "timing": FLAT, "traced": True}] * traced  # not read
    return {"family": "proof", "requests": reqs}


def _read(name, run):
    return manifest.load_reader(name).read(run)


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_readers_on_both_roots(name):
    skip_s, step_s = WANT[name]
    assert _read(name, _run(SKIP, SKIP)) == pytest.approx(skip_s)
    assert _read(name, _run(STEP)) == (None if step_s is None else pytest.approx(step_s))


def test_span_readers_take_the_mean_and_want_every_proof():
    assert _read("consensus.links_s", _run(SKIP, STEP)) == pytest.approx((1.310 + 0.280) / 2)
    assert _read("consensus.data_s", _run(SKIP, STEP)) is None  # the step proof has no data span
    for name in WANT:
        assert _read(name, _run(FLAT)) is None  # the parent's program: nothing to read
        assert _read(name, {"family": "ntt", "requests": []}) is None
        assert _read(name, _run(traced=1)) is None


def test_span_metrics_are_in_the_benchmark():
    bench = manifest.load_manifest()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        m = entries[name]
        assert (m["source"], m["moves"], m["unit"]) == ("program_span", "proof_s", "s")
        assert m["layer"] == ("Consensus" if name.startswith("consensus.") else "STARK")
        assert m["workloads"] == (["celestia.skip1000"] if name == "consensus.data_s"
                                  else ["celestia.skip1000", "celestia.step"])


def test_program_ranges_leave_the_trace_reduction_alone():
    """The program's ranges (host user annotations) and their device mirrors
    change neither busy time, nor kernels, nor the idle gaps' labels."""
    ranged = CANNED + [
        ("prove_step", "user_annotation", False, 1, 1 * MS, 10 * MS),
        ("prove_step/consensus", "user_annotation", False, 1, int(1.5 * MS), int(8.5 * MS)),
        ("prove_step/consensus/links", "user_annotation", False, 1, 5 * MS, 8 * MS),
        ("prove_step", "gpu_user_annotation", True, 0, 1 * MS, 10 * MS),
        ("prove_step/consensus", "gpu_user_annotation", True, 0, 3 * MS, 6 * MS),
        ("prove_step/consensus/links", "gpu_user_annotation", True, 0, 5 * MS, 6 * MS),
    ]
    want, got = summarize(CANNED, window_s=0.010), summarize(ranged, window_s=0.010)
    for key in ("busy_s", "kernels", "kernel_s", "device_ops", "idle_gaps"):
        assert got[key] == want[key], key
