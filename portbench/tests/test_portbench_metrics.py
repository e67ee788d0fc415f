"""The metric arithmetic on a canned profiler trace and canned runs."""

from __future__ import annotations

import pytest

from portbench.harness import manifest, peaks, timing
from portbench.harness.trace import summarize

MS = 1_000_000  # ns

# (name, kind, on_device, thread, start_ns, end_ns): a 10 ms stretch with
# two prove annotations on thread 1, host operators, kernels and a copy
CANNED = [
    ("portbench.witness_wait", "user_annotation", False, 1, 0, 1 * MS),
    ("portbench.prove", "user_annotation", False, 1, 1 * MS, 10 * MS),
    ("aten::add", "cpu_op", False, 1, 2 * MS, 3 * MS),
    ("aten::mul", "cpu_op", False, 1, 5 * MS, 8 * MS),
    ("aten::sum", "cpu_op", False, 7, 5 * MS, 9 * MS),  # the worker thread: not the prover
    ("bsx_kernel", "kernel", True, 0, 1 * MS, 2 * MS),
    ("bsx_kernel", "kernel", True, 0, 3 * MS, 5 * MS),
    ("add_kernel", "kernel", True, 0, int(4.5 * MS), 6 * MS),
    ("Memcpy HtoD", "gpu_memcpy", True, 0, 9 * MS, 10 * MS),
    ("portbench.prove", "gpu_user_annotation", True, 0, 1 * MS, 10 * MS),  # the annotation's device mirror
]


def test_summarize_a_canned_trace():
    s = summarize(CANNED, window_s=0.010)
    assert s["kernels"] == 3
    assert s["kernel_s"] == pytest.approx(0.0045)
    assert s["busy_s"] == pytest.approx(0.005)  # [1,2] + [3,6] + [9,10] ms
    assert s["device_ops"][0] == ["bsx_kernel", pytest.approx(0.003)]
    gaps = dict(s["idle_gaps"])
    # [0,1] under witness_wait; [2,3] in aten::add; [6,9] in aten::mul (mid 7.5)
    assert gaps["portbench.witness_wait/python"] == pytest.approx(0.001)
    assert gaps["portbench.prove/aten::add"] == pytest.approx(0.001)
    assert gaps["portbench.prove/aten::mul"] == pytest.approx(0.003)
    assert sum(gaps.values()) == pytest.approx(0.010 - 0.005)


RENDERED = "\n".join([
    "   2404.1 ms  prove_skip",
    "     1904.0 ms  consensus (5.378e+02 headers/s)",
    "        0.4 ms  trace",
    "      499.7 ms  stark (2.562e+02 rows/s)",
    "         12.0 ms  nested",
])


def test_timing_tree_reader():
    flat = timing.parse(RENDERED)
    assert flat["prove_skip/consensus"] == pytest.approx(1.904)
    assert flat["prove_skip/stark/nested"] == pytest.approx(0.012)
    assert timing.phase(RENDERED, "stark") == pytest.approx(0.4997)
    assert timing.phase(RENDERED, "sha_stark") is None


def test_timing_tree_reader_on_the_port_s_render():
    from blobstreamx_tpu_torch.utils.timing import TimingTree

    t = TimingTree("prove_step")
    with t.scope("consensus"):
        with t.scope("inner", items=10, unit="rows"):
            pass
    with t.scope("stark", items=4, unit="rows"):
        pass
    t.finish()
    flat = timing.parse(t.render())
    assert set(flat) == {"prove_step", "prove_step/consensus", "prove_step/consensus/inner", "prove_step/stark"}


def _read(name, run):
    return manifest.load_reader(name).read(run)


def proof_run(traced=None):
    reqs = [{"request": i, "wait_s": 0.01 * i, "prove_s": 2.0, "timing": RENDERED, "traced": i == 2}
            for i in (1, 2, 3)]
    return {"family": "proof", "window_s": 7.5, "setup_s": 20.0, "requests": reqs, "traced": traced,
            "device": {"kind": "NVIDIA H100 80GB HBM3"}}


def test_proof_readers():
    run = proof_run({"window_s": 2.5, "busy_s": 0.25, "kernels": 400_000, "kernel_s": 0.2, "requests": 1})
    assert _read("proof_s", run) == pytest.approx(3.75)  # requests 1 and 3; 2 is traced
    assert _read("setup_s", run) == 20.0
    assert _read("witness_wait_s", run) == pytest.approx(0.02)  # requests 1 and 3
    assert _read("consensus_s", run) == pytest.approx(1.904)
    assert _read("trace_s", run) == pytest.approx(0.0004)
    assert _read("stark_s", run) == pytest.approx(0.4997)
    assert _read("launches_per_proof", run) == 400_000
    assert _read("device_idle.proof", run) == pytest.approx(100 * (1 - 0.25 / 3.75))  # the untraced proof
    assert _read("device_idle.ntt", run) is None
    assert _read("ntt_roofline", run) is None
    assert _read("launches_per_proof", proof_run()) is None


def test_ntt_readers():
    t = {"window_s": 0.3, "busy_s": 0.294, "kernels": 4096, "kernel_s": 2048 * 0.000139, "requests": 2048}
    run = {"family": "ntt", "window_s": 10.0, "window_calls": 70_000, "log_n": 22, "setup_s": 9.0, "traced": t,
           "device": {"kind": "NVIDIA H100 80GB HBM3"}}
    assert _read("ntt_butterflies_per_s", run) == pytest.approx(70_000 * 2**21 * 22 / 10.0)
    bytes_, ops = manifest.load_reader("ntt_roofline").work(22)
    assert bytes_ == 32 * 2**22
    bound, by = peaks.bound_s(bytes_, ops, peaks.of("NVIDIA H100 80GB HBM3"))
    assert by == "bytes" and bound * 1e3 == pytest.approx(0.040065, abs=1e-6)
    assert _read("ntt_roofline", run) == pytest.approx(100 * 0.040065 / 0.139, rel=1e-4)
    assert _read("device_idle.ntt", run) == pytest.approx(2.0)
    assert _read("proof_s", run) is None
    assert _read("ntt_roofline", {**run, "device": {"kind": "some other card"}}) is None


class _OldEvent:
    """A profiler event as torch before 2.13 gives it: no activity_type."""

    def __init__(self, name, device, start, end):
        self._n, self._d, self._s, self._e = name, device, start, end

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def start_thread_id(self):
        return 3


def test_raw_events_without_activity_types():
    from portbench.harness import trace

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [_OldEvent("portbench.prove", False, 0, 10), _OldEvent("aten::add", False, 1, 2),
                            _OldEvent("cudaLaunchKernel", False, 2, 3), _OldEvent("ntt_kernel", True, 3, 5),
                            _OldEvent("Memcpy DtoH (Device -> Pinned)", True, 6, 7)]

    kinds = [e[1] for e in trace.raw_events(Prof)]
    assert kinds == ["user_annotation", "cpu_op", "cuda_runtime", "kernel", "gpu_memcpy"]
    assert trace.summarize(trace.raw_events(Prof), 1e-8)["kernels"] == 1
