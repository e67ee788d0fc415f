#!/usr/bin/env python3
"""SASS instruction counts and times of the port's CUDA kernels
(blobstreamx_tpu_torch/csrc/poseidon.cu, ntt.cu, ed25519.cu) on one NVIDIA
card, beside the same kernels of other source trees.

Run from the repository root:

    python3 kernel_report.py [--baseline CSRC_DIR]... [--probe CSRC_DIR]...

It compiles, one nvcc per library and all started together, into
build/kernel_report/ the poseidon.cu, ntt.cu and ed25519.cu of this checkout
and those of every --baseline directory that holds them (an earlier or
another design behind the same C entry points, for example another
checkout's blobstreamx_tpu_torch/csrc), and for each ed25519.cu a probe
library (PROBE) that wraps its field multiply and squaring in small kernels.

For each library it prints the registers per thread and spills (ptxas -v),
and for each kernel the SASS instructions (cuobjdump -sass; NOP padding not
counted) and its loops: every backward branch, with the instructions of its
body. From those it prints, for Poseidon, the instructions one thread
executes per permutation (the static count, plus each of the three round
loops' bodies once more per extra trip: 4, 22, 4 trips), for the NTT the
instructions per butterfly of the tile kernel at (2048, 2048) forward and
of each long-column pass kernel and the whole long-column transform at
(2^21, 32) forward (see ntt_count), of the four-step's two kernels at 2^22
(four_step_first_kernel<11, 2>, four_step_last_kernel<11, 2>) and of the
whole two-launch four-step, and for ed25519.cu the instructions per
field multiply, per squaring, per Edwards add and per pow22523 chain (see
ed_count). Then it times every library's kernel at the shapes of
chip_smoke.py's phase 3 (the NTT's long-column path, columns longer than
2^14, at the SHA-256 tier's shapes and the edges of its design among them),
the twiddle-transpose and the whole four-step NTT at config 4's 2^22 (two
launches where the library has bsx_four_step_first, else the NTT kernel,
the twiddle-transpose and the NTT kernel), in
the order this checkout, baselines, baselines reversed, this checkout,
each time the mean of its two turns, both by CUDA events over back-to-back
calls and as device time under torch.profiler, also by kernel name (see
device_ms), with the kernels a call launches; it holds
every output equal to this checkout's kernel (which chip_smoke.py holds
equal to the plain PyTorch version), and times one empty launch of this
checkout's ed25519 library (the launch floor). A --probe directory is timed
like a baseline but its outputs are not held equal: a design with work
taken out (the field arithmetic, say) to see what the rest costs. The last
line is one JSON
object; the same object is written to chiprun_out/kernel_report.json, and
each library's kernel SASS to chiprun_out/sass/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "build" / "kernel_report"
SASS_DIR = ROOT / "chiprun_out" / "sass"

POSEIDON_SHAPES = (16384, 16383, 1, 1 << 20, 1 << 21)
NTT_SHAPES = (
    (32, 8, True), (256, 8, False), (256, 2, True), (8, 1, True), (1, 4, False),
    (2048, 2048, False), (2048, 2048, True), (1024, 2048, False), (2048, 1024, False),
    (2048, 2050, False), (1 << 14, 3, True),
    # the long-column path (columns longer than 2^14) at the SHA tier's shapes and its edges
    (1 << 21, 32, False), (1 << 18, 32, True), (1 << 18, 20, True), (1 << 21, 2, True), (1 << 21, 16, False),
    (1 << 16, 8, False), (1 << 15, 1, False), (1 << 15, 3, True), (1 << 17, 5, False), (1 << 22, 8, False),
    (1 << 23, 4, False),
    # the Ed25519 STARK's (config 5, 128 segments): trace chunk INTT and LDE, quotient coset INTT and LDE
    (1 << 16, 128, True), (1 << 19, 128, False), (1 << 19, 2, True), (1 << 19, 16, False),
)
LONG_COUNT_SHAPE = (21, 32)  # (log n, columns) at which the long-column kernels' instructions are counted
# the four-step kernels' instances at config 4's 2^22: columns of 2^11, 4-column tiles, counted at (2^11, 2048)
FOUR_STEP_INSTANCE = "ILi11ELi2EE"
FOUR_STEP_LOG_N = 22  # config 4's polynomial: the twiddle-transpose at (2048, 2048) and the whole four-step
ED_LANES = (64, 1024, 4096, 32768)  # the Edwards add's lane counts on config 5's path
CHAIN_CASES = ((None, 64), (None, 4096), (1, 64), (5, 64), (50, 64))  # (sqn k, or pow22523; lanes)
POW22523_SQUARINGS, POW22523_MULS = 251, 11
# Small kernels around one library's field operations: the static SASS count
# of *2 minus that of *1 is one multiply (one squaring) in the same context.
PROBE = """#include "ed25519.cu"
#define PROBE(name, expr) \\
  __global__ void name(const int64_t* a, const int64_t* b, int64_t* o, int n) { \\
    const int j = threadIdx.x; \\
    const fe x = fe_load(a, n, j), y = fe_load(b, n, j); \\
    fe_store(o, n, j, expr); \\
  }
PROBE(probe_mul1, fe_mul(x, y))
PROBE(probe_mul2, fe_mul(fe_mul(x, y), y))
PROBE(probe_sq1, SQ(x))
PROBE(probe_sq2, SQ(SQ(x)))
"""
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH_TARGET = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")


def log(*a):
    print(*a, flush=True)


SOURCES = ("poseidon", "ntt", "ed25519")


def libraries(baselines: list[str]):
    """(label, kernel, source dir) of every library to build: this
    checkout's sources, and each --baseline (or --probe) directory's that
    it holds."""
    csrc = ROOT / "blobstreamx_tpu_torch" / "csrc"
    libs = [("shipped", k, csrc) for k in SOURCES]
    for d in baselines:
        libs += [(d, k, Path(d)) for k in SOURCES if (Path(d) / f"{k}.cu").exists()]
    return libs


def probe_source(src: Path) -> str:
    """PROBE for one ed25519.cu; a design without fe_sq squares with fe_mul."""
    sq = "fe_sq(v)" if "fe_sq(" in (src / "ed25519.cu").read_text() else "fe_mul(v, v)"
    return f"#define SQ(v) {sq}\n" + PROBE


def build(libs) -> dict:
    """Compile every library, and a probe library beside each ed25519.cu
    (under the name "ed25519_probe"), all at once."""
    from blobstreamx_tpu_torch import kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for i, (label, name, src) in enumerate(libs):
        jobs.append((label, name, src, src / f"{name}.cu", OUT_DIR / f"lib{name}-{i}.so"))
        if name == "ed25519":
            probe = OUT_DIR / f"ed25519_probe-{i}.cu"
            probe.write_text(probe_source(src))
            jobs.append((label, "ed25519_probe", src, probe, OUT_DIR / f"libed25519_probe-{i}.so"))
    procs = {}
    for label, name, src, cu, out in jobs:
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(src), "-o", str(out), str(cu)]
        procs[(label, name)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                                out)
    built = {}
    for key, (proc, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{text}")
        built[key] = (out, text)
    return built


def ptxas_lines(text: str) -> list[str]:
    """ptxas -v's lines naming each kernel, its registers and its spills."""
    return [line.strip() for line in text.splitlines()
            if "Compiling entry function" in line or "registers" in line or "spill" in line]


def sass(lib: Path) -> dict:
    """{kernel name: [(address, instruction text), ...]} from cuobjdump."""
    return parse_sass(subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True, text=True,
                                     check=True).stdout)


def parse_sass(out: str) -> dict:
    """{kernel name: [(address, instruction text), ...]} of a cuobjdump
    -sass listing, without NOP padding."""
    funcs, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            funcs[cur] = []
        elif cur is not None:
            m = SASS_LINE.search(line)
            if m and not m.group(2).startswith("NOP"):
                funcs[cur].append((int(m.group(1), 16), m.group(2)))
    return funcs


def loops(instrs) -> list[dict]:
    """Every backward branch as a loop: its address range and the
    instructions of its body (a branch to itself after EXIT is padding, not
    a loop)."""
    found = []
    for addr, text in instrs:
        m = BRANCH_TARGET.search(text)
        if not m or m.group(1) is None:
            continue
        target = int(m.group(1), 16)
        if target >= addr:
            continue
        found.append(dict(start=hex(target), end=hex(addr),
                          instructions=sum(1 for a, _t in instrs if target <= a <= addr)))
    return found


def _ops(instrs, lp) -> Counter:
    """Opcodes of a loop's body, without their modifiers, with their counts."""
    lo, hi = int(lp["start"], 16), int(lp["end"], 16)
    return Counter((t.split()[1] if t.startswith("@") else t.split()[0]).split(".")[0]
                   for a, t in instrs if lo <= a <= hi)


def _inside(inner, outer) -> bool:
    return inner is not outer and int(outer["start"], 16) <= int(inner["start"], 16) \
        and int(inner["end"], 16) <= int(outer["end"], 16)


def ntt_count(fn: str, instrs, found: list[dict], log_n: int = 11, c: int = 2048,
              long_pass: tuple[int, int] | None = None) -> dict | None:
    """Instructions one thread executes per butterfly of the whole kernel at
    (2^log_n, c) forward: each loop's body times the trips the launch gives
    it, plus the code outside every loop once, over the butterflies a thread
    runs ((n/2) log n per column). Loops take their role from the memory
    operations in them (LDG/STG device, LDS/STS shared memory); where one
    source loop was compiled into several, or holds both sides of the
    inverse's branch, the larger body counts, and the code outside the
    loops counts whole, so the figure is an upper bound.

    ntt_tile_kernel (tiles of CT columns, radix-8 passes, launched as
    ntt.cu's bsx_ntt_cols launches it): the first pass (STS without LDS or
    STG), the middle passes (LDS and STS) with their enclosing loop, the last
    pass (LDS and STG, radix 2^R with 4 * 2^R STG: lo and hi on both sides of
    the branch); where log n is not a multiple of 3 the last one or two
    passes are radix 4 (ntt_stages), a middle one the LDS and STS loop with
    fewer loads than the radix-8 one. ntt_long_first/mid/last_kernel (one pass of a long column:
    the same radix passes over a tile of 2^L positions x CT columns;
    long_pass = (L, log2 CT) of that pass in bsx_ntt_long_plan at (2^log_n,
    c)): the same roles, per butterfly of the pass's L stages; the last pass
    of the first and middle kernels writes the u64 intermediate (2^R STG),
    that of the last kernel (lo, hi) as the tile kernel does. ntt_smem_kernel
    (one column a block, one stage a barrier, min(n/2, 1024) threads): the
    load (LDG and STS), the stage loop (LDS and STS) with its enclosing loop
    of log n trips, the store (LDS and STG)."""
    n = 1 << log_n
    four_step = "four_step_" in fn
    inner = [lp for lp in found if not any(_inside(o, lp) for o in found)]
    top = [lp for lp in found if not any(_inside(lp, o) for o in found)]
    ops = {id(lp): _ops(instrs, lp) for lp in inner}

    def role(has, lacks=(), stg=None):
        hits = [lp for lp in inner if all(ops[id(lp)][o] for o in has) and not any(ops[id(lp)][o] for o in lacks)
                and stg in (None, ops[id(lp)]["STG"])]
        return max(hits, key=lambda lp: lp["instructions"]) if hits else None

    def outer_extra(lp):
        """The enclosing loop's own instructions (without the loops in it)."""
        outs = [o for o in found if _inside(lp, o)]
        if not outs:
            return 0
        out = min(outs, key=lambda o: o["instructions"])
        return out["instructions"] - sum(i["instructions"] for i in inner if _inside(i, out))

    parts, blocks = {}, None
    tile = "ntt_tile_kernel" in fn or four_step
    if tile or ("ntt_long_" in fn and long_pass is not None):
        log_t, log_ct = (log_n, min(2, c.bit_length() - 1)) if tile else long_pass
        ct = 1 << log_ct
        # ntt_stages: radix-8 passes, the last one or two radix 4
        passes = 1 if log_t <= 3 else (log_t + 2) // 3
        radix8 = log_t - 2 * passes
        r_last = 3 if 3 * passes == log_t else 2
        mid8 = max(0, min(radix8, passes - 1) - 1)
        mid4 = passes - 2 - mid8
        threads = min(512, ((ct << max(log_t - 3, 0)) + 31) // 32 * 32)
        first = role(("STS",), ("LDS", "STG"))
        mids = sorted((lp for lp in inner if ops[id(lp)]["LDS"] and ops[id(lp)]["STS"] and not ops[id(lp)]["STG"]),
                      key=lambda lp: (ops[id(lp)]["LDS"], lp["instructions"]))
        middle = mids[-1] if mids else None  # radix 8: the most shared-memory loads
        middle4 = next((lp for lp in reversed(mids) if ops[id(lp)]["LDS"] < ops[id(middle)]["LDS"]), None) \
            if mids else None
        # the last pass stores (lo, hi) on both sides of the inverse's branch, (lo, hi) once (the
        # four-step's last kernel, no inverse scale) or the u64 intermediate
        stores = 1 if "four_step_first" in fn else 2 if "four_step_last" in fn else \
            4 if tile or "ntt_long_last" in fn else 1
        last = role(("LDS", "STG"), ("STS",), stg=stores << r_last)
        if passes < 3 or radix8 < 1 or None in (first, middle, last) or (mid4 and middle4 is None):
            return None

        def trips(r):
            return -(-(ct << (log_t - r)) // threads)

        parts["first pass"] = first["instructions"] * trips(3)
        parts["middle passes"] = mid8 * (middle["instructions"] * trips(3) + outer_extra(middle))
        if mid4:
            parts["middle passes (radix 4)"] = mid4 * (middle4["instructions"] * trips(2) + outer_extra(middle4))
        parts[f"last pass (radix {1 << r_last})"] = last["instructions"] * trips(r_last)
        butterflies = (1 << (log_t - 1)) * log_t * ct / threads
        blocks = -(-c // ct) << (log_n - log_t)
        per_trip = {"first pass": first["instructions"] / 12, "middle pass": middle["instructions"] / 12,
                    "last pass": last["instructions"] / ((1 << r_last) // 2 * r_last)}
        if mid4:
            per_trip["middle pass (radix 4)"] = middle4["instructions"] / 4
    elif "ntt_smem_kernel" in fn:
        threads = min(n // 2, 1024)
        load = role(("LDG", "STS"), ("LDS",))
        stage = role(("LDS", "STS"))
        store = role(("LDS", "STG"))
        if None in (load, stage, store):
            return None
        parts["load"] = load["instructions"] * (n // threads)
        parts["stages"] = log_n * (stage["instructions"] * (n // 2 // threads) + outer_extra(stage))
        parts["store"] = store["instructions"] * (n // threads)
        butterflies = (n // 2) * log_n / threads
        per_trip = {"stage": stage["instructions"]}
    else:
        return None
    parts["outside loops"] = len(instrs) - sum(lp["instructions"] for lp in top)
    out = dict(shape=f"({n}, {c}) forward", threads=threads, butterflies_per_thread=butterflies,
               instructions_per_thread=parts, per_butterfly=round(sum(parts.values()) / butterflies, 2),
               loop_body_per_butterfly=per_trip)
    if long_pass is not None or four_step:
        out.update(stages=log_t if four_step else long_pass[0], blocks=blocks)
    return out


def long_transform_count(counts: list[dict]) -> float | None:
    """Instructions per butterfly of a whole transform of several launches
    (a long column's passes, the four-step's two kernels) from their
    ntt_count: every thread's instructions over every butterfly."""
    if not counts or None in counts:
        return None
    instr = sum(sum(k["instructions_per_thread"].values()) * k["threads"] * k["blocks"] for k in counts)
    butterflies = sum(k["butterflies_per_thread"] * k["threads"] * k["blocks"] for k in counts)
    return round(instr / butterflies, 2)


def long_plan(lib, log_n: int, c: int) -> list[tuple[int, int]] | None:
    """(stages, log2 column tile) of each pass of a library's long-column
    plan at (2^log_n, c) (bsx_ntt_long_plan), or None for a design without one."""
    if getattr(lib, "bsx_ntt_long_plan", None) is None:
        return None
    out = (ctypes.c_int * 8)()
    passes = lib.bsx_ntt_long_plan(log_n, c, out)
    return [(out[1 + p], out[0]) for p in range(passes)]


def ed_count(probe: dict, add_static: int | None) -> dict | None:
    """SASS instructions of one ed25519.cu design: per field multiply and per
    squaring (PROBE: the static count of probe_*2 minus probe_*1), per
    Edwards add (the static count of edwards_add_kernel: one lane's work,
    its four roles' code counted once each, the shared code once), and per
    pow22523 chain, from those: 251 squarings, 11 multiplies and once the
    load, the canonical store and the indexing around them (probe_sq1
    without its squaring)."""
    sizes = {}
    for fn, instrs in probe.items():
        m = re.search(r"probe_(mul|sq)([12])", fn)
        if m:
            sizes[m.group(0)] = len(instrs)
    if len(sizes) != 4:
        return None
    mul = sizes["probe_mul2"] - sizes["probe_mul1"]
    sq = sizes["probe_sq2"] - sizes["probe_sq1"]
    io = sizes["probe_sq1"] - sq
    return dict(per_multiply=mul, per_squaring=sq, load_store=io, per_edwards_add=add_static,
                per_pow22523_chain=POW22523_SQUARINGS * sq + POW22523_MULS * mul + io)


def per_permutation(static: int, round_loops: list[dict]) -> int | None:
    if len(round_loops) != 3:
        return None
    return static + sum(lp["instructions"] * (t - 1) for lp, t in zip(round_loops, (4, 22, 4)))


def device_ms(fn, reps: int, tries: int = 3, launches: int = 1) -> tuple[float | None, dict]:
    """The device time of the kernels `fn` launches, per call: their
    durations under torch.profiler over `reps` calls, over `reps`; and the
    same by kernel name. Unlike CUDA events around back-to-back calls it
    leaves out the host's time between launches, which is what such a loop
    measures for a kernel shorter than its launch. A profile that recorded
    fewer than `launches` kernels a call is taken again; (None, {}) if none
    of `tries` recorded them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import dev_us

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if sum(e.count for e in kernels) >= reps * launches:
            by_name = {e.key.split("(")[0]: dev_us(e) / 1e3 / reps for e in kernels}
            return sum(dev_us(e) for e in kernels) / 1e3 / reps, by_name
    return None, {}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_report: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    import numpy as np

    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.golden import goldilocks as gold
    from blobstreamx_tpu_torch.ops import ntt, poseidon as pos
    from chip_smoke import time_ms

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="a csrc/ directory holding other designs' poseidon.cu, ntt.cu or ed25519.cu (repeatable)")
    ap.add_argument("--probe", action="append", default=[],
                    help="like --baseline, but its outputs are not held equal to this checkout's (repeatable)")
    args = ap.parse_args()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    libs = libraries(args.baseline + args.probe)
    built = build(libs)
    SASS_DIR.mkdir(parents=True, exist_ok=True)
    report = {"card": smi, "libraries": []}
    handles = {}
    probes = {label: sass(built[(label, "ed25519_probe")][0]) for label, name, _s in libs if name == "ed25519"}
    for label, name, _src in libs:
        path, text = built[(label, name)]
        entry = dict(label=label, source=name, ptxas=ptxas_lines(text), kernels={})
        dump = []
        for fn, instrs in sass(path).items():
            if not any(k in fn for k in ("poseidon_kernel", "ntt_smem_kernel", "ntt_tile_kernel", "ntt_long_",
                                         "twiddle_transpose_kernel", "four_step_first_kernel",
                                         "four_step_last_kernel", "edwards_add_kernel", "pow22523_kernel",
                                         "sqn_kernel")):
                continue
            dump += [f"Function : {fn}"] + [f"/*{a:04x}*/ {t}" for a, t in instrs]
            k = dict(static_instructions=len(instrs), loops=loops(instrs))
            if "poseidon_kernel" in fn:
                k["per_permutation"] = per_permutation(len(instrs), k["loops"])
            elif "ntt_tile_kernel" in fn or "ntt_smem_kernel" in fn:
                k["per_butterfly"] = ntt_count(fn, instrs, k["loops"])
            elif "four_step_" in fn and FOUR_STEP_INSTANCE in fn:
                k["per_butterfly"] = ntt_count(fn, instrs, k["loops"])
            elif "ntt_long_" in fn:
                plan = long_plan(ctypes.CDLL(str(path)), *LONG_COUNT_SHAPE) or []
                role = 0 if "first" in fn else len(plan) - 1 if "last" in fn else 1 if len(plan) > 2 else None
                k["per_butterfly"] = None if role is None or not plan else ntt_count(
                    fn, instrs, k["loops"], *LONG_COUNT_SHAPE, long_pass=plan[role])
            entry["kernels"][fn] = k
        if name == "ntt":
            plan = long_plan(ctypes.CDLL(str(path)), *LONG_COUNT_SHAPE) or []
            by_role = {kind: next((k["per_butterfly"] for fn, k in entry["kernels"].items()
                                   if f"ntt_long_{kind}_kernel" in fn), None) for kind in ("first", "mid", "last")}
            roles = ["first"] + ["mid"] * (len(plan) - 2) + ["last"] if plan else []
            entry["long_plan"] = plan
            entry["long_per_butterfly"] = long_transform_count([by_role[r] for r in roles])
            halves = [next((k["per_butterfly"] for fn, k in entry["kernels"].items()
                            if f"four_step_{kind}_kernel" in fn and FOUR_STEP_INSTANCE in fn), None)
                      for kind in ("first", "last")]
            entry["four_step_per_butterfly"] = long_transform_count(halves) if any(halves) else None
        if name == "ed25519":
            add = [k["static_instructions"] for fn, k in entry["kernels"].items() if "edwards_add_kernel" in fn]
            entry["field_counts"] = ed_count(probes[label], add[0] if add else None)
        report["libraries"].append(entry)
        (SASS_DIR / f"{path.stem}.sass.txt").write_text("\n".join(dump) + "\n")
        log(f"{name} [{label}]: " + json.dumps(entry))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in kernels.SIGNATURES[name].items():
            f = getattr(lib, fn, None)  # an earlier design may lack an entry (the launch floor)
            if f is not None:
                f.argtypes, f.restype = argtypes, ctypes.c_int
        if name == "poseidon":
            rc = np.ascontiguousarray(pos._round_constants_np())
            kernels.check(lib.bsx_poseidon_set_round_constants(rc.ctypes.data), "poseidon constants")
        handles[(label, name)] = lib

    rng = np.random.default_rng(7)
    stream = torch.cuda.current_stream().cuda_stream

    def poseidon_call(lib, s):
        out = (torch.empty_like(s[0]), torch.empty_like(s[1]))
        kernels.check(lib.bsx_poseidon_permute(s[0].data_ptr(), s[1].data_ptr(), out[0].data_ptr(),
                                               out[1].data_ptr(), s[0].shape[1], stream), "poseidon")
        return out

    def ntt_call(lib, x, inverse):
        n, c = x[0].shape
        log_n = n.bit_length() - 1
        tw = ntt._power_table_device(log_n, inverse, "cuda")
        out = (torch.empty_like(x[0]), torch.empty_like(x[1]))
        scratch = torch.empty((n, c), dtype=torch.int64, device="cuda") if n > lib.bsx_ntt_smem_max_n() else None
        kernels.check(lib.bsx_ntt_cols(x[0].data_ptr(), x[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                       tw.data_ptr(), log_n, c, int(inverse),
                                       gold.inv(n % gold.P) if inverse else 1,
                                       None if scratch is None else scratch.data_ptr(), stream), "ntt")
        return out

    def tt_call(lib, m, log_n, inverse):
        n1, n2 = m[0].shape
        tw = ntt._power_table_device(log_n, inverse, "cuda")
        out = (torch.empty((n2, n1), dtype=torch.int64, device="cuda"),
               torch.empty((n2, n1), dtype=torch.int64, device="cuda"))
        kernels.check(lib.bsx_twiddle_transpose(m[0].data_ptr(), m[1].data_ptr(), out[0].data_ptr(),
                                                out[1].data_ptr(), tw.data_ptr(), n1.bit_length() - 1,
                                                n2.bit_length() - 1, stream), "twiddle-transpose")
        return out

    def four_step_call(lib, mat, inverse):
        n1, n2 = mat[0].shape
        l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
        buf = torch.empty((n2, n1), dtype=torch.int64, device="cuda")
        high, low = ntt._four_step_twiddle_tables_device(FOUR_STEP_LOG_N, inverse, "cuda")
        kernels.check(lib.bsx_four_step_first(mat[0].data_ptr(), mat[1].data_ptr(), buf.data_ptr(),
                                              ntt._power_table_device(l1, inverse, "cuda").data_ptr(),
                                              high.data_ptr(), low.data_ptr(), l1, l2, stream), "four-step first")
        out = (torch.empty((n2, n1), dtype=torch.int64, device="cuda"),
               torch.empty((n2, n1), dtype=torch.int64, device="cuda"))
        kernels.check(lib.bsx_four_step_last(buf.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                             ntt._power_table_device(l2, inverse, "cuda").data_ptr(), l1, l2,
                                             stream), "four-step last")
        return out

    def ntt_kind_call(lib, x, arg):
        """arg = (kind, inverse): "cols" is bsx_ntt_cols on an (n, C) batch,
        "tt" the twiddle-transpose of config 4's (n1, n2) matrix, "four_step"
        the whole four-step NTT of one polynomial: the library's two four-step
        kernels, or for a design without them its NTT kernel, twiddle-transpose
        and NTT kernel."""
        kind, inverse = arg
        if kind == "cols":
            return ntt_call(lib, x, inverse)
        if kind == "tt":
            return tt_call(lib, x, FOUR_STEP_LOG_N, inverse)
        n1, n2 = ntt.four_step_shape(FOUR_STEP_LOG_N)
        mat = (x[0].reshape(n1, n2), x[1].reshape(n1, n2))
        if getattr(lib, "bsx_four_step_first", None) is None:  # the three-launch design
            out = ntt_call(lib, tt_call(lib, ntt_call(lib, mat, inverse), FOUR_STEP_LOG_N, inverse), inverse)
        else:
            out = four_step_call(lib, mat, inverse)
        return out[0].reshape(-1), out[1].reshape(-1)

    def add_call(lib, coords):
        n = coords[0].shape[1]
        outs = tuple(torch.empty_like(coords[0]) for _ in range(4))
        kernels.check(lib.bsx_ed25519_add(*(c.data_ptr() for c in coords), *(o.data_ptr() for o in outs), n,
                                          stream), "edwards add")
        return outs

    def chain_call(lib, a, k):
        out = torch.empty_like(a)
        n = a.shape[1]
        rc = lib.bsx_gf25519_pow22523(a.data_ptr(), out.data_ptr(), n, stream) if k is None else \
            lib.bsx_gf25519_sqn(a.data_ptr(), out.data_ptr(), n, k, stream)
        kernels.check(rc, "power chain")
        return (out,)

    def fe_limbs(count, n):
        """count (16, n) tensors of random 16-bit limbs: values below 2^256."""
        return [torch.from_numpy(rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)).cuda() for _ in range(count)]

    cases = [("poseidon", f"(12, {n})", (12, n), None) for n in POSEIDON_SHAPES]
    direction = {False: "forward", True: "inverse"}
    cases += [("ntt", f"({n}, {c}) {direction[inv]}", (n, c), ("cols", inv)) for n, c, inv in NTT_SHAPES]
    n1, n2 = ntt.four_step_shape(FOUR_STEP_LOG_N)
    cases += [("ntt", f"twiddle_transpose ({n1}, {n2}) {direction[inv]}", (n1, n2), ("tt", inv)) for inv in (False, True)]
    cases += [("ntt", f"four-step 2^{FOUR_STEP_LOG_N} {direction[inv]}", (1 << FOUR_STEP_LOG_N,), ("four_step", inv))
              for inv in (False, True)]
    cases += [("ed25519", f"edwards add, {n} lanes", n, "add") for n in ED_LANES]
    cases += [("ed25519", f"{'pow22523' if k is None else f'sqn k={k}'}, {n} lanes", n, k) for k, n in CHAIN_CASES]
    times = []
    for name, shape, dims, arg in cases:
        if name == "ed25519":
            x = fe_limbs(8, dims) if arg == "add" else fe_limbs(1, dims)[0]
            size = 1
        else:
            x = gf64.from_u64(rng.integers(0, gf64.P, size=dims, dtype=np.uint64), "cuda")
            size = int(np.prod(dims))
        labels = [label for label, nm, _s in libs if nm == name]
        order = labels + labels[::-1]

        def call(label):
            lib = handles[(label, name)]
            if name == "poseidon":
                return poseidon_call(lib, x)
            if name == "ntt":
                return ntt_kind_call(lib, x, arg)
            return add_call(lib, x) if arg == "add" else chain_call(lib, x, arg)

        def launches(label):
            """Kernels one call launches: the library's own count of its NTT
            launches where it keeps one (bsx_ntt_launch_count), plus the
            four-step's twiddle-transpose; 2 for a two-launch four-step;
            else 1."""
            lib = handles[(label, name)]
            count = getattr(lib, "bsx_ntt_launch_count", None)
            if arg[0] == "four_step" and getattr(lib, "bsx_four_step_first", None) is not None:
                return 2
            if count is None or arg[0] == "tt":
                return 1
            before = count()
            call(label)
            return count() - before + (arg[0] == "four_step")

        want = call("shipped")
        reps = 20 if size <= 1 << 20 else 5
        row = dict(kernel=name, shape=shape, ms={}, device_ms={}, device_ms_by_kernel={}, launches={},
                   mismatches={})
        turns = {label: ([], [], []) for label in labels}
        for label in order:
            got = call(label)
            row["mismatches"][label] = sum(int((g != w).sum().item()) for g, w in zip(got, want))  # words
            if name == "ntt":
                row["launches"][label] = launches(label)
            turns[label][0].append(time_ms(lambda: call(label), reps))
            dev, by_kernel = device_ms(lambda: call(label), reps, launches=row["launches"].get(label, 1))
            turns[label][1].append(dev)
            turns[label][2].append(by_kernel)
        for label, (events, device, by_kernel) in turns.items():
            row["ms"][label] = sum(events) / 2
            row["device_ms"][label] = None if None in device else sum(device) / 2
            if all(by_kernel):
                row["device_ms_by_kernel"][label] = {k: sum(b.get(k, 0.0) for b in by_kernel) / 2
                                                     for k in by_kernel[0]}
        log(json.dumps(row))
        assert not any(v for label, v in row["mismatches"].items() if label not in args.probe), \
            f"a baseline disagrees with the shipped kernel: {row}"
        times.append(row)
        del x
    floor = handles[("shipped", "ed25519")].bsx_launch_floor
    report["launch_floor_ms"] = time_ms(lambda: kernels.check(floor(stream), "launch floor"), 100)
    log(f"launch floor (one empty kernel through ctypes): {report['launch_floor_ms']:.4f} ms")
    report["times"] = times
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
