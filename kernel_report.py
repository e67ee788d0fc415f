#!/usr/bin/env python3
"""SASS instruction counts and times of the Poseidon and NTT kernels
(blobstreamx_tpu_torch/csrc/poseidon.cu, ntt.cu) on one NVIDIA card, beside
the same kernels of other source trees.

Run from the repository root:

    python3 kernel_report.py [--baseline CSRC_DIR]...

It compiles, one nvcc per library and all started together, into
build/kernel_report/ the poseidon.cu and ntt.cu of this checkout and of
every --baseline directory (an earlier design behind the same C entry
points, for example another checkout's blobstreamx_tpu_torch/csrc).

For each library it prints the registers per thread and spills (ptxas -v),
and for each kernel the SASS instructions (cuobjdump -sass; NOP padding not
counted) and its loops: every backward branch, with the instructions of its
body. From those it prints, for Poseidon, the instructions one thread
executes per permutation (the static count, plus each of the three round
loops' bodies once more per extra trip: 4, 22, 4 trips), and for the NTT
the instructions per butterfly of the whole kernel at (2048, 2048) forward
(see ntt_count). Then it times every library's kernel by CUDA events at the
shapes of chip_smoke.py's phase 3, in the order this checkout, baselines,
baselines reversed, this checkout (each time the mean of its two turns),
and holds every output equal to this checkout's kernel (which chip_smoke.py
holds equal to the plain PyTorch version). The last line is one JSON
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
)
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
BRANCH_TARGET = re.compile(r"\bBRA(?:\.\w+)*\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))")


def log(*a):
    print(*a, flush=True)


def libraries(baselines: list[str]):
    """(label, kernel, source dir) of every library to build."""
    csrc = ROOT / "blobstreamx_tpu_torch" / "csrc"
    libs = [("shipped", k, csrc) for k in ("poseidon", "ntt")]
    for d in baselines:
        libs += [(d, k, Path(d)) for k in ("poseidon", "ntt")]
    return libs


def build(libs) -> dict:
    from blobstreamx_tpu_torch import kernels

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (label, name, src) in enumerate(libs):
        out = OUT_DIR / f"lib{name}-{i}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(src),
               "-o", str(out), str(src / f"{name}.cu")]
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
    return [line.strip() for line in text.splitlines() if "registers" in line or "spill" in line]


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


def ntt_count(fn: str, instrs, found: list[dict], log_n: int = 11, c: int = 2048) -> dict | None:
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
    the branch). ntt_smem_kernel (one column a block, one stage a barrier,
    min(n/2, 1024) threads): the load (LDG and STS), the stage loop (LDS and
    STS) with its enclosing loop of log n trips, the store (LDS and STG)."""
    n = 1 << log_n
    inner = [lp for lp in found if not any(_inside(o, lp) for o in found)]
    top = [lp for lp in found if not any(_inside(lp, o) for o in found)]
    ops = {id(lp): _ops(instrs, lp) for lp in inner}

    def role(has, lacks=(), stg=None):
        hits = [lp for lp in inner if all(ops[id(lp)][o] for o in has) and not any(ops[id(lp)][o] for o in lacks)
                and stg in (None, ops[id(lp)]["STG"])]
        return max(hits, key=lambda lp: lp["instructions"]) if hits else None

    def outer_extra(lp):
        outs = [o for o in found if _inside(lp, o)]
        return min(o["instructions"] for o in outs) - lp["instructions"] if outs else 0

    parts = {}
    if "ntt_tile_kernel" in fn:
        log_ct = min(2, c.bit_length() - 1)
        ct = 1 << log_ct
        passes = 1 if log_n <= 3 else (log_n + 2) // 3
        r_last = log_n - 3 * (passes - 1)
        threads = min(512, ((ct << max(log_n - 3, 0)) + 31) // 32 * 32)
        first = role(("STS",), ("LDS", "STG"))
        middle = role(("LDS", "STS"), ("STG",))
        last = role(("LDS", "STG"), ("STS",), stg=4 << r_last)
        if passes < 3 or None in (first, middle, last):
            return None

        def trips(r):
            return -(-(ct << (log_n - r)) // threads)

        parts["first pass"] = first["instructions"] * trips(3)
        parts["middle passes"] = (passes - 2) * (middle["instructions"] * trips(3) + outer_extra(middle))
        parts[f"last pass (radix {1 << r_last})"] = last["instructions"] * trips(r_last)
        butterflies = (n // 2) * log_n * ct / threads
        per_trip = {"first pass": first["instructions"] / 12, "middle pass": middle["instructions"] / 12,
                    "last pass": last["instructions"] / ((1 << r_last) // 2 * r_last)}
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
    return dict(shape=f"({n}, {c}) forward", threads=threads, butterflies_per_thread=butterflies,
                instructions_per_thread=parts, per_butterfly=round(sum(parts.values()) / butterflies, 2),
                loop_body_per_butterfly=per_trip)


def per_permutation(static: int, round_loops: list[dict]) -> int | None:
    if len(round_loops) != 3:
        return None
    return static + sum(lp["instructions"] * (t - 1) for lp, t in zip(round_loops, (4, 22, 4)))


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[],
                    help="a csrc/ directory holding an earlier poseidon.cu and ntt.cu (repeatable)")
    args = ap.parse_args()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    libs = libraries(args.baseline)
    built = build(libs)
    SASS_DIR.mkdir(parents=True, exist_ok=True)
    report = {"card": smi, "libraries": []}
    handles = {}
    for label, name, _src in libs:
        path, text = built[(label, name)]
        entry = dict(label=label, source=name, ptxas=ptxas_lines(text), kernels={})
        dump = []
        for fn, instrs in sass(path).items():
            if not any(k in fn for k in ("poseidon_kernel", "ntt_smem_kernel", "ntt_tile_kernel")):
                continue
            dump += [f"Function : {fn}"] + [f"/*{a:04x}*/ {t}" for a, t in instrs]
            k = dict(static_instructions=len(instrs), loops=loops(instrs))
            if "poseidon_kernel" in fn:
                k["per_permutation"] = per_permutation(len(instrs), k["loops"])
            else:
                k["per_butterfly"] = ntt_count(fn, instrs, k["loops"])
            entry["kernels"][fn] = k
        report["libraries"].append(entry)
        (SASS_DIR / f"{path.stem}.sass.txt").write_text("\n".join(dump) + "\n")
        log(f"{name} [{label}]: " + json.dumps(entry))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in kernels.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
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
        kernels.check(lib.bsx_ntt_cols(x[0].data_ptr(), x[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                                       tw.data_ptr(), log_n, c, int(inverse),
                                       gold.inv(n % gold.P) if inverse else 1, None, stream), "ntt")
        return out

    cases = [("poseidon", f"(12, {n})", (12, n), None) for n in POSEIDON_SHAPES]
    cases += [("ntt", f"({n}, {c}) {'inverse' if inv else 'forward'}", (n, c), inv) for n, c, inv in NTT_SHAPES]
    times = []
    for name, shape, dims, inverse in cases:
        x = gf64.from_u64(rng.integers(0, gf64.P, size=dims, dtype=np.uint64), "cuda")
        labels = [label for label, nm, _s in libs if nm == name]
        order = labels + labels[::-1]

        def call(label):
            lib = handles[(label, name)]
            return poseidon_call(lib, x) if name == "poseidon" else ntt_call(lib, x, inverse)

        want = call("shipped")
        reps = 20 if dims[0] * dims[1] <= 1 << 20 else 5
        row = dict(kernel=name, shape=shape, ms={}, mismatches={})
        for label in order:
            got = call(label)
            row["mismatches"][label] = int(((got[0] != want[0]) | (got[1] != want[1])).sum().item())
            ms = time_ms(lambda: call(label), reps)
            row["ms"][label] = row["ms"].get(label, 0.0) + ms / 2
        log(json.dumps(row))
        assert not any(row["mismatches"].values()), f"a baseline disagrees with the shipped kernel: {row}"
        times.append(row)
        del x
    report["times"] = times
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
