"""Build, load and count the port's hand-written CUDA kernels (``csrc/``).

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ctypes. Builds happen at first use, into
``build/kernels/`` beside the package, named by a digest of the sources and
flags so a changed source is rebuilt and an unchanged one is reused.
``build()`` starts one nvcc per source, all at once.

Every kernel wrapper adds one to ``launches[<kernel>]`` where it launches its
kernel, and nowhere else; ``reset_counts()`` zeroes them so a caller can show
which kernels a run went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = ("ntt", "poseidon", "ed25519")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
SIGNATURES = {
    "ntt": {
        "bsx_ntt_cols": [_P, _P, _P, _P, _P, _I, _I, _I, _U64, _P, _P],
        "bsx_ntt_smem_max_n": [],
        "bsx_ntt_long_plan": [_I, _I, _P],
        "bsx_ntt_launch_count": [],
        "bsx_twiddle_transpose": [_P, _P, _P, _P, _P, _I, _I, _P],
        "bsx_four_step_first": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
        "bsx_four_step_last": [_P, _P, _P, _P, _I, _I, _P],
    },
    "poseidon": {
        "bsx_poseidon_set_round_constants": [_P],
        "bsx_poseidon_permute": [_P, _P, _P, _P, _I, _P],
    },
    "ed25519": {
        "bsx_ed25519_add": [_P] * 8 + [_P] * 4 + [_I, _P],
        "bsx_gf25519_pow22523": [_P, _P, _I, _P],
        "bsx_gf25519_sqn": [_P, _P, _I, _I, _P],
        "bsx_launch_floor": [_P],
    },
}

# "ntt" counts the tile kernel (n <= 2^14), "ntt_multi" the long-column path
# (one launch a pass of shared-memory stages, two passes up to 2^22), once a call;
# "four_step_first" and "four_step_last" the two launches of the four-step NTT up to 2^28
launches = {"ntt": 0, "ntt_multi": 0, "twiddle_transpose": 0, "four_step_first": 0, "four_step_last": 0,
            "poseidon": 0, "edwards_add": 0, "pow_chain": 0}

_LIBS: dict[str, ctypes.CDLL] = {}


def count(kernel: str) -> None:
    launches[kernel] += 1


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc process per
    source, all started together. Returns {name: ptxas log}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    logs = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in names:
        if name not in logs:
            log_file = lib_path(name).with_suffix(".log")
            logs[name] = log_file.read_text() if log_file.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
