"""ctypes bindings for the port's native host runtime (``bsx_sha256.c``
beside this file): SHA-256, Tendermint tuple-tree roots, and the SHA-STARK
trace fill that ``prover.sha_air.build_sha_trace`` runs.

The library is built at first use with ``cc -O3 -fPIC -shared -std=c11``
into ``build/native/`` beside the package, named by a digest of the source
and flags (a changed source is rebuilt, an unchanged one reused), through a
temporary file and ``os.replace`` so that processes building it at once do
not see a partial file. There is no fallback: if ``cc`` is missing or the
build fails, the first call raises with the compiler's output.
``available()`` reports whether the library loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bsx_sha256.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O3", "-fPIC", "-shared", "-std=c11", "-Wall", "-Wextra"]

_lib = None
_lock = threading.Lock()


def lib_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(source.read_bytes())
    return build_dir / f"libbsx-{h.hexdigest()[:16]}.so"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile `source` into `build_dir` unless it is built already; returns
    the library's path. Raises RuntimeError with the compiler's output if
    `cc` is missing or fails."""
    out = lib_path(source, build_dir)
    if out.exists():
        return out
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("cc not found: the native host runtime is built with the system C compiler")
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"cc failed on {source.name} (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    size = ctypes.c_size_t
    lib.bsx_sha256.argtypes = [u8p, size, u8p]
    lib.bsx_sha256_many.argtypes = [u8p, size, size, size, u8p]
    lib.bsx_tuple_root.argtypes = [u64p, u8p, size, u8p]
    lib.bsx_sha_trace_fill.argtypes = [u8p, u8p, size, u64p, u32p, u32p]
    for fn in ("bsx_sha256", "bsx_sha256_many", "bsx_tuple_root", "bsx_sha_trace_fill"):
        getattr(lib, fn).restype = None
    return lib


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def loaded_path() -> str:
    """The file the loaded library came from."""
    return _load()._name


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _u8(data: bytes) -> np.ndarray:
    # one spare byte so that an empty input still has a valid pointer
    return np.frombuffer(data + b"\x00", dtype=np.uint8)


def sha256(message: bytes) -> bytes:
    lib = _load()
    out = np.zeros(32, np.uint8)
    lib.bsx_sha256(_ptr(_u8(message), ctypes.c_uint8), len(message), _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def sha256_many(messages: list[bytes]) -> list[bytes]:
    """SHA-256 of equal-length messages in one call."""
    if not messages:
        return []
    length = len(messages[0])
    if any(len(m) != length for m in messages):
        raise ValueError("sha256_many takes messages of one length")
    lib = _load()
    out = np.zeros(32 * len(messages), np.uint8)
    lib.bsx_sha256_many(_ptr(_u8(b"".join(messages)), ctypes.c_uint8), len(messages), length, length,
                        _ptr(out, ctypes.c_uint8))
    raw = out.tobytes()
    return [raw[32 * i : 32 * i + 32] for i in range(len(messages))]


def tuple_root(heights, data_hashes: list[bytes]) -> bytes:
    """Tendermint data-commitment root over (height, data_hash) tuples."""
    lib = _load()
    h = np.ascontiguousarray(np.asarray(list(heights), dtype=np.uint64).reshape(-1))
    if len(h) != len(data_hashes) or any(len(d) != 32 for d in data_hashes):
        raise ValueError("tuple_root takes one 32-byte data hash a height")
    out = np.zeros(32, np.uint8)
    lib.bsx_tuple_root(_ptr(h, ctypes.c_uint64), _ptr(_u8(b"".join(data_hashes)), ctypes.c_uint8),
                       len(data_hashes), _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def sha_trace_fill(chain: tuple[bool, ...], blocks: list[bytes]):
    """The SHA-STARK trace of a block layout, filled in C. Returns (trace
    (64*n_blocks, N_COLS) uint64, aux list of (w_words[16], out_words[8])
    per block), as prover.sha_air.build_sha_trace."""
    from blobstreamx_tpu_torch.prover import sha_air

    if len(chain) != len(blocks) or any(len(b) != 64 for b in blocks):
        raise ValueError("sha_trace_fill takes one chain flag a 64-byte block")
    lib = _load()
    n_blocks = len(blocks)
    blk = _u8(b"".join(blocks))
    ch = np.array(list(chain) + [False], dtype=np.uint8)
    trace = np.zeros((64 * n_blocks, sha_air.N_COLS), dtype=np.uint64)
    aux_w = np.zeros(16 * n_blocks + 1, dtype=np.uint32)
    aux_out = np.zeros(8 * n_blocks + 1, dtype=np.uint32)
    lib.bsx_sha_trace_fill(
        _ptr(blk, ctypes.c_uint8), _ptr(ch, ctypes.c_uint8), n_blocks, _ptr(trace, ctypes.c_uint64),
        _ptr(aux_w, ctypes.c_uint32), _ptr(aux_out, ctypes.c_uint32),
    )
    w_rows = aux_w[: 16 * n_blocks].reshape(n_blocks, 16).tolist()
    out_rows = aux_out[: 8 * n_blocks].reshape(n_blocks, 8).tolist()
    return trace, [(tuple(w), tuple(o)) for w, o in zip(w_rows, out_rows)]
