"""The port's native host runtime (blobstreamx_tpu_torch.native, its own
copy of the C source built into build/native/) against hashlib, the JAX
package's native module and golden model, and the port's numpy trace
builder, on the CPU. Exact equality throughout."""

import hashlib
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from blobstreamx_tpu import native as jax_native
from blobstreamx_tpu.golden import merkle as jax_merkle
from blobstreamx_tpu.prover import sha_air as jax_sha_air
from blobstreamx_tpu_torch import native
from blobstreamx_tpu_torch.prover import sha_air, sha_claims

# the padding edges: empty, one block with room for the length (55), the first
# length that spills into a second block (56), a whole block (64), many blocks
LENGTHS = (0, 1, 55, 56, 63, 64, 65, 119, 120, 1000)


def message(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed + n).bytes(n)


def test_library_loads():
    """Both libraries load (the JAX package's too, so that its build_sha_trace
    below is its C builder); where the port's comes from is checked in
    tests/test_torch_isolation.py."""
    assert native.available() and jax_native.available()


@pytest.mark.parametrize("n", LENGTHS)
def test_sha256_matches_hashlib_and_jax(n):
    m = message(n)
    want = hashlib.sha256(m).digest()
    assert native.sha256(m) == want == jax_native.sha256(m)


@pytest.mark.parametrize("n", (0, 55, 56, 64, 65, 1000))
def test_sha256_many_matches_hashlib(n):
    msgs = [message(n, seed) for seed in range(5)]
    assert native.sha256_many(msgs) == [hashlib.sha256(m).digest() for m in msgs]
    assert native.sha256_many([]) == []


@pytest.mark.parametrize("n", (1, 2, 3, 5, 8, 33))
def test_tuple_root_matches_jax_and_golden(n):
    rng = np.random.default_rng(n)
    heights = [int(h) for h in rng.integers(1, 1 << 40, size=n)]
    hashes = [rng.bytes(32) for _ in range(n)]
    want = jax_merkle.data_commitment(heights, hashes)
    assert native.tuple_root(heights, hashes) == want == jax_native.tuple_root(heights, hashes)


def layouts():
    """Block layouts: chained multi-block messages with an empty one, a
    tuple-tree plan (sha_claims' messages of a 5-leaf tree), and chains
    that start and stop between blocks."""
    rng = np.random.default_rng(3)
    heights = list(range(100, 105))
    hashes = [rng.bytes(32) for _ in heights]
    tree_msgs, _ = sha_claims.tuple_tree_messages(heights, hashes)
    mixed_blocks = [rng.bytes(64) for _ in range(12)]
    mixed_chain = (False, True, True, False, False, True, False, True, True, True, False, True)
    return {
        "chained with an empty message": sha_air.plan_blocks([b"abc", b"x" * 200, b"", b"blobstream" * 20]),
        "tuple tree, 5 leaves": sha_air.plan_blocks(tree_msgs),
        "random blocks, mixed chaining": (mixed_chain, mixed_blocks),
    }


LAYOUTS = layouts()


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sha_trace_fill_matches_jax_and_numpy(name):
    chain, blocks = LAYOUTS[name]
    trace, aux = native.sha_trace_fill(chain, blocks)
    j_trace, j_aux = jax_sha_air.build_sha_trace(chain, blocks)  # the JAX package's C builder
    n_trace, n_aux = sha_air._build_sha_trace_numpy(chain, blocks)
    assert trace.dtype == np.uint64 and trace.shape == (64 * len(blocks), sha_air.N_COLS)
    assert np.array_equal(trace, j_trace) and np.array_equal(trace, n_trace)
    assert aux == j_aux == n_aux
    m_trace, m_aux = sha_air.build_sha_trace(chain, blocks)
    assert np.array_equal(m_trace, trace) and m_aux == aux


def test_empty_layout():
    trace, aux = native.sha_trace_fill((), [])
    assert trace.shape == (0, sha_air.N_COLS) and aux == []


def test_build_raises_with_the_compiler_output(tmp_path):
    src = tmp_path / "bsx_sha256.c"
    shutil.copy(native.SOURCE, src)
    src.write_text(src.read_text() + "\nint bsx_broken(void) { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build(src, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*.so")), "a failed build left a library behind"
    shutil.copy(native.SOURCE, src)
    built = native.build(src, tmp_path / "out")
    assert built.exists() and built.name == native.lib_path().name


def test_wrappers_reject_mismatched_buffers():
    with pytest.raises(ValueError):
        native.sha_trace_fill((False,), [bytes(63)])
    with pytest.raises(ValueError):
        native.sha_trace_fill((False, True), [bytes(64)])
    with pytest.raises(ValueError):
        native.tuple_root([1, 2], [bytes(32)])
    with pytest.raises(ValueError):
        native.sha256_many([b"a", b"bc"])


def test_first_calls_from_many_threads():
    """A fresh process whose first calls come from eight threads at once
    loads the library once, and every digest is right (the SHA constants
    are filled when the library loads, not at a first call)."""
    code = """
import hashlib
from concurrent.futures import ThreadPoolExecutor
from blobstreamx_tpu_torch import native
msgs = [bytes([i]) * (37 * i) for i in range(64)]
with ThreadPoolExecutor(8) as pool:
    got = list(pool.map(native.sha256, msgs))
assert got == [hashlib.sha256(m).digest() for m in msgs]
assert native.loaded_path() == str(native.lib_path())
"""
    subprocess.run([sys.executable, "-c", code], check=True, cwd=Path(__file__).resolve().parents[1])
