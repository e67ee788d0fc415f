"""Port NTT, Poseidon and Merkle ops (blobstreamx_tpu_torch.ops) vs the JAX
package — its jnp functions and its Pallas kernels in interpret mode — and
the golden models, on the CPU, with exact equality. On CPU tensors the port's
ntt_cols and permute run their plain versions, the code the CUDA kernels are
held against on the card."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from blobstreamx_tpu.fields import gf64 as jgf
from blobstreamx_tpu.golden import poseidon as jgold_pos
from blobstreamx_tpu.ops import ntt as jntt, poseidon as jpos
from blobstreamx_tpu_torch.fields import gf64 as tgf
from blobstreamx_tpu_torch.golden import merkle as gmerkle, ntt as gntt, poseidon as gpos
from blobstreamx_tpu_torch.ops import merkle as tmerkle, ntt as tntt, poseidon as tpos

torch.set_num_threads(1)
P = gpos.P


def gl_matrix(seed: int, shape) -> np.ndarray:
    """Canonical values with the edges near 0, 2^32 and p in the first rows."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=shape, dtype=np.uint64)
    edges = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, P - (1 << 32), (1 << 63)], np.uint64)
    flat = v.reshape(-1)
    flat[: len(edges)] = edges[: flat.size]
    return v


def port(x, *args, fn):
    return tgf.to_u64(fn(tgf.from_u64(x), *args))


def ref(x, *args, fn):
    return jgf.to_u64(fn(jgf.from_u64(x), *args))


@pytest.mark.parametrize("n,c,inverse", [(8, 3, False), (32, 8, True), (64, 8, False), (256, 2, True),
                                         (1 << 15, 3, False)])  # above the tile kernel's 2^14
def test_ntt_cols_matches_jax(n, c, inverse):
    x = gl_matrix(n + c, (n, c))
    got = port(x, inverse, fn=tntt.ntt_cols)
    np.testing.assert_array_equal(got, ref(x, inverse, fn=jax.jit(jntt.ntt_cols, static_argnums=1)))


def test_ntt_cols_golden_roundtrip():
    x = gl_matrix(3, (16, 2))
    fwd = port(x, False, fn=tntt.ntt_cols)
    for j in range(2):
        assert [int(v) for v in fwd[:, j]] == gntt.ntt([int(v) for v in x[:, j]])
    np.testing.assert_array_equal(port(fwd, True, fn=tntt.ntt_cols), x)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("kernel", ["ntt_cols_pallas", "ntt_cols_pallas_split"])
def test_ntt_cols_matches_pallas_interpret(kernel, inverse):
    x = gl_matrix(5, (16, 8))
    want = jgf.to_u64(getattr(jntt, kernel)(jgf.from_u64(x), inverse=inverse, interpret=True))
    np.testing.assert_array_equal(port(x, inverse, fn=tntt.ntt_cols), want)


def test_coset_ntt_and_intt_match_jax():
    x = gl_matrix(6, (16, 4))
    np.testing.assert_array_equal(
        port(x, fn=tntt.coset_ntt_cols), ref(x, fn=jax.jit(jntt.coset_ntt_cols))
    )
    np.testing.assert_array_equal(
        port(x, fn=tntt.coset_intt_cols), ref(x, fn=jax.jit(jntt.coset_intt_cols))
    )


@pytest.mark.parametrize("rate_bits", [2, 3])
def test_lde_cols_matches_jax(rate_bits):
    x = gl_matrix(7, (8, 3))
    lde = jax.jit(jntt.lde_cols, static_argnums=1)
    np.testing.assert_array_equal(port(x, rate_bits, fn=tntt.lde_cols), ref(x, rate_bits, fn=lde))


def test_power_and_bitrev_tables_match_jax():
    for log_n in (1, 5, 8):
        np.testing.assert_array_equal(tntt.power_table(log_n, True), jntt.power_table(log_n, True))
        np.testing.assert_array_equal(tntt.bitrev_indices(log_n), jntt.bitrev_indices(log_n))


# ----------------------------------------------------------------------------
# Poseidon
# ----------------------------------------------------------------------------


def test_permute_matches_jax():
    s = gl_matrix(8, (12, 16))
    np.testing.assert_array_equal(port(s, fn=tpos.permute), ref(s, fn=jax.jit(jpos.permute)))


def test_permute_matches_pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu

    s = gl_matrix(9, (12, 16))
    with pltpu.force_tpu_interpret_mode():
        want = jgf.to_u64(jpos.permute_pallas(jgf.from_u64(s), block_n=16))
    np.testing.assert_array_equal(port(s, fn=tpos.permute), want)


def test_permute_matches_golden():
    s = gl_matrix(10, (12, 6))
    got = port(s, fn=tpos.permute)
    for j in range(6):
        assert [int(v) for v in got[:, j]] == gpos.permute([int(v) for v in s[:, j]])


def _kernel_mds_row() -> tuple:
    """The circulant row that csrc/poseidon.cu's MDS multiplies by."""
    src = (Path(tpos.__file__).resolve().parent.parent / "csrc" / "poseidon.cu").read_text()
    return tuple(int(v) for v in re.search(r"const uint32_t C\[POS_WIDTH\] = \{([^}]*)\}", src).group(1).split(","))


def test_poseidon_kernel_mds_coefficients_match_jax():
    """The kernel's MDS coefficients are the JAX package's; the only diagonal
    entry is row 0's 8, which the kernel folds into that row's first
    coefficient; and a row's sum over 32-bit halves stays below 2^49, so
    the kernel's u64 accumulators never carry."""
    row = _kernel_mds_row()
    assert row == tuple(jgold_pos.MDS_CIRC)
    assert tuple(jgold_pos.MDS_DIAG) == (8,) + (0,) * 11
    assert (sum(row) + 8) * ((1 << 32) - 1) < 1 << 49


def _kernel_mds(state: list[int]) -> list[int]:
    """csrc/poseidon.cu's MDS in Python integers with u64 wraparound: per row
    a multiply-accumulate over the low and the high 32-bit halves, then one
    reduction of lo_sum + hi_sum * 2^32; inputs and outputs are any u64
    congruent mod p (the kernel keeps the state unreduced between rounds)."""
    m64, eps, row = (1 << 64) - 1, (1 << 32) - 1, _kernel_mds_row()
    out = []
    for r in range(12):
        coef = [row[0] + 8 if r == 0 and i == 0 else row[i] for i in range(12)]
        al = sum(c * (state[(i + r) % 12] & eps) for i, c in enumerate(coef))
        ah = sum(c * (state[(i + r) % 12] >> 32) for i, c in enumerate(coef))
        t = (al + (ah << 32)) & m64
        u = ((ah >> 32) + (t < al)) * eps
        v = (t + u) & m64
        out.append((v + eps) & m64 if v < u else v)
    return out


def test_poseidon_kernel_mds_arithmetic_matches_jax():
    rng = np.random.default_rng(15)
    states = [[(1 << 64) - 1] * 12, [P - 1] * 12, [P] * 12, [(1 << 32) - 1] * 12, [0] * 12]
    states += [[int(v) for v in rng.integers(0, 1 << 64, 12, dtype=np.uint64)] for _ in range(50)]
    for st in states:
        got = _kernel_mds(st)
        assert all(v < 1 << 64 for v in got)
        assert [v % P for v in got] == jgold_pos._mds([v % P for v in st])


def test_plain_mds_matches_golden_at_limb_edges():
    """The plain MDS (one float64 limb-matrix product) is exact: every limb
    at 0xFFFF (2^64 - 1, the largest column sums), P - 1, 2^32 - 1, 0 and
    random words give the golden model's MDS mod P."""
    rng = np.random.default_rng(16)
    states = [[(1 << 64) - 1] * 12, [P - 1] * 12, [(1 << 32) - 1] * 12, [0] * 12,
              [(1 << 64) - 1 if i % 2 else 0 for i in range(12)]]
    states += [[int(v) for v in rng.integers(0, 1 << 64, 12, dtype=np.uint64)] for _ in range(59)]
    words = np.array(states, dtype=np.uint64).T  # (12, 64)
    lo = torch.from_numpy((words & np.uint64(0xFFFFFFFF)).astype(np.int64))
    hi = torch.from_numpy((words >> np.uint64(32)).astype(np.int64))
    got = tgf.to_u64(tpos._mds((lo, hi)))
    for j, st in enumerate(states):
        assert [int(v) for v in got[:, j]] == gpos._mds([v % P for v in st]), j


@pytest.mark.parametrize("L", [1, 4, 8, 9, 20])
def test_hash_columns_matches_golden(L):
    cols = gl_matrix(11 + L, (L, 5))
    got = port(cols, fn=tpos.hash_columns)
    for j in range(5):
        assert [int(v) for v in got[:, j]] == gpos.hash_no_pad([int(x) for x in cols[:, j]])


def test_compress_pairs_matches_golden():
    l, r = gl_matrix(12, (4, 6)), gl_matrix(13, (4, 6))
    got = tgf.to_u64(tpos.compress_pairs(tgf.from_u64(l), tgf.from_u64(r)))
    for j in range(6):
        want = gpos.two_to_one([int(x) for x in l[:, j]], [int(x) for x in r[:, j]])
        assert [int(v) for v in got[:, j]] == want


@pytest.mark.parametrize("cap_height", [0, 1, 2])
def test_merkle_cap_and_paths_match_golden(cap_height):
    leaves = gl_matrix(14, (3, 16))
    tree = tmerkle.build_tree(tgf.from_u64(leaves), cap_height)
    leaf_lists = [[int(x) for x in leaves[:, j]] for j in range(16)]
    cap = gmerkle.poseidon_tree_cap(leaf_lists, cap_height)
    assert tmerkle.cap_to_ints(tree) == cap
    for idx in (0, 5, 15):
        path, _ = tree.path(idx)
        assert gmerkle.poseidon_verify_path(cap, leaf_lists[idx], idx, path)
