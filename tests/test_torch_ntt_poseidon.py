"""Port NTT, Poseidon and Merkle ops (blobstreamx_tpu_torch.ops) vs the JAX
package — its jnp functions and its Pallas kernels in interpret mode — and
the golden models, on the CPU, with exact equality. On CPU tensors the port's
ntt_cols and permute run their plain versions, the code the CUDA kernels are
held against on the card."""

import jax
import numpy as np
import pytest
import torch

from blobstreamx_tpu.fields import gf64 as jgf
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


@pytest.mark.parametrize("n,c,inverse", [(8, 3, False), (32, 8, True), (64, 8, False), (256, 2, True)])
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
