"""The port's four-step NTT, its twiddle table and twiddle-transpose, the
base-field FRI fold and the FRI prover (blobstreamx_tpu_torch.ops.ntt /
ops.fri) against the JAX package, on the CPU, with exact equality. On CPU
tensors the port runs its plain versions, the code the CUDA kernels are held
against on the card.

The FRI proof is held against the JAX package's golden prover: its device
prover compiles every Poseidon shape eagerly (about 100 s on the CPU), and
tests/test_fri_ops.py holds the two equal on the same codeword size and
configuration. The codeword both provers take is the JAX package's golden
low-degree extension."""

import copy

import jax
import numpy as np
import pytest
import torch

from blobstreamx_tpu.fields import gf64 as jgf
from blobstreamx_tpu.golden import fri as jgold_fri, ntt as jgold_ntt
from blobstreamx_tpu.golden.challenger import Challenger as JChallenger
from blobstreamx_tpu.ops import fri as jfri, ntt as jntt
from blobstreamx_tpu_torch.fields import gf64 as tgf
from blobstreamx_tpu_torch.golden import fri as tgold_fri, goldilocks as gold, ntt as gntt
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.ops import fri as tfri, ntt as tntt

torch.set_num_threads(1)
P = gold.P


def gl_vector(seed: int, shape) -> np.ndarray:
    """Canonical values with the edges near 0, 2^32 and p first."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=shape, dtype=np.uint64)
    edges = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, P - (1 << 32), (1 << 63)], np.uint64)
    flat = v.reshape(-1)
    flat[: len(edges)] = edges[: flat.size]
    return v


_jax_four_step = jax.jit(jntt.ntt_four_step, static_argnums=1)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 2, 5, 8, 11])
def test_ntt_four_step_matches_jax(log_n, inverse):
    x = gl_vector(100 + log_n, (1 << log_n,))
    got = tgf.to_u64(tntt.ntt_four_step(tgf.from_u64(x), inverse))
    want = jgf.to_u64(_jax_four_step(jgf.from_u64(x), inverse))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tgf.to_u64(tntt.ntt_four_step_plain(tgf.from_u64(x), inverse)), want)


def test_ntt_four_step_matches_pallas_interpret_and_golden():
    x = gl_vector(7, (1 << 6,))
    got = tgf.to_u64(tntt.ntt_four_step(tgf.from_u64(x)))
    want = jgf.to_u64(jntt.ntt_four_step_pallas(jgf.from_u64(x), interpret=True))
    np.testing.assert_array_equal(got, want)
    assert [int(v) for v in got] == gntt.ntt([int(v) for v in x])
    back = tntt.ntt_four_step(tgf.from_u64(got), inverse=True)
    np.testing.assert_array_equal(tgf.to_u64(back), x)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [2, 5, 8, 11])
def test_four_step_twiddles_match_jax(log_n, inverse):
    np.testing.assert_array_equal(
        tntt.four_step_twiddles(log_n, inverse), jntt._four_step_twiddles(log_n, inverse)
    )


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1,n2", [(4, 8), (8, 8)])
def test_twiddle_transpose_plain_matches_jax(n1, n2, inverse):
    log_n = (n1 * n2).bit_length() - 1
    mat = gl_vector(n1 + n2, (n1, n2))
    jm = jgf.gl_mul(jgf.from_u64(mat), jgf.from_u64(jntt._four_step_twiddles(log_n, inverse)))
    want = jgf.to_u64((jm[0].T, jm[1].T))
    got = tgf.to_u64(tntt.twiddle_transpose(tgf.from_u64(mat), log_n, inverse))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        tntt.twiddle_transpose(tgf.from_u64(mat.reshape(n1 * 2, n2 // 2)), log_n, inverse)


@pytest.mark.parametrize("shift", [gold.COSET_SHIFT, 1])
@pytest.mark.parametrize("log_n", [4, 8])
def test_fold_codeword_matches_jax(log_n, shift):
    evals = gl_vector(200 + log_n, (1 << log_n,))
    beta = int(np.random.default_rng(log_n).integers(0, P, dtype=np.uint64))
    got = tgf.to_u64(tfri.fold_codeword(tgf.from_u64(evals), beta, shift))
    want = jgf.to_u64(jfri.fold_codeword(jgf.from_u64(evals), beta, shift))
    np.testing.assert_array_equal(got, want)


CFG = dict(rate_bits=2, cap_height=1, num_query_rounds=10, proof_of_work_bits=5, final_poly_len=8)


def _layers(proof):
    return [[(layer.pair, layer.path) for layer in q.layers] for q in proof.query_rounds]


def test_fri_prove_matches_jax_and_verifies():
    rng = np.random.default_rng(9)
    coeffs = rng.integers(0, P, size=(1 << 5,), dtype=np.uint64)
    # the codeword comes from the JAX package, so neither side depends on the port's NTT
    evals = jgold_ntt.lde([int(v) for v in coeffs], CFG["rate_bits"], gold.COSET_SHIFT)
    cfg = tgold_fri.FriConfig(**CFG)
    got = tfri.fri_prove(tgf.from_u64(np.array(evals, dtype=np.uint64)), cfg, Challenger())
    want = jgold_fri.fri_prove(evals, jgold_fri.FriConfig(**CFG), JChallenger(), gold.COSET_SHIFT)
    assert got.caps == want.caps
    assert got.betas == want.betas
    assert got.final_poly == want.final_poly
    assert got.pow_nonce == want.pow_nonce
    assert _layers(got) == _layers(want)
    assert tgold_fri.fri_verify(got, len(evals), cfg, Challenger(), gold.COSET_SHIFT)
    bad = copy.deepcopy(got)
    bad.query_rounds[0].layers[0].pair = (123, 456)
    assert not tgold_fri.fri_verify(bad, len(evals), cfg, Challenger(), gold.COSET_SHIFT)
