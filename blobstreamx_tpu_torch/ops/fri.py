"""Base-field FRI on the device, and the helpers the extension-field prover
(prover/fri_ext.py) shares.

- ``fold_codeword``: the arity-2 fold, elementwise on the input's device,
  with the 1/x_i factors from the cached ``_xinv_table``;
- ``grind``: the proof-of-work nonce search, batched on the device (2^14
  forked challenger states per Poseidon batch), returning the same first
  nonce the sequential golden grind finds;
- ``fri_prove``: the commit and query phases. Codewords and Merkle layers
  stay on the device; the Fiat-Shamir transcript (tiny, sequential) runs on
  the host golden challenger, so proofs are bit-identical to the golden
  prover and verify with golden.fri.fri_verify.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from blobstreamx_tpu_torch.device import resolve
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl, gl_add, gl_mul, gl_sub
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.golden.fri import FriConfig, FriLayerProof, FriProof, FriQueryRound
from blobstreamx_tpu_torch.golden.poseidon import RATE, WIDTH
from blobstreamx_tpu_torch.ops import merkle as merkle_ops, ntt as ntt_ops, poseidon as pos

P = gold.P
INV2 = gold.inv(2)


@lru_cache(maxsize=None)
def _xinv_table(log_n: int, shift: int) -> np.ndarray:
    """(shift * w^i)^-1 for i < n/2, as uint64."""
    inv_pow = ntt_ops.power_table(log_n, inverse=True)  # w^-i, i < n/2
    si = gold.inv(shift)
    return np.array([(int(v) * si) % P for v in inv_pow], dtype=np.uint64)


@lru_cache(maxsize=None)
def fold_tables(log_n: int, shift: int, device: str) -> tuple[Gl, Gl]:
    """(1/2, 1/x_i) for the fold of a length-2^log_n codeword on shift*<w>,
    as (n/2,) Gl tensors on `device`."""
    half = 1 << (log_n - 1)
    return gf64.full((half,), INV2, device), gf64.from_u64(_xinv_table(log_n, shift), device)


def fold_codeword(evals: Gl, beta: int, shift: int) -> Gl:
    """One arity-2 fold: (n,) on shift*<w>  ->  (n/2,) on shift^2*<w^2>."""
    n = evals[0].shape[0]
    half = n // 2
    fe = (evals[0][:half], evals[1][:half])
    fo = (evals[0][half:], evals[1][half:])
    inv2, xinv = fold_tables(n.bit_length() - 1, shift, str(evals[0].device))
    even = gl_mul(gl_add(fe, fo), inv2)
    odd = gl_mul(gl_mul(gl_sub(fe, fo), inv2), xinv)
    return gl_add(even, gl_mul(gf64.full((), beta, evals[0].device), odd))


# ----------------------------------------------------------------------------
# proof-of-work grind
# ----------------------------------------------------------------------------


def _grind_batch(state12: list[int], pending: list[int], start: int, batch: int, device):
    """Poseidon-permute `batch` forked challenger states with nonces
    start..start+batch-1 and return the sampled values' high words."""
    vals = np.zeros((WIDTH, batch), dtype=np.uint64)
    for i, v in enumerate(state12):
        vals[i, :] = v
    for i, v in enumerate(pending):
        vals[i, :] = v
    vals[len(pending), :] = np.arange(start, start + batch, dtype=np.uint64)
    out = pos.permute(gf64.from_u64(vals, device))
    # golden sample() pops output_buffer[-1] == state[RATE-1]
    return out[1][RATE - 1]


def grind(
    challenger: Challenger,
    bits: int,
    device=None,
    batch: int = 1 << 14,
    max_batches: int = 1 << 12,
) -> int:
    """First nonce n>=0 such that fork(observe(n); sample()) has `bits`
    leading zero bits. Bit-identical to golden.fri.grind, but evaluates
    nonce batches in one device permutation call, on the card unless
    `device` names the CPU.

    Requires len(pending inputs) <= RATE-1 (true for our transcripts; the
    grind follows observe_many(final_poly) which flushes in RATE chunks)."""
    assert 0 < bits <= 32
    device = resolve(device)
    pending = list(challenger.input_buffer)
    assert len(pending) < RATE
    state = list(challenger.state)
    bound = 1 << (32 - bits)
    for b in range(max_batches):
        start = b * batch
        hi = _grind_batch(state, pending, start, batch, device)
        ok = (hi < bound).nonzero()
        if ok.numel():
            return start + int(ok[0, 0])
    raise RuntimeError("grind exhausted max_batches")


# ----------------------------------------------------------------------------
# full prover
# ----------------------------------------------------------------------------


def _pair_leaves(evals: Gl) -> Gl:
    """(2, n/2) leaf matrix: column i is the pair (evals[i], evals[i + n/2])."""
    half = evals[0].shape[0] // 2
    return (
        torch.stack([evals[0][:half], evals[0][half:]]),
        torch.stack([evals[1][:half], evals[1][half:]]),
    )


def fri_prove(
    evals: Gl, config: FriConfig, challenger: Challenger, shift: int = gold.COSET_SHIFT
) -> FriProof:
    """FRI prover for a (n,) codeword on shift*<w>, on the device that holds
    it; the proof verifies with golden.fri.fri_verify."""
    n = evals[0].shape[0]
    assert n & (n - 1) == 0
    codewords = [evals]
    trees: list[merkle_ops.PoseidonTree] = []
    betas = []
    cur_shift = shift % P
    size = n
    while size > config.final_poly_len:
        ch = min(config.cap_height, (size // 2 - 1).bit_length())
        tree = merkle_ops.build_tree(_pair_leaves(codewords[-1]), ch)
        trees.append(tree)
        for digest in merkle_ops.cap_to_ints(tree):
            challenger.observe_many(digest)
        beta = challenger.sample()
        betas.append(beta)
        codewords.append(fold_codeword(codewords[-1], beta, cur_shift))
        cur_shift = (cur_shift * cur_shift) % P
        size //= 2

    final_cw = codewords[-1]
    final_coeffs = ntt_ops.coset_intt_cols((final_cw[0][:, None], final_cw[1][:, None]), cur_shift)
    final_np = gf64.to_u64((final_coeffs[0][:, 0], final_coeffs[1][:, 0]))
    final_poly = [int(v) for v in final_np[: config.final_poly_len >> config.rate_bits]]
    challenger.observe_many(final_poly)

    pow_nonce = grind(challenger, config.proof_of_work_bits, evals[0].device)
    challenger.observe(pow_nonce)
    assert challenger.sample() >> (64 - config.proof_of_work_bits) == 0

    indices = challenger.sample_indices(config.num_query_rounds, n // 2)
    host_cw = [gf64.to_u64(cw) for cw in codewords[:-1]]
    query_rounds = []
    for idx in indices:
        layers = []
        i = idx
        for ell, cw in enumerate(host_cw):
            half = cw.shape[0] // 2
            i %= half
            path, _ = trees[ell].path(i)
            layers.append(FriLayerProof(pair=(int(cw[i]), int(cw[i + half])), path=path))
        query_rounds.append(FriQueryRound(layers=layers))

    return FriProof(
        caps=[merkle_ops.cap_to_ints(t) for t in trees],
        final_poly=final_poly,
        pow_nonce=pow_nonce,
        query_rounds=query_rounds,
        betas=betas,
    )
