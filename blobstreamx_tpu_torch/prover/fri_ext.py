"""FRI over the quadratic extension GF(p^2) — the DEEP polynomial's codeword.

An ext codeword is a pair (c0, c1) of Gl tensors over the BASE coset domain
(domain points stay base-field through every fold, so the 1/x_i tables are
the base FRI's). A pair-leaf commits 4 field elements [e.c0, e.c1, o.c0,
o.c1]; fold challenges beta are ext.

Transcript convention: an ext element is observed/sampled as (c0, c1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import gl_add, gl_mul, gl_sub
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.golden.fri import FriConfig
from blobstreamx_tpu_torch.ops import fri as fri_ops, merkle as merkle_ops, ntt as ntt_ops

P = gold.P
INV2 = gold.inv(2)


@dataclass
class FriExtLayerProof:
    pair: tuple[tuple[int, int], tuple[int, int]]  # (f(x), f(-x)) as ext pairs
    path: list[list[int]]


@dataclass
class FriExtQueryRound:
    layers: list[FriExtLayerProof]


@dataclass
class FriExtProof:
    caps: list[list[list[int]]]
    final_poly: list[tuple[int, int]]  # ext coefficients
    pow_nonce: int
    query_rounds: list[FriExtQueryRound]


def fold_codeword_ext(evals, beta, shift: int):
    """One arity-2 fold of an ext codeword on the base coset shift*<w>.
    beta: ext scalar of shape (1,) (or any broadcastable ext tensor)."""
    n = evals[0][0].shape[0]
    log_n = n.bit_length() - 1
    half = n // 2
    fe = tuple((c[0][:half], c[1][:half]) for c in (evals[0], evals[1]))
    fo = tuple((c[0][half:], c[1][half:]) for c in (evals[0], evals[1]))
    # component-wise: even = (fe+fo)/2; odd = (fe-fo)/(2x)
    inv2, xinv = fri_ops.fold_tables(log_n, shift, str(evals[0][0].device))
    even = tuple(gl_mul(gl_add(e, o), inv2) for e, o in zip(fe, fo))
    odd = tuple(gl_mul(gl_mul(gl_sub(e, o), inv2), xinv) for e, o in zip(fe, fo))
    return gf64.ext_add(even, gf64.ext_mul(odd, beta))


def _pair_leaves_ext(evals):
    """(4, n/2) leaf matrix [e.c0, e.c1, o.c0, o.c1] per column."""
    half = evals[0][0].shape[0] // 2
    lo = torch.stack(
        [evals[0][0][:half], evals[1][0][:half], evals[0][0][half:], evals[1][0][half:]]
    )
    hi = torch.stack(
        [evals[0][1][:half], evals[1][1][:half], evals[0][1][half:], evals[1][1][half:]]
    )
    return lo, hi


def _observe_ext(challenger: Challenger, v: tuple[int, int]) -> None:
    challenger.observe(v[0])
    challenger.observe(v[1])


def fri_prove_ext(evals, config: FriConfig, challenger: Challenger, shift: int = gold.COSET_SHIFT):
    """Device ext-FRI prover. evals: ext pair of (n,) Gl tensors on
    shift*<w>, on the device that runs the prover.

    Returns (proof, query indices) — the caller (the STARK prover) extracts
    layer-0 openings for its own transcript at those indices.
    """
    n = evals[0][0].shape[0]
    assert n & (n - 1) == 0
    device = evals[0][0].device
    codewords = [evals]
    trees: list[merkle_ops.PoseidonTree] = []
    cur_shift = shift % P
    size = n
    while size > config.final_poly_len:
        ch = min(config.cap_height, (size // 2 - 1).bit_length())
        cur = codewords[-1]
        tree = merkle_ops.PoseidonTree(
            layers=list(merkle_ops.tree_layers(_pair_leaves_ext(cur), ch)), cap_height=ch
        )
        trees.append(tree)
        for digest in merkle_ops.cap_to_ints(tree):
            challenger.observe_many(digest)
        beta = challenger.sample_ext()
        beta_d = (gf64.full((1,), beta[0], device), gf64.full((1,), beta[1], device))
        codewords.append(fold_codeword_ext(cur, beta_d, cur_shift))
        cur_shift = (cur_shift * cur_shift) % P
        size //= 2

    final_cw = codewords[-1]
    fc0 = ntt_ops.coset_intt_cols((final_cw[0][0][:, None], final_cw[0][1][:, None]), cur_shift)
    fc1 = ntt_ops.coset_intt_cols((final_cw[1][0][:, None], final_cw[1][1][:, None]), cur_shift)
    n_final = config.final_poly_len >> config.rate_bits
    c0 = gf64.to_u64((fc0[0][:, 0], fc0[1][:, 0]))[:n_final]
    c1 = gf64.to_u64((fc1[0][:, 0], fc1[1][:, 0]))[:n_final]
    final_poly = [(int(a), int(b)) for a, b in zip(c0, c1)]
    for v in final_poly:
        _observe_ext(challenger, v)

    pow_nonce = fri_ops.grind(challenger, config.proof_of_work_bits, device)
    challenger.observe(pow_nonce)
    assert challenger.sample() >> (64 - config.proof_of_work_bits) == 0

    indices = challenger.sample_indices(config.num_query_rounds, n // 2)
    host_cw = [(gf64.to_u64(cw[0]), gf64.to_u64(cw[1])) for cw in codewords[:-1]]
    query_rounds = []
    for idx in indices:
        layers = []
        i = idx
        for ell, (c0h, c1h) in enumerate(host_cw):
            half = c0h.shape[0] // 2
            i %= half
            path, _ = trees[ell].path(i)
            pair = (
                (int(c0h[i]), int(c1h[i])),
                (int(c0h[i + half]), int(c1h[i + half])),
            )
            layers.append(FriExtLayerProof(pair=pair, path=path))
        query_rounds.append(FriExtQueryRound(layers=layers))

    proof = FriExtProof(
        caps=[merkle_ops.cap_to_ints(t) for t in trees],
        final_poly=final_poly,
        pow_nonce=pow_nonce,
        query_rounds=query_rounds,
    )
    return proof, indices


def fri_verify_ext(
    proof: FriExtProof,
    n: int,
    config: FriConfig,
    challenger: Challenger,
    shift: int,
    layer0_check=None,
) -> bool:
    """Host ext-FRI verifier (pure python ints).

    layer0_check(idx, pair) -> bool lets the STARK verifier confirm the
    queried layer-0 values against its own DEEP recomputation.
    """
    from blobstreamx_tpu_torch.golden.merkle import poseidon_verify_path

    ext_add, ext_sub, ext_mul, ext_inv = (
        gold.ext_add,
        gold.ext_sub,
        gold.ext_mul,
        gold.ext_inv,
    )

    num_layers = len(proof.caps)
    betas, sizes, shifts = [], [], []
    size, cur_shift = n, shift % P
    for ell in range(num_layers):
        sizes.append(size)
        shifts.append(cur_shift)
        for digest in proof.caps[ell]:
            challenger.observe_many(digest)
        betas.append(challenger.sample_ext())
        size //= 2
        cur_shift = (cur_shift * cur_shift) % P
    if size != config.final_poly_len:
        return False
    if len(proof.final_poly) != config.final_poly_len >> config.rate_bits:
        return False
    for v in proof.final_poly:
        _observe_ext(challenger, v)
    challenger.observe(proof.pow_nonce)
    if challenger.sample() >> (64 - config.proof_of_work_bits) != 0:
        return False

    indices = challenger.sample_indices(config.num_query_rounds, n // 2)
    inv2 = (INV2, 0)
    for idx, qround in zip(indices, proof.query_rounds):
        if len(qround.layers) != num_layers:
            return False
        pos = idx
        expect = None
        for ell in range(num_layers):
            half = sizes[ell] // 2
            i = pos % half
            layer = qround.layers[ell]
            fe, fo = layer.pair
            if ell == 0 and layer0_check is not None:
                if not layer0_check(i, (fe, fo)):
                    return False
            if expect is not None:
                value_at_pos = fe if pos < half else fo
                if value_at_pos != expect:
                    return False
            leaf = [fe[0], fe[1], fo[0], fo[1]]
            if not poseidon_verify_path(proof.caps[ell], leaf, i, layer.path):
                return False
            x_i = gold.mul(shifts[ell], pow(gold.root_of_unity(sizes[ell].bit_length() - 1), i, P))
            even = ext_mul(ext_add(fe, fo), inv2)
            odd = ext_mul(ext_mul(ext_sub(fe, fo), inv2), (gold.inv(x_i), 0))
            expect = ext_add(even, ext_mul(betas[ell], odd))
            pos = i
        # final polynomial evaluation (ext Horner at the base domain point)
        final_shift = gold.mul(shifts[-1], shifts[-1]) if num_layers else shift % P
        log_f = config.final_poly_len.bit_length() - 1
        x = gold.mul(final_shift, pow(gold.root_of_unity(log_f), pos, P))
        val = (0, 0)
        for coeff in reversed(proof.final_poly):
            val = ext_add(ext_mul(val, (x, 0)), coeff)
        if expect is not None and val != expect:
            return False
    return True
