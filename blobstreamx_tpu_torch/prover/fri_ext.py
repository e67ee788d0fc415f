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
    half = n // 2
    fe = tuple((c[0][:half], c[1][:half]) for c in (evals[0], evals[1]))
    fo = tuple((c[0][half:], c[1][half:]) for c in (evals[0], evals[1]))
    return _fold_pairs(fe, fo, beta, n.bit_length() - 1, shift, 0, half)


def _fold_pairs(fe, fo, beta, log_n: int, shift: int, a: int, b: int):
    """The fold of the pairs [a, b) of a length-2^log_n ext codeword: fe and
    fo are its values at x_i and -x_i, i in [a, b)."""
    # component-wise: even = (fe+fo)/2; odd = (fe-fo)/(2x)
    inv2, xinv = fri_ops.fold_tables(log_n, shift, str(fe[0][0].device))
    inv2 = (inv2[0][a:b], inv2[1][a:b])
    xinv = (xinv[0][a:b], xinv[1][a:b])
    even = tuple(gl_mul(gl_add(e, o), inv2) for e, o in zip(fe, fo))
    odd = tuple(gl_mul(gl_mul(gl_sub(e, o), inv2), xinv) for e, o in zip(fe, fo))
    return gf64.ext_add(even, gf64.ext_mul(odd, beta))


def _flat(cw):
    """Ext codeword -> (rows, 4) int64: [c0.lo, c0.hi, c1.lo, c1.hi]."""
    return torch.stack([cw[0][0], cw[0][1], cw[1][0], cw[1][1]], dim=1)


def _unflat(x):
    return (x[:, 0], x[:, 1]), (x[:, 2], x[:, 3])


def _pair_layout(cw_rows, size: int, mesh):
    """A row-sharded ext codeword (rank t holds rows [t*size/D, (t+1)*size/D))
    -> this rank's pairs in the pair layout: (fe, fo), the values at
    x_i and -x_i for i in [r*h/D, (r+1)*h/D), h = size/2 (one all-to-all)."""
    from blobstreamx_tpu_torch.parallel.mesh import reshard_rows

    d = mesh.size
    m, q, h = size // d, size // 2 // d, size // 2
    src = [(t * m, (t + 1) * m) for t in range(d)]
    want = [[(s * q, (s + 1) * q), (h + s * q, h + (s + 1) * q)] for s in range(d)]
    fe, fo = reshard_rows(_flat(cw_rows), src, want, mesh)
    return _unflat(fe), _unflat(fo)


def _natural_layout(cw_rows, mesh):
    """A row-sharded ext codeword -> the whole codeword on every rank."""
    return _unflat(torch.cat(mesh.all_gather(_flat(cw_rows))))


def _layer_fns_mesh(size: int, cap_height: int, shift: int, mesh):
    """(commit, fold, cap height) of one FRI layer over the mesh, in the pair
    layout: a rank holds the pairs (x_i, -x_i) of its slice of i, so the
    pair-leaf hashing and the fold read only its own columns. The fold's
    output is the next codeword's rows [r*h/D, (r+1)*h/D): row-sharded, so
    the one collective of a layer is the next layer's re-pairing."""
    from blobstreamx_tpu_torch.parallel.merkle import poseidon_tree_sharded

    half = size // 2
    q = half // mesh.size
    ch = min(cap_height, (half - 1).bit_length())

    def commit(fe, fo):
        leaves = (
            torch.stack([fe[0][0], fe[1][0], fo[0][0], fo[1][0]]),
            torch.stack([fe[0][1], fe[1][1], fo[0][1], fo[1][1]]),
        )
        return poseidon_tree_sharded(leaves, mesh, ch)

    def fold(fe, fo, beta):
        a = mesh.rank * q
        return _fold_pairs(fe, fo, beta, size.bit_length() - 1, shift, a, a + q)

    return commit, fold, ch


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


def fri_prove_ext(evals, config: FriConfig, challenger: Challenger, shift: int = gold.COSET_SHIFT, mesh=None):
    """Device ext-FRI prover. evals: ext pair of (n,) Gl tensors on
    shift*<w>, on the device that runs the prover.

    mesh: evals is this rank's rows [r*n/D, (r+1)*n/D) of the codeword; each
    layer with (size/2) % D == 0 and size/2 >= 2D runs in the pair layout
    (_layer_fns_mesh), the smaller ones on the gathered codeword on every
    rank. The proof is the single-device one, the same on every rank.

    Returns (proof, query indices) — the caller (the STARK prover) extracts
    layer-0 openings for its own transcript at those indices.
    """
    n = evals[0][0].shape[0] * (1 if mesh is None else mesh.size)
    assert n & (n - 1) == 0
    device = evals[0][0].device
    # per layer: (tree, the pair values) — ("mesh", fe, fo) or ("whole", codeword)
    layers = []
    cur = evals
    sharded = mesh is not None  # cur is row-sharded
    cur_shift = shift % P
    size = n
    while size > config.final_poly_len:
        use_mesh = mesh is not None and (size // 2) % mesh.size == 0 and size // 2 >= 2 * mesh.size
        if use_mesh:
            commit, fold, ch = _layer_fns_mesh(size, config.cap_height, cur_shift, mesh)
            fe, fo = _pair_layout(cur, size, mesh)
            tree = commit(fe, fo)
        else:
            if sharded:  # the layer is too small for the mesh: every rank takes the whole codeword
                cur = _natural_layout(cur, mesh)
                sharded = False
            ch = min(config.cap_height, (size // 2 - 1).bit_length())
            tree = merkle_ops.PoseidonTree(
                layers=list(merkle_ops.tree_layers(_pair_leaves_ext(cur), ch)), cap_height=ch
            )
        for digest in merkle_ops.cap_to_ints(tree):
            challenger.observe_many(digest)
        beta = challenger.sample_ext()
        beta_d = (gf64.full((1,), beta[0], device), gf64.full((1,), beta[1], device))
        if use_mesh:
            layers.append((tree, ("mesh", fe, fo)))
            cur = fold(fe, fo, beta_d)
        else:
            layers.append((tree, ("whole", cur)))
            cur = fold_codeword_ext(cur, beta_d, cur_shift)
        cur_shift = (cur_shift * cur_shift) % P
        size //= 2

    final_cw = _natural_layout(cur, mesh) if sharded else cur
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
    # layer ell's pair for a query: (f(x_i), f(-x_i)) and the path of leaf i;
    # in the pair layout the rank that holds pair i answers, and every rank
    # receives the answers
    host = []
    for tree, held in layers:
        if held[0] == "whole":
            host.append((gf64.to_u64(held[1][0]), gf64.to_u64(held[1][1])))
        else:
            host.append(tuple((gf64.to_u64(c[0]), gf64.to_u64(c[1])) for c in held[1:]))
    answers = {}
    size = n
    for ell, (tree, held) in enumerate(layers):
        half = size // 2
        for idx in indices:
            i = idx % half
            if held[0] == "whole":
                c0h, c1h = host[ell]
                pair = ((int(c0h[i]), int(c1h[i])), (int(c0h[i + half]), int(c1h[i + half])))
            elif tree.owner(i) == mesh.rank:
                (e0, e1), (o0, o1) = host[ell]
                j = i - mesh.rank * (half // mesh.size)
                pair = ((int(e0[j]), int(e1[j])), (int(o0[j]), int(o1[j])))
            else:
                continue
            answers[(ell, i)] = FriExtLayerProof(pair=pair, path=tree.path(i)[0])
        size //= 2
    if mesh is not None:
        for part in mesh.all_gather_object(answers):
            answers.update(part)
    query_rounds = []
    for idx in indices:
        rounds = []
        size = n
        for ell in range(len(layers)):
            size //= 2
            rounds.append(answers[(ell, idx % size)])
        query_rounds.append(FriExtQueryRound(layers=rounds))

    proof = FriExtProof(
        caps=[merkle_ops.cap_to_ints(t) for t, _ in layers],
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
