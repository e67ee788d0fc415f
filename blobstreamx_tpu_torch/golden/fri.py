"""Pure-Python golden model of the FRI low-degree proof (commit + query phases).

Defines the protocol the device prover (blobstreamx_tpu_torch.ops.fri /
blobstreamx_tpu_torch.prover.pipeline) implements; component C7 in SURVEY.md §2.2,
config 4 at BASELINE.json:10.

Protocol (arity-2 folding):
- The prover holds a codeword: evaluations of a polynomial of degree < N/2^rate
  on the coset ``shift * <w>`` of size N, in natural order (index i ↔ shift*w^i).
- Each round ℓ commits the codeword as a Poseidon tree whose leaf i is the PAIR
  (f(x_i), f(-x_i)) = (evals[i], evals[i + N/2]), so one query opens both fold
  inputs with one path. The fold challenge beta_ℓ is sampled after observing
  the layer's cap. Folded codeword: g(x^2) = (f(x)+f(-x))/2 + beta*(f(x)-f(-x))/(2x).
- Folding stops when the codeword has final_poly_len evaluations; its
  coefficients (an INTT of the last codeword, degree < final_poly_len/2^rate
  but sent in full) go into the proof in the clear.
- Proof-of-work: a nonce such that sampling after observing it yields
  proof_of_work_bits leading zero bits.
- Query phase: num_query_rounds indices; each opens the pair-leaf at every layer.
"""

from __future__ import annotations

from dataclasses import dataclass

from .challenger import Challenger
from .goldilocks import P, add, inv, mul, root_of_unity, sub
from .merkle import poseidon_merkle_path, poseidon_tree_cap, poseidon_verify_path
from .ntt import coset_intt, naive_evaluate


@dataclass(frozen=True)
class FriConfig:
    """Mirrors the role of upstream FriConfig (SURVEY.md §5.6)."""

    rate_bits: int = 3
    cap_height: int = 1
    num_query_rounds: int = 28
    proof_of_work_bits: int = 8
    final_poly_len: int = 8  # codeword length at which folding stops (>= 2^cap+1... >= pairs)


@dataclass
class FriLayerProof:
    pair: tuple[int, int]
    path: list[list[int]]


@dataclass
class FriQueryRound:
    layers: list[FriLayerProof]


@dataclass
class FriProof:
    caps: list[list[list[int]]]  # per layer: list of digests (the cap)
    final_poly: list[int]  # coefficients
    pow_nonce: int
    query_rounds: list[FriQueryRound]
    betas: list[int]  # recorded for testing convenience (re-derived by verifier)


def _domain_elements(log_n: int, shift: int) -> list[int]:
    w = root_of_unity(log_n)
    out, cur = [], shift % P
    for _ in range(1 << log_n):
        out.append(cur)
        cur = mul(cur, w)
    return out


def fold_codeword(evals: list[int], beta: int, shift: int) -> list[int]:
    """One arity-2 fold. evals on shift*<w> (size n) -> result on shift^2*<w^2>."""
    n = len(evals)
    half = n // 2
    log_n = n.bit_length() - 1
    xs = _domain_elements(log_n, shift)
    inv2 = inv(2)
    out = []
    for i in range(half):
        fe, fo = evals[i], evals[i + half]
        even = mul(add(fe, fo), inv2)
        odd = mul(mul(sub(fe, fo), inv2), inv(xs[i]))
        out.append(add(even, mul(beta, odd)))
    return out


def _leaves_of(evals: list[int]) -> list[list[int]]:
    half = len(evals) // 2
    return [[evals[i], evals[i + half]] for i in range(half)]


def fri_prove(
    evals: list[int], config: FriConfig, challenger: Challenger, shift: int
) -> FriProof:
    n = len(evals)
    assert n & (n - 1) == 0
    codewords = [list(evals)]
    caps, betas = [], []
    cur_shift = shift % P
    shifts = [cur_shift]
    while len(codewords[-1]) > config.final_poly_len:
        leaves = _leaves_of(codewords[-1])
        cap = poseidon_tree_cap(leaves, min(config.cap_height, (len(leaves) - 1).bit_length()))
        caps.append(cap)
        for digest in cap:
            challenger.observe_many(digest)
        beta = challenger.sample()
        betas.append(beta)
        codewords.append(fold_codeword(codewords[-1], beta, cur_shift))
        cur_shift = mul(cur_shift, cur_shift)
        shifts.append(cur_shift)

    # The final polynomial keeps the original rate: only final_poly_len/2^rate
    # coefficients are sent. For an honest low-degree input the truncated
    # coefficients are zero; for a cheating prover the verifier's final
    # evaluation check fails.
    final_codeword = codewords[-1]
    final_poly = coset_intt(final_codeword, cur_shift)[: config.final_poly_len >> config.rate_bits]
    challenger.observe_many(final_poly)

    # Proof-of-work grind: nonce whose post-observation sample has leading zeros.
    pow_nonce = grind(challenger, config.proof_of_work_bits)
    challenger.observe(pow_nonce)
    pow_sample = challenger.sample()
    assert pow_sample >> (64 - config.proof_of_work_bits) == 0

    indices = challenger.sample_indices(config.num_query_rounds, n // 2)
    query_rounds = []
    for idx in indices:
        layers = []
        i = idx
        for ell, cw in enumerate(codewords[:-1]):
            half = len(cw) // 2
            i %= half
            leaves = _leaves_of(cw)
            ch = min(config.cap_height, (len(leaves) - 1).bit_length())
            path, _cap_idx = poseidon_merkle_path(leaves, i, ch)
            layers.append(FriLayerProof(pair=(cw[i], cw[i + half]), path=path))
        query_rounds.append(FriQueryRound(layers=layers))
    return FriProof(caps=caps, final_poly=final_poly, pow_nonce=pow_nonce, query_rounds=query_rounds, betas=betas)


def grind(challenger: Challenger, bits: int) -> int:
    """Find nonce s.t. observing it then sampling yields `bits` leading zeros."""
    nonce = 0
    while True:
        trial = challenger_fork_sample(challenger, nonce)
        if trial >> (64 - bits) == 0:
            return nonce
        nonce += 1


def challenger_fork_sample(challenger: Challenger, nonce: int) -> int:
    import copy

    fork = copy.deepcopy(challenger)
    fork.observe(nonce)
    return fork.sample()


def fri_verify(
    proof: FriProof,
    n: int,
    config: FriConfig,
    challenger: Challenger,
    shift: int,
) -> bool:
    """Re-derives challenges and checks every query round. Returns True if valid."""
    num_layers = len(proof.caps)
    betas = []
    sizes, shifts = [], []
    size, cur_shift = n, shift % P
    for ell in range(num_layers):
        sizes.append(size)
        shifts.append(cur_shift)
        for digest in proof.caps[ell]:
            challenger.observe_many(digest)
        betas.append(challenger.sample())
        size //= 2
        cur_shift = mul(cur_shift, cur_shift)
    if size != config.final_poly_len:
        return False
    if len(proof.final_poly) != config.final_poly_len >> config.rate_bits:
        return False
    challenger.observe_many(proof.final_poly)
    challenger.observe(proof.pow_nonce)
    if challenger.sample() >> (64 - config.proof_of_work_bits) != 0:
        return False
    indices = challenger.sample_indices(config.num_query_rounds, n // 2)
    final_shift = mul(shifts[-1], shifts[-1]) if num_layers else shift % P
    final_domain = _domain_elements(config.final_poly_len.bit_length() - 1, final_shift)
    inv2 = inv(2)
    for idx, qround in zip(indices, proof.query_rounds):
        pos = idx  # position in the current layer's codeword
        expect = None  # expected codeword value at `pos` (None for layer 0)
        for ell in range(num_layers):
            half = sizes[ell] // 2
            i = pos % half  # pair-leaf index
            layer = qround.layers[ell]
            fe, fo = layer.pair
            if expect is not None:
                value_at_pos = fe if pos < half else fo
                if value_at_pos != expect:
                    return False
            if not poseidon_verify_path(proof.caps[ell], [fe, fo], i, layer.path):
                return False
            # fold consistency: value of the next codeword at position i
            xs_i = mul(shifts[ell], root_of_unity_pow(sizes[ell], i))
            even = mul(add(fe, fo), inv2)
            odd = mul(mul(sub(fe, fo), inv2), inv(xs_i))
            expect = add(even, mul(betas[ell], odd))
            pos = i
        val = naive_evaluate(proof.final_poly, [final_domain[pos]])[0]
        if expect is not None and val != expect:
            return False
    return True


def root_of_unity_pow(n: int, i: int) -> int:
    log_n = n.bit_length() - 1
    return pow(root_of_unity(log_n), i, P)
