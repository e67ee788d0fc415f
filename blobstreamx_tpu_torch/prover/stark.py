"""DEEP-ALI STARK prover/verifier over Goldilocks.

prove(air, trace, publics, config) phases, all on the device of the call:
  1. trace INTT + LDE x 2^rate onto 7*<w_ext> + Poseidon commit
  2. Fiat-Shamir alpha (host golden challenger)
  3. constraint evaluation on the extended domain, alpha-combined per
     divisor kind, pointwise division by the divisor tables, INTT, split
     into 2^rate degree-n chunks, LDE + commit
  4. zeta; openings of every committed column at zeta (and g*zeta for the
     trace) via ext power-table evaluation
  5. gamma; DEEP composition polynomial over GF(p^2)
  6. FRI on the DEEP codeword (prover.fri_ext)
  7. per-query trace/quotient row openings + Merkle paths (host gathers)

The NTTs and Poseidon permutations inside go through the CUDA kernels on
the card (ops/ntt.py, ops/poseidon.py); the rest is PyTorch tensor code.
The proof is bit-identical to the JAX package's for the same AIR, trace,
publics and config.

verify() is a host-side (pure python int) verifier: it re-derives the whole
transcript, checks the ALI identity at zeta using the SAME Air.eval_constraints
code over the host ext algebra, checks every Merkle opening, recomputes the
DEEP combination at every queried point, and runs the ext-FRI fold checks.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from blobstreamx_tpu_torch.device import resolve
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl, gl_add, gl_mul, gl_sub
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.golden import ntt as golden_ntt
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.golden.merkle import poseidon_verify_path
from blobstreamx_tpu_torch.ops import merkle as merkle_ops, ntt as ntt_ops
from .air import Air, DeviceAlgebra, HostExtAlgebra, KINDS
from .config import StarkConfig
from .fri_ext import FriExtProof, fri_prove_ext, fri_verify_ext

P = gold.P
U = (0, 1)  # the ext basis element sqrt(7)


# ----------------------------------------------------------------------------
# proof structure
# ----------------------------------------------------------------------------


@dataclass
class RowOpening:
    row: list[int]  # committed leaf vector (u64 ints)
    path: list[list[int]]


@dataclass
class QueryOpenings:
    """Openings at layer-0 FRI positions (i, i + n_ext/2)."""

    trace: tuple[RowOpening, RowOpening]
    quotient: tuple[RowOpening, RowOpening]
    stage2: tuple[RowOpening, RowOpening] | None = None


@dataclass
class StarkProof:
    trace_cap: list[list[int]]
    quotient_cap: list[list[int]]
    trace_zeta: list[tuple[int, int]]  # per trace column, ext
    trace_gzeta: list[tuple[int, int]]
    quotient_zeta: list[tuple[int, int]]  # per quotient base column (2 per chunk)
    fri: FriExtProof
    openings: list[QueryOpenings]  # parallel to fri.query_rounds
    # second (challenge-dependent) trace commitment, empty when air.n_stage2 == 0
    stage2_cap: list[list[int]] = None
    stage2_zeta: list[tuple[int, int]] = None
    stage2_gzeta: list[tuple[int, int]] = None

    def __post_init__(self):
        if self.stage2_cap is None:
            self.stage2_cap = []
        if self.stage2_zeta is None:
            self.stage2_zeta = []
        if self.stage2_gzeta is None:
            self.stage2_gzeta = []


# ----------------------------------------------------------------------------
# host tables (cached per shape)
# ----------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _domain_table(log_n_ext: int, shift: int) -> np.ndarray:
    """x_i = shift * w^i over the extended domain, uint64."""
    w = gold.root_of_unity(log_n_ext)
    n = 1 << log_n_ext
    out = np.empty(n, dtype=np.uint64)
    cur = shift % P
    for i in range(n):
        out[i] = cur
        cur = (cur * w) % P
    return out


def _batch_inv(vals: list[int]) -> list[int]:
    """Montgomery batch inversion: one modular inverse + 3(n-1) muls."""
    n = len(vals)
    prefix = [1] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = (prefix[i] * v) % P
    inv_all = gold.inv(prefix[n])
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = (prefix[i] * inv_all) % P
        inv_all = (inv_all * vals[i]) % P
    return out


@lru_cache(maxsize=None)
def _point_inv_table(log_n_ext: int, shift: int, point: int) -> np.ndarray:
    """1/(x_i - point) over the extended domain (host, batch-inverted).
    Used for the 'first' (point=1) and 'last' (point=g^{n-1}) divisors, so
    the device does no inversion for them."""
    xs = _domain_table(log_n_ext, shift)
    vals = [int(x - point) % P for x in xs.tolist()]
    return np.array(_batch_inv(vals), dtype=np.uint64)


@lru_cache(maxsize=None)
def _zh_inv_table(log_n: int, rate_bits: int, shift: int) -> np.ndarray:
    """1/Z_H(x_i) over the extended domain. Z_H(x) = x^n - 1 is periodic with
    period 2^rate on the coset (x^n = shift^n * (w_ext^n)^i), so only
    2^rate inversions happen on host."""
    n = 1 << log_n
    n_ext = n << rate_bits
    w2 = pow(gold.root_of_unity(log_n + rate_bits), n, P)
    sn = pow(shift % P, n, P)
    vals = []
    cur = sn
    for _ in range(1 << rate_bits):
        vals.append(gold.inv((cur - 1) % P))
        cur = (cur * w2) % P
    return np.tile(np.array(vals, dtype=np.uint64), n_ext >> rate_bits)


@lru_cache(maxsize=None)
def _device_gl(name: str, args: tuple, device: str) -> Gl:
    """A host uint64 table uploaded once per device."""
    table = {"domain": _domain_table, "point_inv": _point_inv_table, "zh_inv": _zh_inv_table}[name]
    return gf64.from_u64(table(*args), device)


# ----------------------------------------------------------------------------
# ext-scalar helpers
# ----------------------------------------------------------------------------


def _ext_to_device(v: tuple[int, int], device):
    return gf64.full((1,), v[0], device), gf64.full((1,), v[1], device)


def _ext_vec_to_host(e) -> list[tuple[int, int]]:
    c0 = gf64.to_u64(e[0])
    c1 = gf64.to_u64(e[1])
    return [(int(a), int(b)) for a, b in zip(c0, c1)]


def _ext_powers(z, m: int):
    """[z^0 .. z^(m-1)] as an ext vector, by log2 doubling steps; z is an ext
    scalar of shape (1,)."""
    p = gf64.ext_full((1,), (1, 0), z[0][0].device)
    sq = z
    while p[0][0].shape[0] < m:
        shifted = gf64.ext_mul(p, sq)
        p = tuple(
            (torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]])) for a, b in zip(p, shifted)
        )
        sq = gf64.ext_square(sq)
    return tuple((c[0][:m], c[1][:m]) for c in p)


def _ext_gather(e, idx):
    return tuple((c[0][idx], c[1][idx]) for c in e)


def _sum_rows(x: Gl) -> Gl:
    """Field sum over axis 0 by log-depth pairwise adds (any length; field
    addition is exact, so the order does not change the value)."""
    lo, hi = x
    while lo.shape[0] > 1:
        k = lo.shape[0]
        half = k // 2
        s = gl_add((lo[:half], hi[:half]), (lo[half : 2 * half], hi[half : 2 * half]))
        if k % 2:
            lo = torch.cat([s[0], lo[-1:]])
            hi = torch.cat([s[1], hi[-1:]])
        else:
            lo, hi = s
    return lo[0], hi[0]


def _sum_cols(x: Gl) -> Gl:
    """Field sum over axis 1 of an (n, C) Gl array."""
    lo, hi = _sum_rows((x[0].T, x[1].T))
    return lo, hi


def _eval_columns_at(coeffs: Gl, powers):
    """Evaluate every column of an (n, C) base-coefficient matrix at the ext
    point whose power table is `powers`. Returns an ext vector (C,)."""
    prod0 = gl_mul(coeffs, (powers[0][0][:, None], powers[0][1][:, None]))
    prod1 = gl_mul(coeffs, (powers[1][0][:, None], powers[1][1][:, None]))
    return _sum_rows(prod0), _sum_rows(prod1)


class _LazyCols:
    """Sequence view over an (n, k) Gl matrix yielding per-column (n,)
    elements on demand, so only the columns a constraint reads are sliced.
    roll > 0 makes the next-row frame: each accessed column is rotated by
    -roll on access instead of rolling the whole matrix."""

    __slots__ = ("lo", "hi", "k", "roll", "_cache")

    def __init__(self, lde, k: int, roll: int = 0):
        self.lo, self.hi = lde
        self.k = k
        self.roll = roll
        self._cache: dict = {}

    def __len__(self) -> int:
        return self.k

    def __getitem__(self, j):
        if isinstance(j, slice):
            return [self[i] for i in range(*j.indices(self.k))]
        if j < 0:
            j += self.k
        assert 0 <= j < self.k, (j, self.k)
        hit = self._cache.get(j)
        if hit is None:
            if self.roll:
                hit = (
                    torch.roll(self.lo[:, j], -self.roll),
                    torch.roll(self.hi[:, j], -self.roll),
                )
            else:
                hit = (self.lo[:, j], self.hi[:, j])
            self._cache[j] = hit
        return hit

    def __iter__(self):
        return (self[j] for j in range(self.k))

    def block(self, a: int, b: int):
        """Columns [a, b) as an (n, b-a) Gl matrix (air.frame_block);
        next-row frames rotate the block on access."""
        assert 0 <= a <= b <= self.k, (a, b, self.k)
        lo, hi = self.lo[:, a:b], self.hi[:, a:b]
        if self.roll:
            lo = torch.roll(lo, -self.roll, dims=0)
            hi = torch.roll(hi, -self.roll, dims=0)
        return lo, hi


def _as_tree(layers, cap_height: int) -> merkle_ops.PoseidonTree:
    return merkle_ops.PoseidonTree(layers=list(layers), cap_height=cap_height)


# ----------------------------------------------------------------------------
# prover phases
# ----------------------------------------------------------------------------


_FIXED_LDE_CACHE: dict = {}


def _fixed_lde_cached(air_key, air: Air, n: int, rate_bits: int, shift: int, device):
    """Device LDE of the AIR's preprocessed columns (never committed; the
    verifier evaluates the same known polynomials at zeta on host). Memoized
    by the VALUE key (air.cache_key()) and device, not the air instance."""
    key = (air_key, n, rate_bits, shift, str(device))
    hit = _FIXED_LDE_CACHE.get(key)
    if hit is not None:
        return hit
    table = air.fixed_columns(n)
    if table is None or table.shape[1] == 0:
        out = gf64.zeros((n << rate_bits, 0), device)
    else:
        fixed_gl = gf64.from_u64(np.asarray(table, np.uint64) % P, device)
        coeffs = ntt_ops.ntt_cols(fixed_gl, inverse=True)
        out = ntt_ops.lde_cols(coeffs, rate_bits, shift)
    _FIXED_LDE_CACHE[key] = out
    return out


def _combine_alpha_device(constraints, alpha, alg: DeviceAlgebra, offset: int = 0):
    """Width-aware alpha combination: constraint j's columns get consecutive
    alpha powers starting at `offset` (a constraint group passes its global
    offset); returns {kind: ext accumulator}."""
    total = offset + sum(alg.width(v) for v, _ in constraints)
    pow_vec = _ext_powers(alpha, max(total, 1))
    acc = {}
    for value, kind in constraints:
        w = alg.width(value)
        if w == 1:
            if value[0].dim() == 2:
                # squeeze an (n, 1) single-column matrix to (n,): adding a 2-D
                # width-1 term to a 1-D one in the same kind's accumulator
                # would broadcast (n,1)+(n,) -> (n,n)
                value = (value[0][:, 0], value[1][:, 0])
            a_o = _ext_gather(pow_vec, slice(offset, offset + 1))
            term = (gl_mul(value, a_o[0]), gl_mul(value, a_o[1]))
        else:
            rows = _ext_gather(pow_vec, slice(offset, offset + w))
            t0 = alg.sum_cols(gl_mul(value, (rows[0][0][None, :], rows[0][1][None, :])))
            t1 = alg.sum_cols(gl_mul(value, (rows[1][0][None, :], rows[1][1][None, :])))
            term = (t0, t1)
        acc[kind] = gf64.ext_add(acc[kind], term) if kind in acc else term
        offset += w
    return acc


def _commit(trace_gl: Gl, rate_bits: int, shift: int, ch: int):
    """INTT + LDE + Poseidon tree of a committed column matrix."""
    coeffs = ntt_ops.ntt_cols(trace_gl, inverse=True)
    lde = ntt_ops.lde_cols(coeffs, rate_bits, shift)
    layers = merkle_ops.tree_layers((lde[0].T, lde[1].T), ch)
    return coeffs, lde, layers


def _quotient_commit(q_cols: Gl, n: int, config: StarkConfig, shift: int, ch: int):
    """AIR-generic quotient commit: INTT over the extended domain, split into
    2^rate degree-n chunks, LDE, Poseidon tree."""
    blowup = config.blowup()
    q_coeffs = ntt_ops.coset_intt_cols(q_cols, shift)  # (n_ext, 2)
    # chunk k, component c -> column 2k + c
    ch_lo = q_coeffs[0].reshape(blowup, n, 2).permute(1, 0, 2).reshape(n, 2 * blowup)
    ch_hi = q_coeffs[1].reshape(blowup, n, 2).permute(1, 0, 2).reshape(n, 2 * blowup)
    q_chunk_coeffs = (ch_lo, ch_hi)
    q_lde = ntt_ops.lde_cols(q_chunk_coeffs, config.rate_bits, shift)
    layers = merkle_ops.tree_layers((q_lde[0].T, q_lde[1].T), ch)
    return q_chunk_coeffs, q_lde, layers


def _quotient_cols(air: Air, trace_lde, s2_lde, publics, alpha, fixed_lde, chals,
                   n: int, config: StarkConfig, shift: int, device) -> Gl:
    """Constraint evaluation over the extended domain, alpha combination and
    division by the divisor tables -> the (n_ext, 2) quotient columns."""
    blowup = config.blowup()
    n_ext = n * blowup
    log_n = n.bit_length() - 1
    log_n_ext = log_n + config.rate_bits
    g_last = pow(gold.root_of_unity(log_n), n - 1, P)
    dev = str(device)

    def frame(lde, k):
        return _LazyCols(lde, k), _LazyCols(lde, k, roll=blowup)

    local, nxt = frame(trace_lde, air.n_cols)
    stage2, stage2_next = frame(s2_lde, air.n_stage2)
    fixed, fixed_next = frame(fixed_lde, air.n_fixed)
    fr = dict(
        fixed=fixed, fixed_next=fixed_next, challenges=chals,
        stage2=stage2, stage2_next=stage2_next,
    )
    alg = DeviceAlgebra((n_ext,), device)
    acc: dict = {}
    offset = 0
    for g in range(getattr(air, "n_constraint_groups", 1)):
        cons = air.eval_constraint_group(g, local, nxt, publics, alg, **fr)
        for v, kind in cons:
            assert kind in KINDS
        for kind, v in _combine_alpha_device(cons, alpha, alg, offset).items():
            acc[kind] = gf64.ext_add(acc[kind], v) if kind in acc else v
        offset += sum(alg.width(v) for v, _ in cons)

    zh_inv = _device_gl("zh_inv", (log_n, config.rate_bits, shift), dev)
    inv_by_kind = {}
    if "all" in acc:
        inv_by_kind["all"] = zh_inv
    if "transition" in acc:
        x_tab = _device_gl("domain", (log_n_ext, shift), dev)
        x_minus_last = gl_sub(x_tab, gf64.full((), g_last, device))
        inv_by_kind["transition"] = gl_mul(zh_inv, x_minus_last)
    if "first" in acc:
        inv_by_kind["first"] = _device_gl("point_inv", (log_n_ext, shift, 1), dev)
    if "last" in acc:
        inv_by_kind["last"] = _device_gl("point_inv", (log_n_ext, shift, g_last), dev)
    q = None
    for kind, v in acc.items():
        inv_d = inv_by_kind[kind]
        term = (gl_mul(v[0], inv_d), gl_mul(v[1], inv_d))
        q = gf64.ext_add(q, term) if q is not None else term
    return torch.stack([q[0][0], q[1][0]], dim=1), torch.stack([q[0][1], q[1][1]], dim=1)


def _openings(trace_coeffs, s2_coeffs, q_chunk_coeffs, zeta, g_zeta, n: int):
    pz = _ext_powers(zeta, n)
    pgz = _ext_powers(g_zeta, n)
    return (
        _eval_columns_at(trace_coeffs, pz),
        _eval_columns_at(trace_coeffs, pgz),
        _eval_columns_at(s2_coeffs, pz),
        _eval_columns_at(s2_coeffs, pgz),
        _eval_columns_at(q_chunk_coeffs, pz),
    )


def _cat_ext(*vs):
    return tuple(
        (torch.cat([v[c][0] for v in vs]), torch.cat([v[c][1] for v in vs])) for c in range(2)
    )


def _deep(trace_lde, s2_lde, q_lde, zeta, g_zeta, gamma, tz, tgz, s2z, s2gz, qz,
          n: int, config: StarkConfig, shift: int):
    """The DEEP composition codeword over the extended domain (ext)."""
    blowup = config.blowup()
    log_n_ext = n.bit_length() - 1 + config.rate_bits
    n_wit = trace_lde[0].shape[1] + s2_lde[0].shape[1]
    g_pows = _ext_powers(gamma, 2 * n_wit + 2 * blowup)
    idx_a = np.concatenate([np.arange(n_wit), 2 * n_wit + np.arange(2 * blowup)])
    idx_b = n_wit + np.arange(n_wit)
    gp_a = _ext_gather(g_pows, torch.from_numpy(idx_a).to(zeta[0][0].device))
    gp_b = _ext_gather(g_pows, torch.from_numpy(idx_b).to(zeta[0][0].device))

    wit_lde = (torch.cat([trace_lde[0], s2_lde[0]], dim=1), torch.cat([trace_lde[1], s2_lde[1]], dim=1))
    cols_a = (torch.cat([wit_lde[0], q_lde[0]], dim=1), torch.cat([wit_lde[1], q_lde[1]], dim=1))
    open_a = _cat_ext(tz, s2z, qz)
    open_b = _cat_ext(tgz, s2gz)
    # A(x) = sum_t gp_a[t] * col_t(x); c_a = sum_t gp_a[t] * opened_t
    a0 = _sum_cols(gl_mul(cols_a, (gp_a[0][0][None, :], gp_a[0][1][None, :])))
    a1 = _sum_cols(gl_mul(cols_a, (gp_a[1][0][None, :], gp_a[1][1][None, :])))
    ca = tuple(_sum_rows(c) for c in gf64.ext_mul(gp_a, open_a))
    b0 = _sum_cols(gl_mul(wit_lde, (gp_b[0][0][None, :], gp_b[0][1][None, :])))
    b1 = _sum_cols(gl_mul(wit_lde, (gp_b[1][0][None, :], gp_b[1][1][None, :])))
    cb = tuple(_sum_rows(c) for c in gf64.ext_mul(gp_b, open_b))

    x_ext = gf64.ext_from_base(_device_gl("domain", (log_n_ext, shift), str(zeta[0][0].device)))
    inv_xz = gf64.ext_inv(gf64.ext_sub(x_ext, zeta))
    inv_xgz = gf64.ext_inv(gf64.ext_sub(x_ext, g_zeta))
    num_a = gf64.ext_sub((a0, a1), ca)
    num_b = gf64.ext_sub((b0, b1), cb)
    return gf64.ext_add(gf64.ext_mul(num_a, inv_xz), gf64.ext_mul(num_b, inv_xgz))


def _observe_cap(challenger: Challenger, cap_ints) -> None:
    for digest in cap_ints:
        challenger.observe_many(digest)


def _observe_ext(challenger: Challenger, v: tuple[int, int]) -> None:
    challenger.observe(v[0])
    challenger.observe(v[1])


# ----------------------------------------------------------------------------
# prover
# ----------------------------------------------------------------------------


def prove(
    air: Air,
    trace: np.ndarray,
    publics: list[int],
    config: StarkConfig,
    shift: int = gold.COSET_SHIFT,
    aux=None,
    device=None,
) -> StarkProof:
    """trace: (n_rows, n_cols) uint64 execution trace (rows over the subgroup
    H of order n_rows, natural order). aux: post-commit claims for AIRs with
    sample_challenges (observed into the transcript before sampling).
    device: where the prover's tensors live (default: the card)."""
    device = resolve(device)
    n, n_cols = trace.shape
    assert n & (n - 1) == 0
    assert n_cols == air.n_cols
    assert air.max_degree <= config.blowup(), "rate too low for constraint degree"
    log_n = n.bit_length() - 1
    blowup = config.blowup()
    n_ext = n * blowup
    g = gold.root_of_unity(log_n)
    ch = min(config.cap_height, (n_ext - 1).bit_length())

    challenger = Challenger()
    challenger.observe_many([v % P for v in publics])

    trace_gl = gf64.from_u64(trace, device)
    fixed_lde = _fixed_lde_cached(air.cache_key(), air, n, config.rate_bits, shift, device)
    trace_coeffs, trace_lde, t_layers = _commit(trace_gl, config.rate_bits, shift, ch)
    trace_tree = _as_tree(t_layers, ch)
    trace_cap = merkle_ops.cap_to_ints(trace_tree)
    _observe_cap(challenger, trace_cap)

    air.observe_aux(challenger, aux)
    chals = air.sample_challenges(challenger, aux)
    assert len(chals) == air.n_challenges
    chal_elems = [gf64.full((1,), v % P, device) for v in chals]

    # stage 2: challenge-dependent columns, committed AFTER sampling
    n_s2 = air.n_stage2
    if n_s2:
        s2 = air.build_stage2(trace, chals, aux)
        assert s2.shape == (n, n_s2)
        s2_gl = gf64.from_u64(np.asarray(s2, np.uint64) % P, device)
        s2_coeffs, s2_lde, s2_layers = _commit(s2_gl, config.rate_bits, shift, ch)
        s2_tree = _as_tree(s2_layers, ch)
        s2_cap = merkle_ops.cap_to_ints(s2_tree)
        _observe_cap(challenger, s2_cap)
    else:
        s2_coeffs, s2_lde, s2_tree, s2_cap = (
            gf64.zeros((n, 0), device), gf64.zeros((n_ext, 0), device), None, [],
        )

    alpha = challenger.sample_ext()
    pub_elems = [gf64.full((1,), v % P, device) for v in publics]
    q_cols = _quotient_cols(
        air, trace_lde, s2_lde, pub_elems, _ext_to_device(alpha, device), fixed_lde,
        chal_elems, n, config, shift, device,
    )
    q_chunk_coeffs, q_lde, q_layers = _quotient_commit(q_cols, n, config, shift, ch)
    q_tree = _as_tree(q_layers, ch)
    q_cap = merkle_ops.cap_to_ints(q_tree)
    _observe_cap(challenger, q_cap)

    zeta = challenger.sample_ext()
    g_zeta = gold.ext_mul(zeta, (g, 0))
    zeta_d, g_zeta_d = _ext_to_device(zeta, device), _ext_to_device(g_zeta, device)
    tz_d, tgz_d, s2z_d, s2gz_d, qz_d = _openings(
        trace_coeffs, s2_coeffs, q_chunk_coeffs, zeta_d, g_zeta_d, n
    )
    trace_zeta = _ext_vec_to_host(tz_d)
    trace_gzeta = _ext_vec_to_host(tgz_d)
    stage2_zeta = _ext_vec_to_host(s2z_d)
    stage2_gzeta = _ext_vec_to_host(s2gz_d)
    quotient_zeta = _ext_vec_to_host(qz_d)
    for v in trace_zeta + trace_gzeta + stage2_zeta + stage2_gzeta + quotient_zeta:
        _observe_ext(challenger, v)

    gamma = challenger.sample_ext()
    deep_cw = _deep(
        trace_lde, s2_lde, q_lde, zeta_d, g_zeta_d, _ext_to_device(gamma, device),
        tz_d, tgz_d, s2z_d, s2gz_d, qz_d, n, config, shift,
    )

    fri_proof, indices = fri_prove_ext(deep_cw, config.fri(), challenger, shift)

    t_host = gf64.to_u64(trace_lde)
    q_host = gf64.to_u64(q_lde)
    s2_host = gf64.to_u64(s2_lde) if n_s2 else None
    half = n_ext // 2
    openings = []
    for idx in indices:
        i = idx % half
        sources = [(t_host, trace_tree), (q_host, q_tree)]
        if n_s2:
            sources.append((s2_host, s2_tree))
        rows = []
        for host, tree in sources:
            pair = []
            for posn in (i, i + half):
                path, _ = tree.path(posn)
                pair.append(RowOpening(row=[int(v) for v in host[posn]], path=path))
            rows.append((pair[0], pair[1]))
        openings.append(
            QueryOpenings(
                trace=rows[0], quotient=rows[1], stage2=rows[2] if n_s2 else None
            )
        )

    return StarkProof(
        trace_cap=trace_cap,
        quotient_cap=q_cap,
        trace_zeta=trace_zeta,
        trace_gzeta=trace_gzeta,
        quotient_zeta=quotient_zeta,
        fri=fri_proof,
        openings=openings,
        stage2_cap=s2_cap,
        stage2_zeta=stage2_zeta,
        stage2_gzeta=stage2_gzeta,
    )


# ----------------------------------------------------------------------------
# verifier (host, pure python ints)
# ----------------------------------------------------------------------------


_FIXED_COEFFS_CACHE: dict = {}


def _fixed_coeffs_host(air_key, air: Air, n: int):
    """Host (python-int) coefficient vectors of the AIR's preprocessed
    columns — the verifier evaluates these known polynomials at zeta itself,
    independently of the device. Memoized by value key, not instance."""
    hit = _FIXED_COEFFS_CACHE.get((air_key, n))
    if hit is not None:
        return hit
    table = air.fixed_columns(n)
    if table is None or table.shape[1] == 0:
        out = []
    else:
        out = [
            golden_ntt.intt([int(v) % P for v in table[:, j]])
            for j in range(table.shape[1])
        ]
    _FIXED_COEFFS_CACHE[(air_key, n)] = out
    return out


def _eval_fixed_host(coeff_cols, z: tuple[int, int]) -> list[tuple[int, int]]:
    """Evaluate each fixed-column polynomial (base coeffs) at the ext point z."""
    if not coeff_cols:
        return []
    n = len(coeff_cols[0])
    pows = [(1, 0)]
    for _ in range(n - 1):
        pows.append(gold.ext_mul(pows[-1], z))
    out = []
    for coeffs in coeff_cols:
        a0 = a1 = 0
        for c, (z0, z1) in zip(coeffs, pows):
            if c:
                a0 += c * z0
                a1 += c * z1
        out.append((a0 % P, a1 % P))
    return out


def _combine_alpha_host(constraints, alpha, alg: HostExtAlgebra):
    """Width-aware alpha combination on host — same power assignment as
    _combine_alpha_device (constraint order and widths define it)."""
    acc: dict[str, tuple[int, int]] = {}
    offset = 0
    cur = (1, 0)
    pows = []
    total = sum(alg.width(v) for v, _ in constraints)
    for _ in range(total):
        pows.append(cur)
        cur = gold.ext_mul(cur, alpha)
    for value, kind in constraints:
        w = alg.width(value)
        if w == 1:
            if isinstance(value, list):
                # a single-column matrix constraint (e.g. the Ed AIR's
                # logUp table wells when the range table fits ONE column,
                # nt=1 at 2^16 rows) arrives as a 1-element list; unwrap it
                # — ext_mul(list, pow) would "multiply" the LIST by a
                # ~2^64 field element (python list repetition, MemoryError).
                # Device-side twin: _combine_alpha_device's (n,1) squeeze.
                value = value[0]
            term = gold.ext_mul(value, pows[offset])
        else:
            term = (0, 0)
            for j in range(w):
                term = gold.ext_add(term, gold.ext_mul(value[j], pows[offset + j]))
        acc[kind] = gold.ext_add(acc.get(kind, (0, 0)), term)
        offset += w
    return acc


def _host_divisor_inv(kind: str, zeta, n: int, g_last: int):
    zh = gold.ext_sub(gold.ext_exp(zeta, n), (1, 0))
    if kind == "all":
        return gold.ext_inv(zh)
    if kind == "transition":
        return gold.ext_mul(gold.ext_inv(zh), gold.ext_sub(zeta, (g_last, 0)))
    if kind == "first":
        return gold.ext_inv(gold.ext_sub(zeta, (1, 0)))
    if kind == "last":
        return gold.ext_inv(gold.ext_sub(zeta, (g_last, 0)))
    raise ValueError(kind)


def verify(
    air: Air,
    proof: StarkProof,
    publics: list[int],
    config: StarkConfig,
    n: int,
    shift: int = gold.COSET_SHIFT,
    aux=None,
) -> bool:
    n_cols = air.n_cols
    blowup = config.blowup()
    n_ext = n * blowup
    log_n = n.bit_length() - 1
    log_n_ext = log_n + config.rate_bits
    g = gold.root_of_unity(log_n)
    g_last = pow(g, n - 1, P)
    w_ext = gold.root_of_unity(log_n_ext)

    n_s2 = air.n_stage2
    if len(proof.trace_zeta) != n_cols or len(proof.trace_gzeta) != n_cols:
        return False
    if len(proof.quotient_zeta) != 2 * blowup:
        return False
    if len(proof.stage2_zeta) != n_s2 or len(proof.stage2_gzeta) != n_s2:
        return False
    if n_s2 and not proof.stage2_cap:
        return False

    challenger = Challenger()
    challenger.observe_many([v % P for v in publics])
    for digest in proof.trace_cap:
        challenger.observe_many(digest)
    air.observe_aux(challenger, aux)
    chals = air.sample_challenges(challenger, aux)
    if len(chals) != air.n_challenges:
        return False
    if n_s2:
        for digest in proof.stage2_cap:
            challenger.observe_many(digest)
    alpha = challenger.sample_ext()
    for digest in proof.quotient_cap:
        challenger.observe_many(digest)
    zeta = challenger.sample_ext()
    for v in (
        proof.trace_zeta
        + proof.trace_gzeta
        + proof.stage2_zeta
        + proof.stage2_gzeta
        + proof.quotient_zeta
    ):
        _observe_ext(challenger, v)
    gamma = challenger.sample_ext()

    # --- ALI identity at zeta ----------------------------------------------
    alg = HostExtAlgebra()
    g_zeta = gold.ext_mul(zeta, (g, 0))
    pub_elems = [(v % P, 0) for v in publics]
    fixed_coeffs = _fixed_coeffs_host(air.cache_key(), air, n)
    fixed_zeta = _eval_fixed_host(fixed_coeffs, zeta)
    fixed_gzeta = _eval_fixed_host(fixed_coeffs, g_zeta)
    chal_elems = [(v % P, 0) for v in chals]
    constraints = air.eval_constraints(
        list(proof.trace_zeta),
        list(proof.trace_gzeta),
        pub_elems,
        alg,
        fixed=fixed_zeta,
        fixed_next=fixed_gzeta,
        challenges=chal_elems,
        stage2=list(proof.stage2_zeta),
        stage2_next=list(proof.stage2_gzeta),
    )
    acc = _combine_alpha_host(constraints, alpha, alg)
    lhs = (0, 0)
    for kind, v in acc.items():
        lhs = gold.ext_add(lhs, gold.ext_mul(v, _host_divisor_inv(kind, zeta, n, g_last)))
    zeta_n = gold.ext_exp(zeta, n)
    rhs = (0, 0)
    zp = (1, 0)
    for k in range(blowup):
        qk = gold.ext_add(
            proof.quotient_zeta[2 * k],
            gold.ext_mul(U, proof.quotient_zeta[2 * k + 1]),
        )
        rhs = gold.ext_add(rhs, gold.ext_mul(zp, qk))
        zp = gold.ext_mul(zp, zeta_n)
    if lhs != rhs:
        return False

    # --- DEEP recomputation + FRI ------------------------------------------
    n_wit = n_cols + n_s2
    g_pows = []
    cur = (1, 0)
    for _ in range(2 * n_wit + 2 * blowup):
        g_pows.append(cur)
        cur = gold.ext_mul(cur, gamma)
    wit_zeta = proof.trace_zeta + proof.stage2_zeta
    wit_gzeta = proof.trace_gzeta + proof.stage2_gzeta

    half = n_ext // 2
    query_state = {"round": -1}

    def deep_at(posn: int, row_w: list[int], row_q: list[int]):
        x = gold.mul(shift % P, pow(w_ext, posn, P))
        inv_xz = gold.ext_inv(gold.ext_sub((x, 0), zeta))
        inv_xgz = gold.ext_inv(gold.ext_sub((x, 0), g_zeta))
        num_a = (0, 0)
        num_b = (0, 0)
        for j in range(n_wit):
            tv = (row_w[j] % P, 0)
            num_a = gold.ext_add(
                num_a, gold.ext_mul(g_pows[j], gold.ext_sub(tv, wit_zeta[j]))
            )
            num_b = gold.ext_add(
                num_b,
                gold.ext_mul(g_pows[n_wit + j], gold.ext_sub(tv, wit_gzeta[j])),
            )
        for k in range(2 * blowup):
            qv = (row_q[k] % P, 0)
            num_a = gold.ext_add(
                num_a,
                gold.ext_mul(
                    g_pows[2 * n_wit + k], gold.ext_sub(qv, proof.quotient_zeta[k])
                ),
            )
        return gold.ext_add(gold.ext_mul(num_a, inv_xz), gold.ext_mul(num_b, inv_xgz))

    def layer0_check(i: int, pair) -> bool:
        query_state["round"] += 1
        r = query_state["round"]
        if r >= len(proof.openings):
            return False
        q = proof.openings[r]
        if n_s2 and q.stage2 is None:
            return False
        for side, (posn, want) in enumerate(((i, pair[0]), (i + half, pair[1]))):
            row_open_t = q.trace[side]
            row_open_q = q.quotient[side]
            if len(row_open_t.row) != n_cols or len(row_open_q.row) != 2 * blowup:
                return False
            if not poseidon_verify_path(
                proof.trace_cap, [v % P for v in row_open_t.row], posn, row_open_t.path
            ):
                return False
            if not poseidon_verify_path(
                proof.quotient_cap, [v % P for v in row_open_q.row], posn, row_open_q.path
            ):
                return False
            row_w = list(row_open_t.row)
            if n_s2:
                row_open_s2 = q.stage2[side]
                if len(row_open_s2.row) != n_s2:
                    return False
                if not poseidon_verify_path(
                    proof.stage2_cap,
                    [v % P for v in row_open_s2.row],
                    posn,
                    row_open_s2.path,
                ):
                    return False
                row_w += list(row_open_s2.row)
            if deep_at(posn, row_w, row_open_q.row) != want:
                return False
        return True

    return fri_verify_ext(
        proof.fri, n_ext, config.fri(), challenger, shift, layer0_check=layer0_check
    )
