"""Bounded-memory streaming STARK prover.

prove_streaming() produces a proof BIT-IDENTICAL to stark.prove() (same
transcript, same field ops, same bytes) while never materializing the
(n_ext, C) low-degree extension that drives stark.prove's peak memory. The
port holds a field element as two int64 words (16 B), so the SHA-256 AIR at
2^18 rows (1300 committed columns) has a 43.6 GB LDE and stark.prove would
need well over the H100's 80 GB; this path runs it in a bounded set.

Memory strategy (all on the device; nothing large crosses to the host):

  commit     the trace streams through the Poseidon sponge in COLUMN CHUNKS:
             per chunk, INTT -> coset LDE -> absorb 8 columns per permutation
             into a carried (12, n_ext) sponge state. Peak = one (n_ext, c)
             chunk, not (n_ext, C). Absorption order equals
             ops.merkle.tree_layers -> digests identical.
  quotient   CLASS DECOMPOSITION: extended-domain points with index
             i = u*blowup + r (fixed r) form the coset shift*w_ext^r*<w_n>,
             so the LDE restricted to class r is ONE size-n coset NTT of the
             trace coefficients. Constraint evaluation is pointwise except
             the next-row frame, and i + blowup lands in the SAME class at
             u+1. Each class evaluates at (n, C), in row ranges of at most
             EVAL_BYTES per (rows, C) int64 word array (eager PyTorch holds
             every temporary of the constraint program, where XLA fused
             them), and the per-class quotient columns interleave back into
             the exact full-domain array.
  openings   evaluated per coefficient chunk at zeta/g*zeta (tiny outputs).
  DEEP       gamma-weighted column sums accumulate per chunk over a
             recomputed LDE chunk; the (n_ext,) ext accumulator is the only
             full-domain array.
  queries    opened rows gather on the device from a recomputed LDE chunk,
             and Merkle paths from the digest layers.

Over a mesh (prove_streaming(mesh=), parallel.mesh.Mesh) every rank runs
this one transcript on the same inputs and the work is split where it is
large, with collectives only at the re-shards:

  commit     column chunk i is rank i % D's: its LDE, then one all-to-all a
             round of D chunks (contiguous columns) moves them to rows, and
             each rank absorbs its n_ext/D rows into its part of the sponge;
             the leaf digests are gathered and every rank builds the tree
  quotient   class r is rank r % D's; the classes' quotients are gathered
  DEEP       each rank sums its own chunks over the whole domain; the ranks'
             sums are gathered and added (the field's addition is exact)
  FRI        prover.fri_ext with the mesh (pair layout, a re-pairing a layer)
  queries    each rank gathers the opened rows of its own chunks; the rows
             are gathered, the paths come from the tree every rank holds
  the coefficients (INTT), the openings and the quotient commit run on
  every rank (they are small beside the LDE)

Host->device transfer is packed: all-boolean traces (the SHA-256 AIR's 1300
bit columns) ship as 32 bits per u32 word, u32-range traces as one word per
value.
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.device import resolve_with_mesh
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl, gl_mul
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.ops import merkle as merkle_ops, ntt as ntt_ops, poseidon as pos
from blobstreamx_tpu_torch.utils.timing import maybe_scope
from .air import Air
from .config import StarkConfig
from .fri_ext import fri_prove_ext
from .stark import (
    QueryOpenings,
    RowOpening,
    StarkProof,
    _LazyCols,
    _PowerTable,
    _as_tree,
    _deep_divide,
    _divisor_tables,
    _eval_columns_at,
    _ext_powers,
    _ext_to_device,
    _ext_vec_to_host,
    _observe_cap,
    _observe_ext,
    _quotient_commit,
    _quotient_points,
    _sum_cols,
)

P = gold.P
RATE = pos.RATE
WIDTH = pos.WIDTH
DIGEST = pos.DIGEST
WORD_BYTES = 16  # one field element: two int64 words

# Sizes on one H100 (80 GB), re-derived from the JAX package's for the
# port's 16 B elements and eager evaluation (PERF.md, "Memory"):
# - one column chunk's LDE, (n_ext, c) at 16 B: its DEEP pass holds about 14
#   (n_ext, c) int64 temporaries of a field multiply, 7 GB at 1 GiB;
#   at n_ext = 2^21 this is the JAX package's 32 columns
CHUNK_BYTES = 1 << 30
# - the INTT'd coefficients of every committed column stay resident when
#   they fit (5.45 GB for the SHA AIR at 2^18 rows), else each pass redoes
#   the INTT of its chunk
COEFF_CACHE_BYTES = 16 << 30
# - a class is evaluated in row ranges whose (rows, columns) int64 word array
#   is at most this: the constraint program's field multiply holds about 14
#   of them at once
EVAL_BYTES = 2 << 30
# - prove_auto's cutover on estimate_standard_bytes, set by time: on an H100
#   stark.prove is faster than prove_streaming on Sha256Air at 2^12 and 2^13
#   rows and slower from 2^14 (prover_ab.py sha_provers, PERF.md); this
#   sits between their estimates (4.09 and 8.19 GB). Memory allows more:
#   stark.prove's peak is 3.31x the estimate plus a constant under 1 MB (a
#   line through Sha256Air at 2^12, 2^13 and 2^14 rows, chip_smoke.py phase
#   8), 21.3 GB at this cutover, under 85 % of the card (checked each run)
AUTO_STREAM_BYTES = 6 << 30


# ----------------------------------------------------------------------------
# column sources: host trace -> packed device storage -> coefficient chunks
# ----------------------------------------------------------------------------


def _chunk_bounds(C: int, chunk: int) -> list[tuple[int, int]]:
    """Column chunk [a, b) bounds; every bound except the last is a multiple
    of RATE so sponge absorption never straddles a chunk."""
    assert chunk % RATE == 0
    out = [(a, min(C, a + chunk)) for a in range(0, C, chunk)]
    return out or [(0, 0)]


class _Source:
    """Device-resident committed-column source with packed storage and
    chunked coefficient access (INTT per chunk, optionally cached)."""

    def __init__(self, host: np.ndarray, chunk: int, cache_coeffs: bool, device):
        n, C = host.shape
        self.n, self.C = n, C
        self.device = device
        self.bounds = _chunk_bounds(C, chunk)
        self._coeffs: list | None = [None] * len(self.bounds) if cache_coeffs else None
        mx = int(host.max()) if host.size else 0
        if mx <= 1:
            # bit j of a row is bit j % 32 of its word j // 32
            self.mode = "bits"
            W = (C + 31) // 32
            bits = np.packbits(host.astype(np.uint8), axis=1, bitorder="little")
            pad = np.zeros((n, 4 * W - bits.shape[1]), np.uint8)
            packed = np.concatenate([bits, pad], axis=1).view("<u4").reshape(n, W)
            self._store = torch.from_numpy(packed.astype(np.int64)).to(device)
        elif mx < (1 << 32):
            self.mode = "u32"
            self._store = torch.from_numpy(host.astype(np.int64)).to(device)
        else:
            self.mode = "u64"
            self._store = gf64.from_u64(host % P, device)

    def chunk_gl(self, i: int) -> Gl:
        a, b = self.bounds[i]
        if self.mode == "bits":
            js = torch.arange(a, b, device=self.device)
            bits = (self._store.index_select(1, js // 32) >> (js % 32)[None, :]) & 1
            return bits, torch.zeros_like(bits)
        if self.mode == "u32":
            sl = self._store[:, a:b].contiguous()
            return sl, torch.zeros_like(sl)
        return self._store[0][:, a:b].contiguous(), self._store[1][:, a:b].contiguous()

    def coeff_chunk(self, i: int) -> Gl:
        if self._coeffs is not None and self._coeffs[i] is not None:
            return self._coeffs[i]
        out = ntt_ops.ntt_cols(self.chunk_gl(i), inverse=True)
        if self._coeffs is not None:
            self._coeffs[i] = out
        return out

    def chunks(self, mesh=None):
        """(index, a, b) of every non-empty chunk; with a mesh, of those this
        rank owns (chunk i is rank i % D's)."""
        return [(i, a, b) for i, (a, b) in enumerate(self.bounds)
                if b > a and (mesh is None or i % mesh.size == mesh.rank)]


def _empty_source(n: int, chunk: int, device) -> _Source:
    return _Source(np.zeros((n, 0), np.uint64), chunk, False, device)


# ----------------------------------------------------------------------------
# streamed Merkle commit
# ----------------------------------------------------------------------------


def _absorb(st: Gl, cols: Gl) -> Gl:
    """Absorb the columns of a (c, n_ext) chunk into the (12, n_ext) sponge
    state, RATE at a time (the last group may be partial)."""
    c = cols[0].shape[0]
    for start in range(0, c, RATE):
        k = min(RATE, c - start)
        st = pos.permute((
            torch.cat([cols[0][start : start + k], st[0][k:]]),
            torch.cat([cols[1][start : start + k], st[1][k:]]),
        ))
    return st


def _stream_commit(src: _Source, config: StarkConfig, shift: int, ch: int, mesh=None):
    """Streamed trace commit. Returns tree layers (leaf digests first) —
    the layers of ops.merkle.tree_layers over the full LDE. mesh: a round
    of D chunks at a time (chunk i extended on rank i % D), moved to rows
    and absorbed into this rank's n_ext/D sponge columns; the leaf digests
    are gathered and every rank builds the whole tree."""
    n_ext = src.n << config.rate_bits
    if mesh is None:
        st = gf64.zeros((WIDTH, n_ext), src.device)
        for i, _, _ in src.chunks():
            lde = ntt_ops.lde_cols(src.coeff_chunk(i), config.rate_bits, shift)
            st = _absorb(st, (lde[0].T, lde[1].T))
            del lde
        return merkle_ops.digest_layers((st[0][:DIGEST], st[1][:DIGEST]), ch)
    from blobstreamx_tpu_torch.parallel.mesh import cols_to_rows

    d = mesh.size
    st = gf64.zeros((WIDTH, n_ext // d), src.device)
    chunks = src.chunks()
    for t in range(0, len(chunks), d):
        rnd = chunks[t : t + d]
        if mesh.rank < len(rnd):
            lde = torch.stack(ntt_ops.lde_cols(src.coeff_chunk(rnd[mesh.rank][0]), config.rate_bits, shift))
        else:
            lde = torch.zeros((2, n_ext, 0), dtype=torch.int64, device=src.device)
        rows = cols_to_rows(lde, [b - a for _, a, b in rnd] + [0] * (d - len(rnd)), mesh)
        del lde
        st = _absorb(st, (rows[0].T, rows[1].T))
        del rows
    digests = torch.cat(mesh.all_gather(torch.stack((st[0][:DIGEST], st[1][:DIGEST]))), dim=2)
    return merkle_ops.digest_layers((digests[0], digests[1]), ch)


# ----------------------------------------------------------------------------
# class-decomposed quotient
# ----------------------------------------------------------------------------


def _class_arrays(src: _Source, r: int, log_n_ext: int, shift: int) -> Gl:
    """Class-r evaluations of every column, (n, C): the coefficients scaled
    by sigma^k, sigma = shift * w_ext^r, then a forward NTT."""
    sigma = (shift * pow(gold.root_of_unity(log_n_ext), r, P)) % P
    out = gf64.zeros((src.n, src.C), src.device)
    for i, a, b in src.chunks():
        part = ntt_ops.coset_ntt_cols(src.coeff_chunk(i), sigma)
        out[0][:, a:b] = part[0]
        out[1][:, a:b] = part[1]
    return out


def _row_frames(cls: Gl, k: int, a: int, b: int) -> tuple[_LazyCols, _LazyCols]:
    """Rows [a, b) of a class array and the next rows (a+1 .. b, cyclic)."""
    n = cls[0].shape[0]
    nxt = (torch.arange(a + 1, b + 1, device=cls[0].device)) % n
    return (
        _LazyCols((cls[0][a:b], cls[1][a:b]), k),
        _LazyCols((cls[0].index_select(0, nxt), cls[1].index_select(0, nxt)), k),
    )


def _eval_rows(n: int, n_cols: int) -> int:
    """Rows of a class evaluated at once: the largest power of two whose
    (rows, n_cols) int64 array fits EVAL_BYTES (at least 1)."""
    rows = max(1, EVAL_BYTES // (8 * max(n_cols, 1)))
    return min(n, 1 << (rows.bit_length() - 1))


def _stream_quotient(air: Air, trace_src, s2_src, fixed_src, publics, alpha_pows, chals,
                     n: int, config: StarkConfig, shift: int, device, mesh=None) -> Gl:
    """The (n_ext, 2) quotient columns, class by class (row ranges within a
    class); equal to stark._quotient_cols over the whole domain. mesh:
    class r is evaluated on rank r % D, then every rank gathers them."""
    blowup = config.blowup()
    log_n_ext = n.bit_length() - 1 + config.rate_bits
    full_tables = _divisor_tables(n, config, shift, device)
    rows = _eval_rows(n, air.n_cols + air.n_stage2 + air.n_fixed)
    q = gf64.zeros((n, blowup, 2), device)  # [u, r] = point u*blowup + r
    for r in range(blowup):
        if mesh is not None and r % mesh.size != mesh.rank:
            continue
        cls = _class_arrays(trace_src, r, log_n_ext, shift)
        s2_cls = _class_arrays(s2_src, r, log_n_ext, shift)
        fx_cls = _class_arrays(fixed_src, r, log_n_ext, shift)
        for a in range(0, n, rows):
            b = a + rows
            local, nxt = _row_frames(cls, air.n_cols, a, b)
            s2, s2_next = _row_frames(s2_cls, air.n_stage2, a, b)
            fx, fx_next = _row_frames(fx_cls, air.n_fixed, a, b)
            frames = dict(local=local, nxt=nxt, stage2=s2, stage2_next=s2_next, fixed=fx, fixed_next=fx_next)

            def tables(name, r=r, a=a, b=b):
                return tuple(t[r::blowup][a:b] for t in full_tables(name))

            part = _quotient_points(air, frames, publics, alpha_pows, chals, b - a, tables, n, device)
            q[0][a:b, r] = part[0]
            q[1][a:b, r] = part[1]
            del local, nxt, s2, s2_next, fx, fx_next, frames, part
        del cls, s2_cls, fx_cls
    if mesh is not None:
        parts = mesh.all_gather(torch.stack(q))  # D x (2, n, blowup, 2)
        full = torch.empty_like(parts[0])
        for r in range(blowup):
            full[:, :, r] = parts[r % mesh.size][:, :, r]
        q = (full[0], full[1])
    return q[0].reshape(n * blowup, 2), q[1].reshape(n * blowup, 2)


# ----------------------------------------------------------------------------
# streamed openings / DEEP / query rows
# ----------------------------------------------------------------------------


def _open_source(src: _Source, pz, pgz):
    """Openings of every column at zeta and g*zeta, as host ext lists."""
    vz, vgz = [], []
    for i, _, _ in src.chunks():
        co = src.coeff_chunk(i)
        vz.append(_eval_columns_at(co, pz))
        vgz.append(_eval_columns_at(co, pgz))

    def cat(vs):
        if not vs:
            return []
        return _ext_vec_to_host(tuple(
            (torch.cat([v[c][0] for v in vs]), torch.cat([v[c][1] for v in vs])) for c in range(2)
        ))

    return cat(vz), cat(vgz)


def _weighted_sum(lde: Gl, gp) -> tuple[Gl, Gl]:
    """sum_t gp[t] * lde[:, t] over the columns of an (n_ext, c) chunk (ext)."""
    return (
        _sum_cols(gl_mul(lde, (gp[0][0][None, :], gp[0][1][None, :]))),
        _sum_cols(gl_mul(lde, (gp[1][0][None, :], gp[1][1][None, :]))),
    )


def _stream_rows(src: _Source, positions: torch.Tensor, rate_bits: int, shift: int, mesh=None) -> np.ndarray:
    """Opened rows (|pos|, C) uint64: per-chunk device gathers from a
    recomputed LDE chunk, placed on the device. mesh: each rank gathers its
    own chunks' rows; the ranks' rows are gathered and each chunk's
    columns taken from its rank."""
    out = torch.zeros((2, positions.shape[0], src.C), dtype=torch.int64, device=src.device)
    for i, a, b in src.chunks(mesh):
        lde = ntt_ops.lde_cols(src.coeff_chunk(i), rate_bits, shift)
        out[0][:, a:b] = lde[0].index_select(0, positions)
        out[1][:, a:b] = lde[1].index_select(0, positions)
        del lde
    if mesh is not None:
        parts = mesh.all_gather(out)
        for i, a, b in src.chunks():
            out[:, :, a:b] = parts[i % mesh.size][:, :, a:b]
    return gf64.to_u64((out[0], out[1]))


def _ext_sum_over_ranks(vals, mesh):
    """Each ext vector of `vals` summed over the ranks of the mesh (the
    field's addition is exact and canonical, so the terms' order does not
    change the value)."""
    parts = mesh.all_gather(torch.stack([w for v in vals for c in v for w in c]))
    out = []
    for j in range(len(vals)):
        acc = None
        for p in parts:
            e = ((p[4 * j], p[4 * j + 1]), (p[4 * j + 2], p[4 * j + 3]))
            acc = e if acc is None else gf64.ext_add(acc, e)
        out.append(acc)
    return out


def _device_paths(layers, positions: np.ndarray):
    """Merkle sibling paths for `positions`, gathered on the device: per
    position [[4 ints] * n_levels] (leaf -> cap), as PoseidonTree.path gives
    them; all levels' gathers go to the host as one (4, L*|pos|) array."""
    body = layers[:-1]
    idx = torch.from_numpy(positions).to(body[0][0].device)
    sibs = []
    for lo, hi in body:
        sibs.append((lo.index_select(1, idx ^ 1), hi.index_select(1, idx ^ 1)))
        idx = idx // 2
    flat = gf64.to_u64((torch.cat([s[0] for s in sibs], 1), torch.cat([s[1] for s in sibs], 1)))
    npos = len(positions)
    return [
        [[int(x) for x in flat[:, lvl * npos + pi]] for lvl in range(len(body))]
        for pi in range(npos)
    ]


# ----------------------------------------------------------------------------
# prover
# ----------------------------------------------------------------------------


def _auto_chunk(n_ext: int, n_cols: int = 0, mesh=None) -> int:
    """Columns per chunk: CHUNK_BYTES of LDE, a multiple of RATE in [RATE, 128];
    under a mesh no wider than an even share of the n_cols trace columns
    (rounded up to RATE), so that every rank has a chunk to extend."""
    c = CHUNK_BYTES // (n_ext * WORD_BYTES)
    c = int(max(RATE, min(128, (c // RATE) * RATE)))
    if mesh is not None:
        share = -(-n_cols // mesh.size)
        c = min(c, max(RATE, -(-share // RATE) * RATE))
    return c


def estimate_standard_bytes(n: int, n_cols_total: int, config: StarkConfig) -> int:
    """Rough device-memory estimate of stark.prove's resident set (trace and
    stage-2 LDEs and the commit transpose) at 16 B per element — the
    auto-streaming trigger."""
    n_ext = n << config.rate_bits
    return 3 * n_ext * n_cols_total * WORD_BYTES


def uses_streaming(air: Air, n: int, config: StarkConfig) -> bool:
    """prove_auto's choice, from the estimate alone."""
    return estimate_standard_bytes(n, air.n_cols + air.n_stage2, config) > AUTO_STREAM_BYTES


def prove_auto(
    air: Air,
    trace: np.ndarray,
    publics: list[int],
    config: StarkConfig,
    shift: int = gold.COSET_SHIFT,
    aux=None,
    device=None,
    timing=None,
    mesh=None,
) -> StarkProof:
    """stark.prove with the streaming cutover: a prove whose estimate passes
    AUTO_STREAM_BYTES takes the bounded-memory path (bit-identical proof),
    every other the standard one. The choice is the estimate's alone.
    timing: a TimingTree that the streaming path adds its phases to.
    mesh: always the streaming path, which carries the mesh schedule."""
    from . import stark as _stark

    if mesh is not None or uses_streaming(air, trace.shape[0], config):
        return prove_streaming(air, trace, publics, config, shift, aux, device=device, timing=timing, mesh=mesh)
    return _stark.prove(air, trace, publics, config, shift=shift, aux=aux, device=device)


def prove_streaming(
    air: Air,
    trace: np.ndarray,
    publics: list[int],
    config: StarkConfig,
    shift: int = gold.COSET_SHIFT,
    aux=None,
    col_chunk: int | None = None,
    device=None,
    timing=None,
    mesh=None,
) -> StarkProof:
    """Drop-in replacement for stark.prove with bounded peak memory, on
    `device` (default: the card). The returned proof is bit-identical to
    stark.prove's for the same inputs; stark.verify accepts it unchanged.
    timing: a TimingTree to time the phases in (each scope synchronises).
    mesh: every rank calls this with the same arguments and gets the same
    proof (the schedule is in the module's docstring); device= must agree
    with the mesh's device (ValueError)."""
    device = resolve_with_mesh(device, mesh)

    def phase(name):
        return maybe_scope(timing, name, sync=device)

    n, n_cols = trace.shape
    assert n & (n - 1) == 0
    assert n_cols == air.n_cols
    assert air.max_degree <= config.blowup(), "rate too low for constraint degree"
    log_n = n.bit_length() - 1
    blowup = config.blowup()
    n_ext = n * blowup
    g = gold.root_of_unity(log_n)
    ch = min(config.cap_height, (n_ext - 1).bit_length())
    if mesh is not None:
        d = mesh.size
        assert d & (d - 1) == 0 and n_ext >= d, f"a mesh of {d} ranks needs a power of two <= {n_ext}"
    chunk = col_chunk or _auto_chunk(n_ext, n_cols, mesh)
    cache_ok = n * (n_cols + air.n_stage2) * WORD_BYTES <= COEFF_CACHE_BYTES

    challenger = Challenger()
    challenger.observe_many([v % P for v in publics])

    # --- phase 1: streamed trace commit -----------------------------------
    with phase("commit"):
        trace_src = _Source(trace, chunk, cache_ok, device)
        t_layers = _stream_commit(trace_src, config, shift, ch, mesh)
        trace_cap = merkle_ops.cap_to_ints(_as_tree(t_layers, ch))
        _observe_cap(challenger, trace_cap)

    with phase("aux + stage 2"):
        air.observe_aux(challenger, aux)
        chals = air.sample_challenges(challenger, aux)
        assert len(chals) == air.n_challenges
        chal_elems = [gf64.full((1,), v % P, device) for v in chals]

        n_s2 = air.n_stage2
        if n_s2:
            with phase("host stage 2"):
                s2 = air.build_stage2(trace, chals, aux)
            assert s2.shape == (n, n_s2)
            s2_src = _Source(np.asarray(s2, np.uint64) % P, chunk, cache_ok, device)
            s2_layers = _stream_commit(s2_src, config, shift, ch, mesh)
            s2_cap = merkle_ops.cap_to_ints(_as_tree(s2_layers, ch))
            _observe_cap(challenger, s2_cap)
        else:
            s2_src = _empty_source(n, chunk, device)
            s2_cap = []

    # --- phase 3: class-decomposed quotient --------------------------------
    with phase("quotient"):
        alpha = challenger.sample_ext()
        pub_elems = [gf64.full((1,), v % P, device) for v in publics]
        fixed_tab = air.fixed_columns(n)
        if fixed_tab is None or fixed_tab.shape[1] == 0:
            fixed_src = _empty_source(n, chunk, device)
        else:
            fixed_src = _Source(np.asarray(fixed_tab, np.uint64) % P, chunk, True, device)
        q_cols = _stream_quotient(
            air, trace_src, s2_src, fixed_src, pub_elems, _PowerTable(_ext_to_device(alpha, device)),
            chal_elems, n, config, shift, device, mesh,
        )
        del fixed_src
        q_chunk_coeffs, q_lde, q_layers = _quotient_commit(q_cols, n, config, shift, ch)
        del q_cols
        q_cap = merkle_ops.cap_to_ints(_as_tree(q_layers, ch))
        _observe_cap(challenger, q_cap)

    # --- phase 4: openings at zeta / g*zeta --------------------------------
    with phase("openings"):
        zeta = challenger.sample_ext()
        g_zeta = gold.ext_mul(zeta, (g, 0))
        zeta_d, g_zeta_d = _ext_to_device(zeta, device), _ext_to_device(g_zeta, device)
        pz = _ext_powers(zeta_d, n)
        pgz = _ext_powers(g_zeta_d, n)
        trace_zeta, trace_gzeta = _open_source(trace_src, pz, pgz)
        stage2_zeta, stage2_gzeta = _open_source(s2_src, pz, pgz)
        quotient_zeta = _ext_vec_to_host(_eval_columns_at(q_chunk_coeffs, pz))
        del pz, pgz
        for v in trace_zeta + trace_gzeta + stage2_zeta + stage2_gzeta + quotient_zeta:
            _observe_ext(challenger, v)

    # --- phase 5: DEEP composition (streamed accumulation) -----------------
    with phase("deep"):
        gamma = challenger.sample_ext()
        n_wit = n_cols + n_s2
        m_pows = 2 * n_wit + 2 * blowup
        g_pows = [(1, 0)]
        for _ in range(m_pows - 1):
            g_pows.append(gold.ext_mul(g_pows[-1], gamma))
        wit_zeta = trace_zeta + stage2_zeta
        wit_gzeta = trace_gzeta + stage2_gzeta
        ca = (0, 0)
        cb = (0, 0)
        for j in range(n_wit):
            ca = gold.ext_add(ca, gold.ext_mul(g_pows[j], wit_zeta[j]))
            cb = gold.ext_add(cb, gold.ext_mul(g_pows[n_wit + j], wit_gzeta[j]))
        for k2 in range(2 * blowup):
            ca = gold.ext_add(ca, gold.ext_mul(g_pows[2 * n_wit + k2], quotient_zeta[k2]))

        gp = _ext_powers(_ext_to_device(gamma, device), m_pows)

        def gp_slice(a, b):
            return tuple((c[0][a:b], c[1][a:b]) for c in gp)

        acc_a = gf64.ext_from_base(gf64.zeros((n_ext,), device))
        acc_b = gf64.ext_from_base(gf64.zeros((n_ext,), device))
        for src, base in ((trace_src, 0), (s2_src, n_cols)):
            for i, a, b in src.chunks(mesh):
                lde = ntt_ops.lde_cols(src.coeff_chunk(i), config.rate_bits, shift)
                acc_a = gf64.ext_add(acc_a, _weighted_sum(lde, gp_slice(base + a, base + b)))
                acc_b = gf64.ext_add(acc_b, _weighted_sum(lde, gp_slice(n_wit + base + a, n_wit + base + b)))
                del lde
        if mesh is not None:
            acc_a, acc_b = _ext_sum_over_ranks((acc_a, acc_b), mesh)
        acc_a = gf64.ext_add(acc_a, _weighted_sum(q_lde, gp_slice(2 * n_wit, 2 * n_wit + 2 * blowup)))
        deep_cw = _deep_divide(
            gf64.ext_sub(acc_a, _ext_to_device(ca, device)),
            gf64.ext_sub(acc_b, _ext_to_device(cb, device)),
            zeta_d, g_zeta_d, log_n + config.rate_bits, shift,
        )
        del acc_a, acc_b

    # --- phase 6: FRI + query openings -------------------------------------
    with phase("fri"):
        if mesh is not None:  # fri_ext takes this rank's rows
            r0, r1 = mesh.rank * (n_ext // mesh.size), (mesh.rank + 1) * (n_ext // mesh.size)
            deep_cw = tuple((c[0][r0:r1], c[1][r0:r1]) for c in deep_cw)
        fri_proof, indices = fri_prove_ext(deep_cw, config.fri(), challenger, shift, mesh=mesh)
        del deep_cw

    with phase("queries"):
        half = n_ext // 2
        positions = np.array([p for idx in indices for p in (idx % half, idx % half + half)], np.int64)
        pos_d = torch.from_numpy(positions).to(device)
        t_rows = _stream_rows(trace_src, pos_d, config.rate_bits, shift, mesh)
        s2_rows = _stream_rows(s2_src, pos_d, config.rate_bits, shift, mesh) if n_s2 else None
        q_rows = gf64.to_u64((q_lde[0].index_select(0, pos_d), q_lde[1].index_select(0, pos_d)))
        t_paths = _device_paths(t_layers, positions)
        q_paths = _device_paths(q_layers, positions)
        s2_paths = _device_paths(s2_layers, positions) if n_s2 else None

        def pair(rows, paths, qi):
            return tuple(RowOpening(row=[int(v) for v in rows[k]], path=paths[k]) for k in (2 * qi, 2 * qi + 1))

        openings = [
            QueryOpenings(
                trace=pair(t_rows, t_paths, qi),
                quotient=pair(q_rows, q_paths, qi),
                stage2=pair(s2_rows, s2_paths, qi) if n_s2 else None,
            )
            for qi in range(len(indices))
        ]
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
