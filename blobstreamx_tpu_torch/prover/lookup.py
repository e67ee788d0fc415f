"""logUp lookup argument on top of the two-stage STARK machinery (lookups
live inside one AIR).

Identity (Haböck's logUp): for lookup values v_j (witness columns), a table
column T (preprocessed) and multiplicities m (witness, committed BEFORE the
challenge), with a post-commit challenge β:

    Σ_rows Σ_j 1/(β - v_j)  ==  Σ_rows m/(β - T)

Rational terms are materialized as stage-2 witness columns (committed after
β is sampled) with degree-2 well-formedness constraints, and the running
difference accumulates in a stage-2 column pinned to zero on the last row:

    w_j (β - v_j) = 1          wm (β - T) = m
    A_first = Σ w_j - wm       A' = A + Σ w_j' - wm'       A_last = 0

Soundness: β is sampled after v/m are committed. The PRODUCTION variant
(`*_multi_ext`, used by the Ed25519 AIR) samples β from GF(p²) = GF(p)[X]/
(X²-7): a cheating multiset must make the rational identity hold at the
random β, i.e. β must hit a root of a nonzero rational function with at most
(k+nt)·n ≈ 2^27 poles/zeros — probability ≤ 2^27 / p² ≈ 2^-101. The ext element is carried as TWO base-field
challenge slots (β₀, β₁) and every ext constraint splits into its two GF(p)
components, so the two-stage STARK machinery (base-field quotient) is
untouched. The base-field single-table variant (`eval_logup_constraints`)
is kept for unit tests and small gadgets; its bound is only ~n·k/p ≈ 2^-40
and it must not guard a production table.

Helpers here are algebra-generic (device + host verifier), so an AIR mixes
lookups in by reserving stage-2 columns and calling the eval helpers from
its eval_constraints. The host builders of the multi-table variants do their
mod-p arithmetic on whole uint64 numpy arrays (_add_mod, _mul_mod,
_rowsum_mod); their words equal the JAX package's element-wise Python loops.
"""

from __future__ import annotations

import numpy as np

from blobstreamx_tpu_torch.golden import goldilocks as gold

P = gold.P
_P = np.uint64(P)
_EPS = np.uint64((1 << 64) - P)  # 2^32 - 1 = 2^64 mod p
_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)
_BITMAP_LIMIT = 1 << 26  # the builders' bitmap of distinct values covers [0, 2^26)
_ROW_BLOCK = 2048  # rows of the stage-2 builder's wells computed at once


# ----------------------------------------------------------------------------
# vectorized mod-p arithmetic on uint64 numpy arrays of canonical values
# (uint64 array arithmetic wraps modulo 2^64; each carry is recovered by a
# compare)
# ----------------------------------------------------------------------------


def _canon(x: np.ndarray) -> np.ndarray:
    """x mod p for any uint64 x (x < 2^64 < 2p)."""
    return np.where(x >= _P, x - _P, x)


def _add_mod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a + b) mod p for canonical a, b: subtract p when the sum reaches p
    or wraps (a wrapped s stands for s + 2^64, and s + 2^64 - p wraps to
    s - p as well)."""
    s = a + b
    return np.where((s < a) | (s >= _P), s - _P, s)


def _reduce128(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(hi * 2^64 + lo) mod p, with 2^64 = EPS and 2^96 = -1 (mod p)."""
    hh, hl = hi >> _S32, hi & _M32
    t0 = lo - hh
    t0 = np.where(lo < hh, t0 - _EPS, t0)
    t1 = hl * _EPS
    t2 = t0 + t1
    return _canon(np.where(t2 < t1, t2 + _EPS, t2))


def _mul_mod(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a * b) mod p for canonical a, b: the 128-bit product from four 32x32
    partial products, then _reduce128."""
    a0, a1 = a & _M32, a >> _S32
    b0, b1 = b & _M32, b >> _S32
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = p01 + p10
    mid_carry = (mid < p01).astype(np.uint64)
    lo = p00 + (mid << _S32)
    lo_carry = (lo < p00).astype(np.uint64)
    hi = p11 + (mid >> _S32) + (mid_carry << _S32) + lo_carry
    return _reduce128(lo, hi)


def _rowsum_mod(m: np.ndarray) -> np.ndarray:
    """Row sums mod p of an (n, k) matrix of canonical values (k < 2^31):
    the low and high 32-bit halves sum exactly, then one 128-bit reduce."""
    lo = (m & _M32).sum(axis=1, dtype=np.uint64)
    hi = (m >> _S32).sum(axis=1, dtype=np.uint64)
    low = lo + ((hi & _M32) << _S32)
    carry = (low < lo).astype(np.uint64)
    return _reduce128(low, (hi >> _S32) + carry)


def _prefix_sums(sw: np.ndarray, swm: np.ndarray) -> tuple[np.ndarray, int]:
    """A[i] = sum_{j <= i} (sw[j] - swm[j]) mod p, and the last value."""
    out = np.zeros(sw.shape[0], dtype=np.uint64)
    acc = 0
    for i, (a, b) in enumerate(zip(sw.tolist(), swm.tolist())):
        acc = (acc + a - b) % P
        out[i] = acc
    return out, acc


def _distinct(*arrays: np.ndarray):
    """(sorted distinct values of all arrays, index_of) where index_of(x)
    maps an array of those values to their positions in the sorted set,
    found by a bitmap over [0, max]. The tables hold 16-bit limbs; a value
    at or above _BITMAP_LIMIT is refused."""
    top = max(int(a.max()) if a.size else 0 for a in arrays)
    if top >= _BITMAP_LIMIT:
        raise ValueError(f"lookup value {top} above the builder's limit {_BITMAP_LIMIT}")
    present = np.zeros(top + 1, dtype=bool)
    for a in arrays:
        present[a] = True
    uniq = np.flatnonzero(present).astype(np.uint64)
    pos = np.cumsum(present, dtype=np.int64) - 1

    def index_of(x: np.ndarray) -> np.ndarray:
        return pos[x]

    return uniq, index_of


def n_stage2_cols(n_lookup_cols: int) -> int:
    """w per lookup column + wm + accumulator A."""
    return n_lookup_cols + 2


def eval_logup_constraints(alg, beta, values, values_next, mult, mult_next,
                           table, table_next, stage2, stage2_next):
    """Constraint list for one logUp instance.

    values/values_next: the k lookup columns (local / next frame);
    mult: multiplicity column; table: the preprocessed table column;
    stage2 layout: [w_0..w_{k-1}, wm, A]. Returns [(value, kind), ...].
    """
    k = len(values)
    ws = stage2[:k]
    wm = stage2[k]
    acc = stage2[k + 1]
    ws_n = stage2_next[:k]
    wm_n = stage2_next[k]
    acc_n = stage2_next[k + 1]
    one = alg.const(1)
    cs = []
    for j in range(k):
        cs.append((alg.sub(alg.mul(ws[j], alg.sub(beta, values[j])), one), "all"))
    cs.append((alg.sub(alg.mul(wm, alg.sub(beta, table)), mult), "all"))

    def delta(ws_, wm_):
        d = ws_[0]
        for j in range(1, k):
            d = alg.add(d, ws_[j])
        return alg.sub(d, wm_)

    cs.append((alg.sub(acc, delta(ws, wm)), "first"))
    cs.append((alg.sub(acc_n, alg.add(acc, delta(ws_n, wm_n))), "transition"))
    cs.append((acc, "last"))
    return cs


def build_logup_stage2(values: np.ndarray, mult: np.ndarray, table: np.ndarray,
                       beta: int) -> np.ndarray:
    """Host construction of [w_0..w_{k-1}, wm, A] for an (n, k) lookup-value
    matrix, (n,) multiplicities and (n,) table."""
    n, k = values.shape
    out = np.zeros((n, k + 2), dtype=np.uint64)
    acc = 0
    for i in range(n):
        d = 0
        for j in range(k):
            w = gold.inv((beta - int(values[i, j])) % P)
            out[i, j] = w
            d = (d + w) % P
        wm = (int(mult[i]) * gold.inv((beta - int(table[i])) % P)) % P
        out[i, k] = wm
        acc = (acc + d - wm) % P
        out[i, k + 1] = acc
    assert acc == 0, "lookup multiset mismatch (witness bug)"
    return out


def multiplicities(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    """Count how often each table row's value appears among the lookups."""
    from collections import Counter

    counts = Counter(int(v) for v in values.reshape(-1))
    return np.array([counts.get(int(t), 0) for t in table], dtype=np.uint64)


# ----------------------------------------------------------------------------
# multi-table-column generalization: Σ_rows Σ_j 1/(β-v_j) == Σ_rows Σ_t m_t/(β-T_t)
# lets a table larger than the trace height (e.g. the 16-bit limb range table
# of the Ed25519 STARK, prover.ed_air) spread over ceil(|T|/n) fixed
# columns, each with its own multiplicity column.
# ----------------------------------------------------------------------------


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


def n_stage2_cols_multi(n_lookup_cols: int, n_table_cols: int) -> int:
    """w per lookup column + wm per table column + accumulator A."""
    return n_lookup_cols + n_table_cols + 1


def range_table_columns(n: int, bits: int = 16) -> np.ndarray:
    """(n, nt) fixed table columns jointly covering [0, 2^bits). When the
    trace is taller than the table, the tail repeats the top value (its
    multiplicity is assigned at the first occurrence only)."""
    size = 1 << bits
    nt = (size + n - 1) // n
    t = np.arange(n, dtype=np.int64)[:, None] + n * np.arange(nt, dtype=np.int64)[None, :]
    return np.minimum(t, size - 1).astype(np.uint64)


def multiplicities_multi(values: np.ndarray, table: np.ndarray) -> np.ndarray:
    """(n, nt) multiplicity matrix: each distinct table value's count lands at
    its first occurrence (in flat row-major order), zero at repeats."""
    size = int(table.max()) + 1
    counts = np.bincount(values.reshape(-1).astype(np.int64), minlength=size)
    assert counts.size <= size, "lookup value outside the table range"
    flat = table.reshape(-1)
    uniq, first_idx = np.unique(flat, return_index=True)
    m_flat = np.zeros(flat.size, dtype=np.uint64)
    m_flat[first_idx] = counts[uniq.astype(np.int64)]
    return m_flat.reshape(table.shape)


def eval_logup_multi(alg, beta, values_m, mult_m, table_m, values_m_next,
                     mult_m_next, table_m_next, stage2, stage2_next,
                     n_vals: int, n_tabs: int):
    """Matrix-form logUp with multiple table columns.

    values_m (width n_vals), mult_m / table_m (width n_tabs) are algebra
    matrices; stage2 layout: [w_0..w_{k-1}, wm_0..wm_{t-1}, A] (elements,
    starting at stage2 index 0 — pass the frame itself, which may be a lazy
    matrix view: frame_block then slices whole blocks instead of stacking
    1000 columns, see air.frame_block). Returns [(value, kind), ...]."""
    from .air import frame_block

    k, nt = n_vals, n_tabs
    w_m = frame_block(alg, stage2, 0, k)
    wm_m = frame_block(alg, stage2, k, k + nt)
    acc = stage2[k + nt]
    w_mn = frame_block(alg, stage2_next, 0, k)
    wm_mn = frame_block(alg, stage2_next, k, k + nt)
    acc_n = stage2_next[k + nt]
    cs = []
    cs.append(
        (alg.sub(alg.mul(w_m, alg.sub(beta, values_m)), alg.const_row([1] * k)), "all")
    )
    cs.append((alg.sub(alg.mul(wm_m, alg.sub(beta, table_m)), mult_m), "all"))

    def delta(w_, wm_):
        return alg.sub(alg.sum_cols(w_), alg.sum_cols(wm_))

    cs.append((alg.sub(acc, delta(w_m, wm_m)), "first"))
    cs.append((alg.sub(acc_n, alg.add(acc, delta(w_mn, wm_mn))), "transition"))
    cs.append((acc, "last"))
    return cs


def build_logup_stage2_multi(values: np.ndarray, mult: np.ndarray,
                             table: np.ndarray, beta: int) -> np.ndarray:
    """Host construction of [w.., wm.., A] for (n, k) small-range lookup
    values, (n, nt) multiplicities and (n, nt) table columns.

    1/(β-v) is computed once a DISTINCT value (≤ |table| of them, one batch
    inversion), so the big (n, k) matrix is a numpy gather, not n*k modular
    inversions."""
    n, k = values.shape
    uniq, index_of = _distinct(values, table)
    inv_arr = np.array(
        _batch_inv([(beta - int(u)) % P for u in uniq]), dtype=np.uint64
    )
    W = inv_arr[index_of(values)]
    WM = _mul_mod(mult.astype(np.uint64), inv_arr[index_of(table)])
    A, acc = _prefix_sums(_rowsum_mod(W), _rowsum_mod(WM))
    assert acc == 0, "lookup multiset mismatch (witness bug)"
    return np.concatenate([W, WM, A[:, None]], axis=1)


# ----------------------------------------------------------------------------
# GF(p^2)-challenge variant (production): beta = (b0, b1) in GF(p)[X]/(X^2-7).
# Stage-2 rational columns become ext pairs — layout
#   [w0_0..w0_{k-1}, w1_0..w1_{k-1}, wm0_0..wm0_{t-1}, wm1_0..wm1_{t-1}, A0, A1]
# and every ext equation contributes its two GF(p) component constraints.
# ----------------------------------------------------------------------------

EXT_W = gold.EXT_W  # X^2 = 7


def n_stage2_cols_multi_ext(n_lookup_cols: int, n_table_cols: int) -> int:
    """Paired ext wells: one GF(p²) well (2 base columns) per PAIR of lookup
    columns (logUp numerator batching — w·(β−v₁)(β−v₂) = 2β−v₁−v₂, degree 3),
    + (wm0, wm1) per table column + (A0, A1). The k value wells keep the old
    base-field budget (k columns); the table wells and accumulator double
    (2·nt + 2 vs nt + 1) — the price of the 2^-101 ext-challenge soundness."""
    q = n_lookup_cols // 2 + n_lookup_cols % 2
    # NB vs the old base-field layout (k + nt + 1): the k value wells stay at
    # k base columns (2 per ext well x k/2 paired wells), while the table
    # wells and the accumulator DOUBLE (2*nt vs nt, 2 vs 1) — the ext
    # challenge costs nt+1 extra columns, not zero.
    return 2 * q + 2 * n_table_cols + 2


def _evens_odds(m):
    """Split a width-k algebra matrix into its even / odd columns (device:
    tuple of (n, k) arrays; host verifier: list of ext pairs)."""
    if isinstance(m, list):
        return m[0::2], m[1::2]
    return tuple(c[:, 0::2] for c in m), tuple(c[:, 1::2] for c in m)


def _last_col(m):
    if isinstance(m, list):
        return m[-1]
    return tuple(c[:, -1] for c in m)


def eval_logup_multi_ext(alg, beta0, beta1, values_m, mult_m, table_m,
                         values_m_next, mult_m_next, table_m_next,
                         stage2, stage2_next, n_vals: int, n_tabs: int):
    """Matrix-form logUp with a GF(p²) challenge and PAIRED wells.

    For a pair (va, vb) the committed ext well u satisfies
        u · (β − va) · (β − vb) = (β − va) + (β − vb) = 2β − va − vb
    i.e. u = 1/(β−va) + 1/(β−vb) — one well sums two reciprocals, halving
    the stage-2 column count (Haböck logUp numerator batching). With
    q = (β−va)(β−vb) = (s·t + 7·b₁², (s+t)·b₁), s = b₀−va, t = b₀−vb, the
    X²=7 component constraints are (degree 3 in committed columns):
        re: u0·q0 + u1·(7·q1) − (s + t) = 0
        im: u0·q1 + u1·q0 − 2·b₁       = 0
    An odd trailing column keeps a single degree-2 well u·(β−v) = 1.
    Table wells stay single (wm·(β−T) = m). The accumulator runs
    componentwise over Σu − Σwm.
    """
    from .air import frame_block

    k, nt = n_vals, n_tabs
    npairs, rem = k // 2, k % 2
    q_wells = npairs + rem
    u0 = frame_block(alg, stage2, 0, q_wells)
    u1 = frame_block(alg, stage2, q_wells, 2 * q_wells)
    wm0 = frame_block(alg, stage2, 2 * q_wells, 2 * q_wells + nt)
    wm1 = frame_block(alg, stage2, 2 * q_wells + nt, 2 * q_wells + 2 * nt)
    a0 = stage2[2 * q_wells + 2 * nt]
    a1 = stage2[2 * q_wells + 2 * nt + 1]
    u0n = frame_block(alg, stage2_next, 0, q_wells)
    u1n = frame_block(alg, stage2_next, q_wells, 2 * q_wells)
    wm0n = frame_block(alg, stage2_next, 2 * q_wells, 2 * q_wells + nt)
    wm1n = frame_block(alg, stage2_next, 2 * q_wells + nt, 2 * q_wells + 2 * nt)
    a0n = stage2_next[2 * q_wells + 2 * nt]
    a1n = stage2_next[2 * q_wells + 2 * nt + 1]

    # small scalar constants from the challenge, built by ADDS so they keep
    # the challenge's scalar shape in both algebra worlds (alg.const is
    # full-height in the device world and breaks matrix broadcasting)
    b1x2 = alg.add(beta1, beta1)
    b1x4 = alg.add(b1x2, b1x2)
    seven_b1 = alg.add(alg.add(b1x4, b1x2), beta1)
    b1sq7 = alg.mul(seven_b1, beta1)  # 7·b₁²

    cs = []
    if npairs:
        if rem:
            # paired part uses columns [0, 2*npairs); the trailing single
            # well gets its own constraints below
            def drop_last(m):
                if isinstance(m, list):
                    return m[:-1]
                return tuple(c[:, :-1] for c in m)

            paired_vals = drop_last(values_m)
            up0, up1 = (
                (u0[:-1], u1[:-1])
                if isinstance(u0, list)
                else (tuple(c[:, :-1] for c in u0), tuple(c[:, :-1] for c in u1))
            )
        else:
            paired_vals = values_m
            up0, up1 = u0, u1
        va, vb = _evens_odds(paired_vals)
        s = alg.sub(beta0, va)
        t = alg.sub(beta0, vb)
        st_sum = alg.add(s, t)
        q0 = alg.add(alg.mul(s, t), b1sq7)
        q1 = alg.mul(st_sum, beta1)
        cs.append((
            alg.sub(
                alg.add(alg.mul(up0, q0), alg.mul(up1, alg.mul(st_sum, seven_b1))),
                st_sum,
            ),
            "all",
        ))
        cs.append((
            alg.sub(alg.add(alg.mul(up0, q1), alg.mul(up1, q0)), b1x2),
            "all",
        ))
    if rem:
        v_last = _last_col(values_m)
        ul0, ul1 = _last_col(u0), _last_col(u1)
        one = alg.const(1)
        bmv = alg.sub(beta0, v_last)
        cs.append((
            alg.sub(alg.add(alg.mul(ul0, bmv), alg.mul(ul1, seven_b1)), one),
            "all",
        ))
        cs.append((alg.add(alg.mul(ul0, beta1), alg.mul(ul1, bmv)), "all"))

    # table wells
    bmt = alg.sub(beta0, table_m)
    cs.append((
        alg.sub(alg.add(alg.mul(wm0, bmt), alg.mul(wm1, seven_b1)), mult_m),
        "all",
    ))
    cs.append((alg.add(alg.mul(wm0, beta1), alg.mul(wm1, bmt)), "all"))

    def delta(ws, wms):
        return alg.sub(alg.sum_cols(ws), alg.sum_cols(wms))

    d0, d1 = delta(u0, wm0), delta(u1, wm1)
    d0n, d1n = delta(u0n, wm0n), delta(u1n, wm1n)
    cs.append((alg.sub(a0, d0), "first"))
    cs.append((alg.sub(a1, d1), "first"))
    cs.append((alg.sub(a0n, alg.add(a0, d0n)), "transition"))
    cs.append((alg.sub(a1n, alg.add(a1, d1n)), "transition"))
    cs.append((a0, "last"))
    cs.append((a1, "last"))
    return cs


def build_logup_stage2_multi_ext(values: np.ndarray, mult: np.ndarray,
                                 table: np.ndarray, beta: tuple[int, int]) -> np.ndarray:
    """Host construction of [u0.., u1.., wm0.., wm1.., A0, A1] for (n, k)
    small-range lookup values, (n, nt) multiplicities and (n, nt) tables,
    with PAIRED wells: u_i = 1/(β−v_{2i}) + 1/(β−v_{2i+1}) (a trailing odd
    column keeps a single-reciprocal well).

    1/(β − u) in GF(p²) for base u: with a = (b0 − u, b1), a⁻¹ =
    (a0, −a1) / (a0² − 7·b1²); the norms over the DISTINCT value set get one
    Montgomery batch inversion, the big matrices are numpy gathers and
    whole-array mod-p sums and products."""
    b0, b1 = int(beta[0]) % P, int(beta[1]) % P
    n, k = values.shape
    uniq, index_of = _distinct(values, table)
    sq_b1_7 = (EXT_W * b1 * b1) % P
    norms = [((b0 - u) * (b0 - u) - sq_b1_7) % P for u in uniq.tolist()]
    if any(nv == 0 for nv in norms):
        # beta collided with a table/value element (possible only when
        # beta1 = 0 mod P, ~2^-64 per transcript): a zero norm would corrupt
        # EVERY inverse in the Montgomery batch silently. Fail stop with a
        # clear message; the caller re-proves, drawing a fresh transcript.
        raise ValueError("logUp challenge beta collides with a looked-up value")
    inv_norms = _batch_inv(norms)
    re_arr = np.array(
        [((b0 - u) * iv) % P for u, iv in zip(uniq.tolist(), inv_norms)], dtype=np.uint64
    )
    im_arr = np.array([(-b1 * iv) % P for iv in inv_norms], dtype=np.uint64)

    npairs, rem = k // 2, k % 2
    q = npairs + rem
    nt = table.shape[1]
    out = np.empty((n, 2 * q + 2 * nt + 2), dtype=np.uint64)
    sw = (np.empty(n, dtype=np.uint64), np.empty(n, dtype=np.uint64))
    # paired wells: columnwise sums of the two reciprocals, gathered straight
    # from the even and the odd columns' indices, a block of rows at a time
    # (the block's temporaries stay in cache)
    for a in range(0, n, _ROW_BLOCK):
        b = min(n, a + _ROW_BLOCK)
        vi = index_of(values[a:b])
        even, odd = vi[:, 0 : 2 * npairs : 2], vi[:, 1 : 2 * npairs : 2]
        for part, arr in enumerate((re_arr, im_arr)):
            wells = out[a:b, part * q : (part + 1) * q]
            wells[:, :npairs] = _add_mod(arr[even], arr[odd])
            if rem:
                wells[:, npairs] = arr[vi[:, -1]]
            sw[part][a:b] = _rowsum_mod(wells)

    ti = index_of(table)
    m = mult.astype(np.uint64)
    for part, arr in enumerate((re_arr, im_arr)):
        wm = _mul_mod(m, arr[ti])
        out[:, 2 * q + part * nt : 2 * q + (part + 1) * nt] = wm
        acc_col, acc = _prefix_sums(sw[part], _rowsum_mod(wm))
        assert acc == 0, "lookup multiset mismatch (witness bug)"
        out[:, 2 * q + 2 * nt + part] = acc_col
    return out
