"""The port's Ed25519 STARK components (prover.gf25519_gadget, prover.lookup,
prover.ed_air, prover.ed_claims) against the JAX package on the CPU, exact
equality throughout: the multiplication and Edwards-addition witnesses, the
lookup builders (the port's whole-array mod-p arithmetic against the JAX
package's element-wise loops, at small sizes, at the limb range's ends and
at 4 and 16 segments), the evaluators, the trace builder at 1 and 4
segments, the AIR's fixed columns, challenges, stage 2 and claim fold, its
constraints at random GF(p^2) frames, the constraints vanishing on the plain
domain under the port's DeviceAlgebra, and the batch equation's pairs.

The slow test proves the one-segment scalar-mul trace of tests/test_ed_air.py
on the CPU with the port's stark.prove under that test's config: both
packages' serializers give its bytes, both packages' verifiers accept it and
reject the tampered scalar and result point. (The JAX package's own prove of
this trace did not finish on the CPU in three hours, so its bytes are not a
fixture here; ROADMAP.md queue 3.)"""


import numpy as np
import pytest
import torch

from blobstreamx_tpu.golden.challenger import Challenger as JaxChallenger
from blobstreamx_tpu.prover import ed_air as jax_ed_air, ed_claims as jax_ed_claims
from blobstreamx_tpu.prover import gf25519_gadget as jax_gg, lookup as jax_lookup
from blobstreamx_tpu.prover.air import HostExtAlgebra as JaxHostExtAlgebra
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.golden import ed25519 as ged, goldilocks as gold
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.prover import ed_air, ed_claims, gf25519_gadget as gg, lookup
from blobstreamx_tpu_torch.prover.air import DeviceAlgebra, HostExtAlgebra

torch.set_num_threads(1)
P = gold.P
Q = ged.Q
SEGMENTS = (1, 4)
ROUNDTRIP_SCALAR = 0x1234567890ABCDEF1234567890ABCDEF  # tests/test_ed_air.py's roundtrip
# tests/test_ed_air.py's roundtrip config
ROUNDTRIP_CFG = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=6, final_poly_len=8)


def _affine(p):
    zi = pow(p[2], Q - 2, Q)
    return (p[0] * zi % Q, p[1] * zi % Q)


def _pairs(n_segments: int):
    """Seeded (scalar, affine point) pairs; segment 0 has scalar 0 (lands on
    the identity) and segment 1, when there, L - 1."""
    rng = np.random.default_rng(n_segments)
    pairs = []
    for i in range(n_segments):
        s = int.from_bytes(rng.bytes(32), "little") % (1 << ed_air.BITS)
        pairs.append((s, _affine(ged.point_mul(i + 3, ged.BASE))))
    pairs[0] = (0, pairs[0][1])
    if n_segments > 1:
        pairs[1] = (ged.L - 1, pairs[1][1])
    return pairs


@pytest.fixture(scope="module")
def traces():
    out = {}
    for s in SEGMENTS:
        pairs = _pairs(s)
        out[s] = (pairs,) + ed_air.build_ed_trace(pairs)
    return out


def _field_ints(rng, k):
    vals = [int.from_bytes(rng.bytes(32), "little") % Q for _ in range(k)]
    return vals + [0, 1, Q - 1, Q - 19]


# ----------------------------------------------------------------------------
# gf25519_gadget
# ----------------------------------------------------------------------------


def _mul_operands(rng):
    """Canonical operands, signed linear combinations (differences go
    negative, sums reach 2^17) and the ends of the range."""
    ints = _field_ints(rng, 4)
    ops = [(gg.to_limbs(a), gg.to_limbs(b)) for a, b in zip(ints, reversed(ints))]
    a1, a2 = gg.to_limbs(5), gg.to_limbs(Q - 3)
    ops.append(([x - y for x, y in zip(a1, a2)], gg.to_limbs(7)))
    ops.append(([x + y for x, y in zip(a2, a2)], [x - y for x, y in zip(a1, a2)]))
    return ops


def test_mul_and_edwards_add_witnesses_equal_jax():
    rng = np.random.default_rng(5)
    for a, b in _mul_operands(rng):
        w, jw = gg.MulWitness(a, b), jax_gg.MulWitness(a, b)
        assert w.c == jw.c and w.witness_columns() == jw.witness_columns()
        assert len(w.witness_columns()) == gg.N_MUL_WITNESS == 99
    pts = [ged.point_mul(k, ged.BASE) for k in (1, 2, 12345)] + [ged.IDENTITY]
    for p in pts:
        for q in pts:
            w, jw = gg.EdAddWitness(p, q), jax_gg.EdAddWitness(p, q)
            assert w.columns() == jw.columns() and w.out == jw.out
            assert ged.point_equal(w.out, ged.point_add(p, q))
    assert (gg.OFFCONST, gg.TWO_D_LIMBS, gg.range_checked_columns()) == (
        jax_gg.OFFCONST, jax_gg.TWO_D_LIMBS, jax_gg.range_checked_columns())


def _signed_rows(rows):
    return np.array([[v % P for v in row] for row in rows], dtype=np.uint64)


def _device_cols(rows: np.ndarray):
    gl = gf64.from_u64(rows)
    return DeviceAlgebra((rows.shape[0],), "cpu"), [(gl[0][:, j], gl[1][:, j]) for j in range(rows.shape[1])]


def _to_ints(value):
    v = gf64.to_u64(value)
    return v[:, None] if v.ndim == 1 else v


def test_mul_constraints_equal_jax_and_vanish():
    """eval_mul_constraints and each Edwards-add group: the port's
    DeviceAlgebra over witness rows gives, row by row, the JAX package's
    HostExtAlgebra value at that row (all zero on honest rows, not on a
    flipped bit), and both packages agree at a random GF(p^2) frame."""
    rng = np.random.default_rng(6)
    ops = _mul_operands(rng)
    rows = _signed_rows([list(a) + list(b) + gg.MulWitness(a, b).witness_columns() for a, b in ops])
    rows = np.concatenate([rows, rows[:1]])
    rows[-1, 2 * gg.N_LIMBS] ^= 1  # c_0 of a copy of row 0
    alg, cols = _device_cols(rows)
    L = gg.N_LIMBS
    got = _to_ints(gg.eval_mul_constraints(alg, cols[:L], cols[L : 2 * L], cols[2 * L :])[0][0])
    j_alg = JaxHostExtAlgebra()
    for i, row in enumerate(rows.tolist()):
        el = [(v, 0) for v in row]
        (want, kind), = jax_gg.eval_mul_constraints(j_alg, el[:L], el[L : 2 * L], el[2 * L :])
        assert kind == "all" and [x[1] for x in want] == [0] * 34
        assert got[i].tolist() == [x[0] for x in want]
    assert not got[:-1].any() and got[-1].any()

    pts = [ged.point_mul(k, ged.BASE) for k in (3, 7)] + [ged.IDENTITY]
    add_rows = _signed_rows([gg.EdAddWitness(p, q).columns() for p in pts for q in pts])
    alg, cols = _device_cols(add_rows)
    for idx in range(len(gg.MUL_NAMES)):
        (value, kind), = gg.eval_ed_add_group(alg, cols, idx)
        assert kind == "all" and not gf64.to_u64(value).any()
    ext = [(int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)))
           for _ in range(gg.N_EDADD_COLS)]
    assert gg.eval_ed_add_constraints(HostExtAlgebra(), ext) == jax_gg.eval_ed_add_constraints(
        JaxHostExtAlgebra(), ext)


# ----------------------------------------------------------------------------
# lookup
# ----------------------------------------------------------------------------


def test_lookup_mod_p_arithmetic_at_the_edges():
    """The whole-array helpers against Python integers on values near p,
    2^32 and 2^63 (where a uint64 sum or partial product wraps)."""
    edges = [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, 1 << 63, P - (1 << 32)]
    rng = np.random.default_rng(12)
    vals = edges + [int(v) for v in rng.integers(0, P, size=40, dtype=np.uint64)]
    a = np.array([x for x in vals for _ in vals], dtype=np.uint64)
    b = np.array([y for _ in vals for y in vals], dtype=np.uint64)
    assert lookup._add_mod(a, b).tolist() == [(x + y) % P for x, y in zip(a.tolist(), b.tolist())]
    assert lookup._mul_mod(a, b).tolist() == [(x * y) % P for x, y in zip(a.tolist(), b.tolist())]
    m = a.reshape(len(vals), len(vals))
    assert lookup._rowsum_mod(m).tolist() == [sum(row) % P for row in m.tolist()]


def _lookup_inputs(n: int, k: int, bits: int, seed: int):
    """Seeded (n, k) values in [0, 2^bits) with both ends of the range
    present, the range table and its multiplicities."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 1 << bits, size=(n, k), dtype=np.uint64)
    values[0, 0], values[-1, -1] = 0, (1 << bits) - 1
    table = lookup.range_table_columns(n, bits)
    return values, table, lookup.multiplicities_multi(values, table)


@pytest.mark.parametrize("n,k,bits", [(32, 5, 8), (64, 4, 16), (16, 1, 4), (8, 3, 3)])
def test_lookup_builders_equal_jax(n, k, bits):
    values, table, mult = _lookup_inputs(n, k, bits, seed=n + k)
    assert np.array_equal(table, jax_lookup.range_table_columns(n, bits))
    assert np.array_equal(mult, jax_lookup.multiplicities_multi(values, table))
    assert int(mult.sum()) == n * k
    nt = table.shape[1]
    assert lookup.n_stage2_cols_multi(k, nt) == jax_lookup.n_stage2_cols_multi(k, nt)
    assert lookup.n_stage2_cols_multi_ext(k, nt) == jax_lookup.n_stage2_cols_multi_ext(k, nt)
    assert lookup.n_stage2_cols(k) == jax_lookup.n_stage2_cols(k)
    for beta in (0x1234567, P - 1):
        s2 = lookup.build_logup_stage2_multi(values, mult, table, beta)
        assert np.array_equal(s2, jax_lookup.build_logup_stage2_multi(values, mult, table, beta))
    for beta in ((0xABCDEF12, 0x13572468), (P - 1, P - 1), (5, 1)):
        s2 = lookup.build_logup_stage2_multi_ext(values, mult, table, beta)
        assert np.array_equal(s2, jax_lookup.build_logup_stage2_multi_ext(values, mult, table, beta))
        assert s2.shape == (n, lookup.n_stage2_cols_multi_ext(k, nt)) and not s2[-1, -2:].any()
    # the single-table builder (unchanged code) on a table as tall as the trace
    v1 = values[:, :1] % np.uint64(n)
    t1 = np.arange(n, dtype=np.uint64)
    m1 = lookup.multiplicities(v1, t1)
    assert np.array_equal(m1, jax_lookup.multiplicities(v1, t1))
    assert np.array_equal(lookup.build_logup_stage2(v1, m1, t1, 77), jax_lookup.build_logup_stage2(v1, m1, t1, 77))


def test_lookup_refusals_equal_jax():
    """A zero norm (beta1 = 0, beta0 a looked-up value) is refused before the
    batch inversion; a value outside the table or a forged multiplicity trips
    the closing check; both packages alike."""
    values, table, mult = _lookup_inputs(16, 3, 4, seed=3)
    for mod in (lookup, jax_lookup):
        with pytest.raises(ValueError, match="collides"):
            mod.build_logup_stage2_multi_ext(values, mult, table, (int(values[2, 1]), 0))
        forged = mult.copy()
        forged[0, 0] += np.uint64(1)
        with pytest.raises(AssertionError, match="multiset mismatch"):
            mod.build_logup_stage2_multi_ext(values, forged, table, (11, 13))
        with pytest.raises(AssertionError, match="multiset mismatch"):
            mod.build_logup_stage2_multi(values, forged, table, 0x1234567)


def test_lookup_distinct_values():
    """_distinct gives np.unique's set and positions, and refuses a value at
    or above its bitmap's limit (the JAX package's builders would take it
    and fail the closing check)."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 10, size=(50, 3), dtype=np.uint64)
    b = np.arange(7, dtype=np.uint64)
    uniq, index_of = lookup._distinct(a, b)
    assert np.array_equal(uniq, np.unique(np.concatenate([a.ravel(), b])))
    assert np.array_equal(uniq[index_of(a)], a)
    big = a.copy()
    big[3, 1] = np.uint64(lookup._BITMAP_LIMIT)
    with pytest.raises(ValueError, match="above the builder's limit"):
        lookup.build_logup_stage2_multi_ext(big, np.zeros((50, 1), np.uint64),
                                            np.arange(50, dtype=np.uint64)[:, None], (3, 5))


@pytest.mark.parametrize("segments", [4, 16])
def test_stage2_builder_equals_jax_word_for_word(traces, segments):
    """The Ed AIR's stage-2 lookup block at its real shapes: the limb columns
    of the 4-segment trace, and seeded limbs at 16 segments' (8192, 939)."""
    if segments in traces:
        _, trace, _ = traces[segments]
        values = trace[:, ed_air.OFF_WIT : ed_air.OFF_WIT + ed_air.N_LOOKUP]
        table = lookup.range_table_columns(trace.shape[0])
        mult = trace[:, ed_air.OFF_MULT :]
    else:
        values, table, mult = _lookup_inputs(ed_air.SEG * segments, ed_air.N_LOOKUP, 16, seed=segments)
    beta = (0x0123456789ABCDEF % P, 0xFEDCBA9876543210 % P)
    got = lookup.build_logup_stage2_multi_ext(values, mult, table, beta)
    assert np.array_equal(got, jax_lookup.build_logup_stage2_multi_ext(values, mult, table, beta))


def _lookup_frame(rng, k, nt, ext):
    def rnd():
        return (int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)) if ext else 0)

    n_s2 = lookup.n_stage2_cols_multi_ext(k, nt)
    return dict(
        beta0=rnd(), beta1=rnd(), values_m=[rnd() for _ in range(k)], mult_m=[rnd() for _ in range(nt)],
        table_m=[rnd() for _ in range(nt)], values_m_next=[rnd() for _ in range(k)],
        mult_m_next=[rnd() for _ in range(nt)], table_m_next=[rnd() for _ in range(nt)],
        stage2=[rnd() for _ in range(n_s2)], stage2_next=[rnd() for _ in range(n_s2)],
    )


@pytest.mark.parametrize("k,nt", [(5, 2), (4, 1), (1, 3)])
def test_lookup_evaluators_equal_jax(k, nt):
    """The evaluators at random GF(p^2) frames: eval_logup_multi_ext (odd,
    even and single value columns), eval_logup_multi and
    eval_logup_constraints equal the JAX package's."""
    rng = np.random.default_rng(k * 10 + nt)
    f = _lookup_frame(rng, k, nt, ext=True)
    alg, j_alg = HostExtAlgebra(), JaxHostExtAlgebra()
    args = (f["beta0"], f["beta1"], f["values_m"], f["mult_m"], f["table_m"], f["values_m_next"],
            f["mult_m_next"], f["table_m_next"], f["stage2"], f["stage2_next"], k, nt)
    assert lookup.eval_logup_multi_ext(alg, *args) == jax_lookup.eval_logup_multi_ext(j_alg, *args)
    s2, s2n = f["stage2"][: k + nt + 1], f["stage2_next"][: k + nt + 1]
    args = (f["beta0"], f["values_m"], f["mult_m"], f["table_m"], f["values_m_next"], f["mult_m_next"],
            f["table_m_next"], s2, s2n, k, nt)
    assert lookup.eval_logup_multi(alg, *args) == jax_lookup.eval_logup_multi(j_alg, *args)
    s2, s2n = f["stage2"][: k + 2], f["stage2_next"][: k + 2]
    args = (f["beta0"], f["values_m"], f["values_m_next"], f["mult_m"][0], f["mult_m_next"][0],
            f["table_m"][0], f["table_m_next"][0], s2, s2n)
    assert lookup.eval_logup_constraints(alg, *args) == jax_lookup.eval_logup_constraints(j_alg, *args)


def _plain_frames(u64: np.ndarray):
    """Current and next-row (roll by 1) frames over an (n, k) matrix."""
    m = gf64.from_u64(u64 % np.uint64(P))
    cur = [(m[0][:, j], m[1][:, j]) for j in range(u64.shape[1])]
    nxt = [(torch.roll(c[0], -1), torch.roll(c[1], -1)) for c in cur]
    return cur, nxt


def _assert_vanish(cs, n):
    rows = {"all": slice(None), "transition": slice(0, n - 1), "first": slice(0, 1), "last": slice(n - 1, n)}
    for idx, (value, kind) in enumerate(cs):
        bad = np.argwhere(_to_ints(value)[rows[kind]] != 0)
        assert bad.size == 0, f"constraint {idx} ({kind}) nonzero at {bad[:5]}"


def test_lookup_ext_constraints_vanish_under_device_algebra():
    n, k, bits = 32, 5, 8
    values, table, mult = _lookup_inputs(n, k, bits, seed=11)
    nt = table.shape[1]
    beta = (0xABCDEF12, 0x13572468)
    s2 = lookup.build_logup_stage2_multi_ext(values, mult, table, beta)

    def mat(x):
        g = gf64.from_u64(x % np.uint64(P))
        return g, (torch.roll(g[0], -1, 0), torch.roll(g[1], -1, 0))

    vm, vmn = mat(values)
    mm, mmn = mat(mult)
    tm, tmn = mat(table)
    s2c, s2n = _plain_frames(s2)
    b0, b1 = (gf64.full((1,), beta[0]), gf64.full((1,), beta[1]))
    cs = lookup.eval_logup_multi_ext(DeviceAlgebra((n,), "cpu"), b0, b1, vm, mm, tm, vmn, mmn, tmn,
                                     s2c, s2n, k, nt)
    _assert_vanish(cs, n)


# ----------------------------------------------------------------------------
# ed_air
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("segments", SEGMENTS)
def test_trace_builder_equals_jax(traces, segments):
    pairs, trace, aux = traces[segments]
    j_trace, j_aux = jax_ed_air.build_ed_trace(pairs)
    assert np.array_equal(trace, j_trace) and aux == j_aux
    assert trace.shape == (ed_air.SEG * segments, ed_air.EdScalarMulAir(segments).n_cols)
    assert ed_air.claims_hold(aux) and ged.point_equal(aux[0][2], ged.IDENTITY)
    if segments == 1:
        r_trace, r_aux = ed_air.build_ed_trace_ref(pairs)
        assert np.array_equal(r_trace, trace) and r_aux == aux


def test_air_host_functions_equal_jax(traces):
    """Fixed columns, the transcript's challenges, stage 2 (lookup block and
    digest bus) and the claim fold at 4 segments."""
    _, trace, aux = traces[4]
    air, j_air = ed_air.EdScalarMulAir(4), jax_ed_air.EdScalarMulAir(4)
    assert (air.n_cols, air.n_fixed, air.n_stage2, air.n_challenges, air.nt) == (
        j_air.n_cols, j_air.n_fixed, j_air.n_stage2, j_air.n_challenges, j_air.nt)
    n = trace.shape[0]
    assert np.array_equal(air.fixed_columns(n), j_air.fixed_columns(n))
    ch, j_ch = Challenger(), JaxChallenger()
    air.observe_aux(ch, aux)
    j_air.observe_aux(j_ch, aux)
    chals = air.sample_challenges(ch, aux)
    assert chals == j_air.sample_challenges(j_ch, aux)
    assert np.array_equal(air.build_stage2(trace, chals, aux), j_air.build_stage2(trace, chals, aux))
    for r in (0, 1, 7, P - 1, chals[0]):
        assert ed_air.fold_ed_claims(aux, r) == jax_ed_air.fold_ed_claims(aux, r)
    assert ed_air.claims_hold(aux) == jax_ed_air.claims_hold(aux) is True
    bad = [(aux[0][0], aux[0][1], ged.point_add(aux[0][2], ged.BASE))] + aux[1:]
    assert ed_air.claims_hold(bad) == jax_ed_air.claims_hold(bad) is False


def _random_frames(air, rng):
    def rnd():
        return (int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)))

    kw = dict(
        fixed=[rnd() for _ in range(air.n_fixed)], fixed_next=[rnd() for _ in range(air.n_fixed)],
        challenges=[rnd() for _ in range(air.n_challenges)],
        stage2=[rnd() for _ in range(air.n_stage2)], stage2_next=[rnd() for _ in range(air.n_stage2)],
    )
    return [rnd() for _ in range(air.n_cols)], [rnd() for _ in range(air.n_cols)], kw


def test_constraints_equal_jax_at_random_ext_frames():
    """All 11 groups at a random GF(p^2) frame equal the JAX package's, and
    the groups concatenate to eval_constraints (the alpha assignment of the
    grouped quotient depends on it)."""
    air, j_air = ed_air.EdScalarMulAir(1), jax_ed_air.EdScalarMulAir(1)
    local, nxt, kw = _random_frames(air, np.random.default_rng(8))
    alg = HostExtAlgebra()
    whole = air.eval_constraints(local, nxt, [], alg, **kw)
    assert whole == j_air.eval_constraints(local, nxt, [], JaxHostExtAlgebra(), **kw)
    parts = []
    for g in range(air.n_constraint_groups):
        parts += air.eval_constraint_group(g, local, nxt, [], alg, **kw)
    assert parts == whole and air.n_constraint_groups == 11


def test_constraints_vanish_on_the_plain_domain(traces):
    """tests/test_ed_air.py's vanishing check (slow there, through JAX) on
    one segment, through the port's DeviceAlgebra on CPU tensors; a changed
    result limb on the last row breaks a constraint."""
    _, trace, aux = traces[1]
    air = ed_air.EdScalarMulAir(1)
    n = trace.shape[0]
    ch = Challenger()
    air.observe_aux(ch, aux)
    chals = air.sample_challenges(ch, aux)
    s2 = air.build_stage2(trace, chals, aux)
    fixed, fixed_next = _plain_frames(air.fixed_columns(n))
    stage2, stage2_next = _plain_frames(s2)
    chs = [gf64.full((1,), v % P) for v in chals]
    kw = dict(fixed=fixed, fixed_next=fixed_next, challenges=chs, stage2=stage2, stage2_next=stage2_next)
    alg = DeviceAlgebra((n,), "cpu")
    local, nxt = _plain_frames(trace)
    _assert_vanish(air.eval_constraints(local, nxt, [], alg, **kw), n)
    bad = trace.copy()
    bad[-1, ed_air.OUT_COLS[0]] ^= np.uint64(1)
    local, nxt = _plain_frames(bad)
    with pytest.raises(AssertionError, match="nonzero"):
        _assert_vanish(air.eval_constraints(local, nxt, [], alg, **kw), n)


# ----------------------------------------------------------------------------
# ed_claims
# ----------------------------------------------------------------------------


def _signed_item(seed: int, msg: bytes):
    secret = bytes([(seed + i) % 256 for i in range(32)])
    return (ged.public_key(secret), msg, ged.sign(secret, msg))


def test_batch_msm_pairs_equal_jax():
    """tests/test_ed_claims.py's cases: two signatures close the equation
    (5 pairs padded to 8); a changed s does not; a short key, s >= L and an
    R that does not decompress give None; caller-given z's."""
    items = [_signed_item(1, b"header-1"), _signed_item(99, b"header-1")]
    pairs = ed_claims.batch_msm_pairs(items)
    assert pairs == jax_ed_claims.batch_msm_pairs(items) and len(pairs) == 8
    total = ged.IDENTITY
    for s, (px, py) in pairs:
        total = ged.point_add(total, ged.point_mul(s, (px, py, 1, px * py % Q)))
    assert ged.point_equal(total, ged.IDENTITY)
    zs = [3, 5]
    assert ed_claims.batch_msm_pairs(items, zs) == jax_ed_claims.batch_msm_pairs(items, zs)

    pk, msg, sig = _signed_item(2, b"m")
    bad = [(pk, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:])]
    assert ed_claims.batch_msm_pairs(bad) == jax_ed_claims.batch_msm_pairs(bad)
    not_decompressing = next(bytes([y]) + bytes(31) for y in range(2, 256)
                             if ged.point_decompress(bytes([y]) + bytes(31)) is None)
    for malformed in ([(pk[:31], msg, sig)], [(pk, msg, sig[:32] + ged.L.to_bytes(32, "little"))],
                      [(pk, msg, sig[:63])], [(pk, msg, not_decompressing + sig[32:])]):
        assert ed_claims.batch_msm_pairs(malformed) is None
        assert jax_ed_claims.batch_msm_pairs(malformed) is None
    with pytest.raises(ValueError, match="malformed"):
        ed_claims.prove_batch_stark([(pk[:31], msg, sig)], device="cpu")


# ----------------------------------------------------------------------------
# the one-segment STARK, held to both packages' verifiers (slow)
# ----------------------------------------------------------------------------


@pytest.mark.slow
def test_one_segment_stark_roundtrip_both_verifiers():
    from blobstreamx_tpu.prover import serialize as jax_serialize, stark as jax_stark
    from blobstreamx_tpu.prover.config import StarkConfig as JaxStarkConfig
    from blobstreamx_tpu_torch.prover import serialize, stark
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    pairs = [(ROUNDTRIP_SCALAR, _affine(ged.BASE))]
    trace, aux = ed_air.build_ed_trace(pairs)
    air, cfg, n = ed_air.EdScalarMulAir(1), StarkConfig(**ROUNDTRIP_CFG), trace.shape[0]
    proof = stark.prove(air, trace, [], cfg, aux=aux, device="cpu")
    blob = serialize.stark_proof_to_bytes(proof)
    j_proof = jax_serialize.stark_proof_from_bytes(blob)
    assert jax_serialize.stark_proof_to_bytes(j_proof) == blob
    j_air, j_cfg = jax_ed_air.EdScalarMulAir(1), JaxStarkConfig(**ROUNDTRIP_CFG)
    assert stark.verify(air, proof, [], cfg, n, aux=aux)
    assert jax_stark.verify(j_air, j_proof, [], j_cfg, n, aux=aux)
    s, pt, out = aux[0]
    for bad in ([(s ^ 4, pt, out)], [(s, pt, (out[0] + 1,) + tuple(out[1:]))]):
        assert not stark.verify(air, proof, [], cfg, n, aux=bad)
        assert not jax_stark.verify(j_air, j_proof, [], j_cfg, n, aux=bad)
