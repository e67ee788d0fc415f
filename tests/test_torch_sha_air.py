"""The port's SHA-256 AIR (blobstreamx_tpu_torch.prover.sha_air) and the
tuple-tree messages of sha_claims against the JAX package: the host
functions give equal values, every constraint vanishes on the plain trace
domain under the port's DeviceAlgebra, the constraints equal the JAX AIR's
at random ext frames, the port's DeviceAlgebra equals its HostExtAlgebra
row by row, and the constraint groups concatenate to eval_constraints.
All on the CPU at small sizes (exact equality throughout)."""

import hashlib

import numpy as np
import pytest
import torch

from blobstreamx_tpu.golden.challenger import Challenger as JaxChallenger
from blobstreamx_tpu.prover import sha_air as jax_sha_air, sha_claims as jax_sha_claims
from blobstreamx_tpu.prover.air import HostExtAlgebra as JaxHostExtAlgebra
from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.prover import sha_air, sha_claims
from blobstreamx_tpu_torch.prover.air import DeviceAlgebra, HostExtAlgebra

torch.set_num_threads(1)
P = gold.P
# tests/test_sha_air.py's messages: one, two and three blocks, and the empty one
MESSAGES = [b"abc", b"x" * 77, b"", b"blobstream" * 20]


@pytest.fixture(scope="module")
def setup():
    chain, blocks = sha_air.plan_blocks(MESSAGES)
    trace, aux = sha_air.build_sha_trace(chain, blocks)
    return chain, blocks, trace, aux


def test_plan_and_trace_equal_jax(setup):
    chain, blocks, trace, aux = setup
    assert (chain, blocks) == jax_sha_air.plan_blocks(MESSAGES)
    j_trace, j_aux = jax_sha_air.build_sha_trace(chain, blocks)
    assert np.array_equal(trace, j_trace) and aux == j_aux
    r_trace, r_aux = sha_air.build_sha_trace_ref(chain, blocks)
    assert np.array_equal(r_trace, trace) and r_aux == aux
    assert trace.max() <= 1


def test_digests_and_fold_equal_jax(setup):
    chain, _, _, aux = setup
    digests = sha_air.digests_from_aux(chain, aux)
    assert digests == jax_sha_air.digests_from_aux(chain, aux)
    assert digests[: len(MESSAGES)] == [hashlib.sha256(m).digest() for m in MESSAGES]
    for r in (0, 1, 7, P - 1, 0x123456789ABCDEF):
        assert sha_air.fold_claims(aux, r) == jax_sha_air.fold_claims(aux, r)


def test_fixed_columns_and_stage2_equal_jax(setup):
    chain, _, trace, aux = setup
    air, j_air = sha_air.Sha256Air(chain), jax_sha_air.Sha256Air(chain)
    n = trace.shape[0]
    assert np.array_equal(air.fixed_columns(n), j_air.fixed_columns(n))
    ch, j_ch = Challenger(), JaxChallenger()
    air.observe_aux(ch, aux)
    j_air.observe_aux(j_ch, aux)
    chals = air.sample_challenges(ch, aux)
    assert chals == j_air.sample_challenges(j_ch, aux)
    assert np.array_equal(air.build_stage2(trace, chals, aux), j_air.build_stage2(trace, chals, aux))


@pytest.mark.parametrize("trusted,target", [(9, 10), (2, 10)])
def test_tuple_tree_messages_equal_jax(trusted, target):
    """One leaf (the SHA-tier test's chain) and eight (test_pipeline's)."""
    chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4,
                              sign_fraction=0.75, sign_heights={10})
    w = wit.build_skip_witness(chain, trusted_height=trusted, target_height=target)
    heights = [int(h) for h in w.range_heights]
    got = sha_claims.tuple_tree_messages(heights, w.range_data_hashes)
    assert got == jax_sha_claims.tuple_tree_messages(heights, w.range_data_hashes)
    assert len(got[0]) == 2 * len(heights) - 1
    assert sha_claims._expected_chain(len(heights)) == jax_sha_claims._expected_chain(len(heights))


def _frames_plain(m: tuple, k: int):
    """Per-column current / next-row (roll by 1) frames over (n, k) tensors."""
    cur = [(m[0][:, j], m[1][:, j]) for j in range(k)]
    nxt = [(torch.roll(m[0][:, j], -1), torch.roll(m[1][:, j], -1)) for j in range(k)]
    return cur, nxt


def test_constraints_vanish_on_the_plain_domain(setup):
    """tests/test_sha_air.py's vanishing check, through the port's
    DeviceAlgebra on CPU tensors."""
    chain, _, trace, aux = setup
    air = sha_air.Sha256Air(chain)
    n = trace.shape[0]
    ch = Challenger()
    air.observe_aux(ch, aux)
    chals = air.sample_challenges(ch, aux)
    s2 = air.build_stage2(trace, chals, aux)
    local, nxt = _frames_plain(gf64.from_u64(trace), air.n_cols)
    stage2, stage2_next = _frames_plain(gf64.from_u64(s2), air.n_stage2)
    fixed, fixed_next = _frames_plain(gf64.from_u64(air.fixed_columns(n) % P), air.n_fixed)
    chs = [gf64.full((1,), v % P) for v in chals]
    cs = air.eval_constraints(local, nxt, [], DeviceAlgebra((n,), "cpu"), fixed=fixed,
                              fixed_next=fixed_next, challenges=chs, stage2=stage2,
                              stage2_next=stage2_next)
    assert len(cs) == 29
    rows = {"all": slice(None), "transition": slice(0, n - 1), "first": slice(0, 1), "last": slice(n - 1, n)}
    for idx, (value, kind) in enumerate(cs):
        v = gf64.to_u64(value)
        v = v[:, None] if v.ndim == 1 else v
        bad = np.argwhere(v[rows[kind]] != 0)
        assert bad.size == 0, f"constraint {idx} ({kind}) nonzero at {bad[:5]}"


def _random_host_frames(air, rng, ext: bool):
    def rnd():
        return (int(rng.integers(0, P, dtype=np.uint64)), int(rng.integers(0, P, dtype=np.uint64)) if ext else 0)

    local = [rnd() for _ in range(air.n_cols)]
    nxt = [rnd() for _ in range(air.n_cols)]
    kw = dict(
        fixed=[rnd() for _ in range(air.n_fixed)],
        fixed_next=[rnd() for _ in range(air.n_fixed)],
        challenges=[rnd() for _ in range(air.n_challenges)],
        stage2=[rnd() for _ in range(air.n_stage2)],
        stage2_next=[rnd() for _ in range(air.n_stage2)],
    )
    return local, nxt, kw


def test_constraints_equal_jax_at_random_ext_frames():
    chain = (False, True)
    air, j_air = sha_air.Sha256Air(chain), jax_sha_air.Sha256Air(chain)
    local, nxt, kw = _random_host_frames(air, np.random.default_rng(0), ext=True)
    got = air.eval_constraints(local, nxt, [], HostExtAlgebra(), **kw)
    want = j_air.eval_constraints(local, nxt, [], JaxHostExtAlgebra(), **kw)
    assert got == want


def test_groups_concatenate_to_eval_constraints():
    air = sha_air.Sha256Air((False, True))
    alg = HostExtAlgebra()
    local, nxt, kw = _random_host_frames(air, np.random.default_rng(1), ext=True)
    full = air.eval_constraints(local, nxt, [], alg, **kw)
    parts = []
    for g in range(air.n_constraint_groups):
        parts += air.eval_constraint_group(g, local, nxt, [], alg, **kw)
    assert parts == full


def test_device_algebra_equals_host_algebra_row_by_row():
    """The bit ops Sha256Air is the first AIR to use (rotr_bits, shr_bits,
    wsum, scale_row, const_row, colv, frame_block) on a batch of random
    base-field frames: each row of the device values equals the host
    algebra's value at that row's frame."""
    air = sha_air.Sha256Air((False, True))
    rng = np.random.default_rng(2)
    rows = [_random_host_frames(air, rng, ext=False) for _ in range(3)]

    def column(vals):
        return gf64.from_u64(np.array([v[0] for v in vals], np.uint64))

    def device_frame(get):
        k = len(get(rows[0]))
        return [column([get(r)[j] for r in rows]) for j in range(k)]

    names = ("fixed", "fixed_next", "stage2", "stage2_next")
    dev_kw = {name: device_frame(lambda r, name=name: r[2][name]) for name in names}
    dev_kw["challenges"] = [gf64.full((1,), v[0]) for v in rows[0][2]["challenges"]]
    got = air.eval_constraints(device_frame(lambda r: r[0]), device_frame(lambda r: r[1]), [],
                               DeviceAlgebra((len(rows),), "cpu"), **dev_kw)
    for i, (local, nxt, kw) in enumerate(rows):
        kw = dict(kw, challenges=rows[0][2]["challenges"])
        want = air.eval_constraints(local, nxt, [], HostExtAlgebra(), **kw)
        assert len(got) == len(want)
        for (dv, dk), (hv, hk) in zip(got, want):
            assert dk == hk
            vals = gf64.to_u64(dv)
            vals = vals[i] if vals.ndim == 1 else vals[i].tolist()
            if isinstance(hv, list):
                assert [int(x) for x in vals] == [x[0] for x in hv] and all(x[1] == 0 for x in hv)
            else:
                assert int(vals) == hv[0] and hv[1] == 0
