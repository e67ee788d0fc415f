"""The port's field and curve API and its MSM variants (device-combined,
host-combined and bitwise) against the JAX package, on the CPU, where
add_fused, double and pow22523 run their plain versions.

Limbs are compared with the JAX functions where both packages run the same
plain algorithm; MSM results are compared with the JAX package's golden
group law. batch_verify is compared with the JAX package's batch_verify:
its host side (scalars, digit matrix, padding, reasons and diagnostics)
runs in process, with its jitted device program replaced by the port's on
the same inputs, because it takes more than a minute of XLA:CPU compile
here. The port's device pieces are held to JAX's own separately (the
bitwise window sums here; decompression, the add and the bucket phases in
tests/test_torch_curve.py), and the slow test runs JAX's real device
program. The bitwise MSM is also held to the batch equation itself: over a
batch's prepared points it gives the identity exactly when the batch is
valid."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.fields import gf25519 as jf
from blobstreamx_tpu.golden import ed25519 as jged
from blobstreamx_tpu.ops import curve25519 as jcurve, ed25519 as jed, msm as jmsm
from blobstreamx_tpu_torch.fields import gf25519 as tf
from blobstreamx_tpu_torch.ops import curve25519 as tcurve, ed25519 as ted, msm as tmsm

torch.set_num_threads(1)
Q = tf.Q
L = jged.L


def fe_values(seed: int, n: int) -> list[int]:
    """Limb values < 2^256, the edges near 0, p and 2^255 first."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, 19, Q - 1, Q, Q + 1, 2 * Q - 1, 2 * Q, (1 << 255) - 20, (1 << 255) - 1, 1 << 255,
             (1 << 256) - 1, (1 << 256) - 39, 1 << 128]
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    vals[: len(edges)] = edges
    return vals


def both(vals):
    """The same limbs as a port tensor and a JAX array."""
    return tf.from_int(vals), jf.from_int(vals)


def limbs_equal(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def golden_points(seed: int, n: int, semi_reduced: bool = True):
    """n extended-coordinate points at a random projective scale; with
    semi_reduced, some coordinates are given as value + p (still < 2^256)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        pt = jged.point_mul(int(rng.integers(1, 1 << 62)), jged.BASE)
        lam = int(rng.integers(1, 1 << 62))
        pt = [c * lam % Q for c in pt]
        if semi_reduced and i % 3 == 1:
            pt = [c + Q if c + Q < (1 << 256) else c for c in pt]
        out.append(tuple(pt))
    return out


def as_points(pts):
    ints = [[p[i] for p in pts] for i in range(4)]
    return tuple(tf.from_int(c) for c in ints), tuple(jf.from_int(c) for c in ints)


def to_golden(p, lane: int = 0):
    return tuple(tf.to_int(c)[lane] % Q for c in p)


def golden_msm(pts, scalars):
    acc = jged.IDENTITY
    for s, pt in zip(scalars, pts):
        acc = jged.point_add(acc, jged.point_mul(s, tuple(c % Q for c in pt)))
    return acc


# ----------------------------------------------------------------------------
# GF(2^255 - 19): neg, mul_small, pow_static
# ----------------------------------------------------------------------------


def test_fe_neg_matches_jax():
    vals = fe_values(1, 24)
    t, j = both(vals)
    limbs_equal(tf.neg(t), jf.neg(j))
    assert [v % Q for v in tf.to_int(tf.neg(t))] == [(-v) % Q for v in vals]


@pytest.mark.parametrize("k", [1, 2, 19, 38, 121, (1 << 15) - 1])
def test_fe_mul_small_matches_jax(k):
    vals = fe_values(2, 24)
    t, j = both(vals)
    limbs_equal(tf.mul_small(t, k), jf.mul_small(j, k))
    assert [v % Q for v in tf.to_int(tf.mul_small(t, k))] == [v * k % Q for v in vals]


def test_fe_pow_static_matches_jax():
    vals = fe_values(3, 16)
    t, j = both(vals)
    e = (1 << 20) + 12345
    limbs_equal(tf.pow_static(t, e), jf.pow_static(j, e))
    assert [v % Q for v in tf.to_int(tf.pow_static(t, e))] == [pow(v, e, Q) for v in vals]


@pytest.mark.parametrize("e", [0, 1, 2, 5, 38])
def test_fe_pow_static_small_exponents(e):
    vals = fe_values(3, 16)
    assert [v % Q for v in tf.to_int(tf.pow_static(tf.from_int(vals), e))] == [pow(v, e, Q) for v in vals]


def test_fe_pow_static_equals_the_addition_chain():
    t = tf.from_int(fe_values(4, 8))
    e = (Q - 5) // 8
    assert tf.to_int(tf.canonicalize(tf.pow_static(t, e))) == tf.to_int(tf.canonicalize(tf.pow22523(t)))


# ----------------------------------------------------------------------------
# edwards25519: double, neg, equal, is_identity, on_curve
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def curve_lanes():
    """Points (some semi-reduced), the identity, a point of order 2, and the
    same points at another projective scale."""
    pts = golden_points(5, 6) + [jged.IDENTITY, (0, Q - 1, 1, 0)]
    scaled = [tuple(c * 7 % Q for c in pt) for pt in pts]
    return pts, scaled


def test_double_matches_jax_and_golden(curve_lanes):
    pts, _ = curve_lanes
    tp, jp = as_points(pts)
    got = tcurve.double(tp)
    for g, w in zip(got, jcurve.double(jp)):
        limbs_equal(g, w)
    for lane, pt in enumerate(pts):
        want = jged.point_add(tuple(c % Q for c in pt), tuple(c % Q for c in pt))
        assert jged.point_equal(to_golden(got, lane), want)


def test_neg_matches_jax_and_golden(curve_lanes):
    pts, _ = curve_lanes
    tp, jp = as_points(pts)
    got = tcurve.neg(tp)
    for g, w in zip(got, jcurve.neg(jp)):
        limbs_equal(g, w)
    for lane, (x, y, z, t) in enumerate(pts):
        neg = to_golden(got, lane)
        assert jged.point_equal(neg, ((-x) % Q, y % Q, z % Q, (-t) % Q))
        assert jged.point_equal(jged.point_add(neg, (x % Q, y % Q, z % Q, t % Q)), jged.IDENTITY)


def test_equal_and_is_identity_match_jax(curve_lanes):
    pts, scaled = curve_lanes
    tp, jp = as_points(pts)
    ts, js = as_points(scaled)
    tr, jr = as_points(scaled[1:] + scaled[:1])  # other points, lane by lane
    assert tcurve.equal(tp, ts).tolist() == np.asarray(jcurve.equal(jp, js)).tolist() == [True] * len(pts)
    want = np.asarray(jcurve.equal(jp, jr)).tolist()
    assert tcurve.equal(tp, tr).tolist() == want and not any(want)
    ident = tcurve.is_identity(tp).tolist()
    assert ident == np.asarray(jcurve.is_identity(jp)).tolist()
    assert ident == [False] * 6 + [True, False]


def test_on_curve_matches_jax(curve_lanes):
    pts, _ = curve_lanes
    rng = np.random.default_rng(6)
    off = [tuple(int.from_bytes(rng.bytes(32), "little") % Q for _ in range(4)) for _ in range(3)]
    broken_t = [(pts[0][0], pts[0][1], pts[0][2], (pts[0][3] + 1) % Q)]  # x*y != z*t
    lanes = pts[:4] + off + broken_t  # as many lanes as the other curve tests: one compile of each op
    tp, jp = as_points(lanes)
    got = tcurve.on_curve(tp).tolist()
    assert got == np.asarray(jcurve.on_curve(jp)).tolist()
    assert got == [True] * 4 + [False] * 4


# ----------------------------------------------------------------------------
# MSM variants
# ----------------------------------------------------------------------------


def msm_case(n: int, seed: int, zeros=()):
    pts = golden_points(seed, n)
    rng = np.random.default_rng(seed + 100)
    scalars = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n)]
    for i in zeros:
        scalars[i] = 0
    if n > 1:
        scalars[-1] = L - 1
    return pts, scalars


def truncated_digits(scalars, c: int, windows: int):
    """The digit matrix of scalars < 2^(c * windows), cut to its nonzero
    windows (the device Horner's cost is W * (c + 1) sequential adds, about
    28 ms each on one CPU lane)."""
    digits = tmsm.scalars_to_digits(scalars, c)
    assert not digits[windows:].any()
    return digits[:windows]


# N = 5 pads to the stream multiple (8) and, bitwise, to a power of two (8);
# N = 8 needs no padding
MSM_CASES = {"5 points": (5, 7, ()), "5 points, two zero scalars": (5, 8, (0, 3)), "1 point": (1, 9, ()),
             "8 points": (8, 15, ())}


@pytest.mark.parametrize("name", sorted(MSM_CASES))
def test_msm_variants_match_golden(name):
    n, seed, zeros = MSM_CASES[name]
    pts, scalars = msm_case(n, seed, zeros)
    want = golden_msm(pts, scalars)
    tp, _ = as_points(pts)
    assert jged.point_equal(tmsm.msm_host_combined(tp, tmsm.scalars_to_digits(scalars, 4), c=4, streams=4), want)
    assert jged.point_equal(tmsm.msm_bitwise_host_combined(tp, scalars), want)
    small = [s % (1 << 16) for s in scalars]  # four 4-bit windows for the device combine
    got = tmsm.msm(*tmsm.pad_to_streams(tp, truncated_digits(small, 4, 4), streams=4), streams=4, c=4)
    assert got[0].shape == (16, 1)
    assert jged.point_equal(to_golden(got), golden_msm(pts, small))


def test_msm_all_zero_scalars_is_identity():
    pts, _ = msm_case(4, 10)
    tp, _ = as_points(pts)
    out = tmsm.msm(tp, torch.from_numpy(truncated_digits([0] * 4, 8, 2).astype(np.int64)), streams=4, c=8)
    assert tcurve.is_identity(out).tolist() == [True]
    assert jged.point_equal(tmsm.msm_host_combined(tp, tmsm.scalars_to_digits([0] * 4, 4), c=4, streams=4),
                            jged.IDENTITY)
    assert jged.point_equal(tmsm.msm_bitwise_host_combined(tp, [0] * 4), jged.IDENTITY)


def test_combine_windows_matches_golden():
    """The device Horner over arbitrary window points, c = 3."""
    wins = golden_points(12, 5)
    tw, _ = as_points(wins)
    want = jged.IDENTITY
    for wp in reversed(wins):
        want = jged.point_add(jged.point_mul(1 << 3, want), tuple(c % Q for c in wp))
    got = tmsm.combine_windows(tw, c=3)
    assert got[0].shape == (16, 1)
    assert jged.point_equal(to_golden(got), want)
    assert jged.point_equal(tmsm.combine_windows_host(torch.stack(tw), 3), want)


@pytest.mark.parametrize("n", [1, 5, 8])
def test_pad_to_streams_and_pow2_match_jax(n):
    """N = 1 pads to 2 bitwise, N = 5 to 8, N = 8 not at all."""
    pts, scalars = msm_case(n, 13)
    tp, jp = as_points(pts)
    digits = tmsm.scalars_to_digits(scalars, 4)
    t_pts, t_dig = tmsm.pad_to_streams(tp, digits, streams=4)
    j_pts, j_dig = jmsm.pad_to_streams(jp, digits, streams=4)
    np.testing.assert_array_equal(t_dig.numpy(), np.asarray(j_dig).astype(np.int64))
    for g, w in zip(t_pts, j_pts):
        limbs_equal(g, w)
    bits = tmsm.scalars_to_digits(scalars, 1)
    t_pts, t_bits = tmsm.pad_points_bits_pow2(tp, bits)
    j_pts, j_bits = jmsm.pad_points_bits_pow2(jp, bits)
    assert t_bits.shape == (256, max(2, 1 << (n - 1).bit_length()))
    np.testing.assert_array_equal(t_bits.numpy(), np.asarray(j_bits).astype(np.int64))
    for g, w in zip(t_pts, j_pts):
        limbs_equal(g, w)


def test_bitwise_windows_match_jax():
    """The (16, W) window sums against the JAX package's at N = 2."""
    pts, scalars = msm_case(2, 14)
    scalars[0] = (1 << 255) | 0b1011  # bits set in the top and bottom windows
    tp, jp = as_points(pts)
    bits = tmsm.scalars_to_digits(scalars, 1)
    got = tmsm.msm_bitwise_windows_device(tp, torch.from_numpy(bits.astype(np.int64)))
    want = jmsm.msm_bitwise_windows_device(jp, bits)
    assert got[0].shape == (16, 256)
    for g, w in zip(got, want):
        limbs_equal(g, w)


# ----------------------------------------------------------------------------
# batch verification against the JAX package's verdicts
# ----------------------------------------------------------------------------


def signed_items(n: int, seed: int = 0):
    items = []
    for i in range(n):
        sk = bytes([seed + i + 1]) * 32
        msg = b"celestia-header-%d" % i
        items.append((jged.public_key(sk), msg, jged.sign(sk, msg)))
    return items


def batches():
    items = signed_items(2)
    pk, msg, sig = items[1]
    s_big = (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little")
    return {
        "valid": items,
        "tampered message": [items[0], (pk, msg + b"!", sig)],
        "wrong key": [items[0], (signed_items(1, seed=9)[0][0], msg, sig)],
        "s >= L": [items[0], (pk, msg, sig[:32] + s_big)],
        "invalid R encoding": [items[0], (pk, msg, (Q + 3).to_bytes(32, "little") + sig[32:])],
    }


BATCHES = batches()


def _memo(fn):
    """fn on int64 tensors, remembered by its inputs' values, so that the
    port's call and the JAX package's call share one run of the port's
    device side."""
    seen = {}

    def run(*args):
        tensors = [torch.as_tensor(np.asarray(a).astype(np.int64)) for a in args if not isinstance(a, int)]
        key = tuple((t.shape, t.numpy().tobytes()) for t in tensors) + tuple(a for a in args if isinstance(a, int))
        if key not in seen:
            seen[key] = fn(*tensors, *(a for a in args if isinstance(a, int)))
        return seen[key]

    return run


_port_device = _memo(ted.batch_device)


def _as_jax_output(run):
    def device(*args):
        wins, valid = run(*args)
        return wins.numpy().astype(np.uint32), np.asarray(bool(valid))

    return device


@pytest.mark.parametrize("case", sorted(BATCHES))
def test_batch_verify_matches_jax(case, monkeypatch):
    """c = 2 keeps the bucket reduction small on the CPU (the default c = 4
    runs in tests/test_torch_curve.py and tests/test_torch_pipeline.py)."""
    items = BATCHES[case]
    monkeypatch.setattr(ted, "batch_device", _port_device)
    got = ted.batch_verify(items, c=2, streams=4, device="cpu")
    monkeypatch.setattr(jed, "_batch_device", _as_jax_output(_port_device))
    want = jed.batch_verify(items, c=2, streams=4)
    assert got == want
    assert got[0] == (case == "valid") == all(jged.verify(pk, m, s) for pk, m, s in items)
    if case in ("valid", "tampered message", "wrong key"):
        assert got[1] == {"n": 2, "msm_points": 8, "method": "bucket"}


@pytest.mark.parametrize("case", ["valid", "tampered message", "wrong key"])
def test_bitwise_msm_of_batch_equation(case):
    """The bitwise MSM over a batch's prepared points and equation scalars
    equals the bucket MSM and the golden group law, and is the identity
    exactly when every signature verifies."""
    items = BATCHES[case]
    pts, digits, n_invalid = ted.prepare_batch(items, c=4, device="cpu")
    scalars, _ = ted._equation_scalars(items, None)
    assert n_invalid == 0 and len(scalars) == pts[0].shape[1] == 5
    got = tmsm.msm_bitwise_host_combined(pts, scalars)
    assert jged.point_equal(got, tmsm.msm_host_combined(pts, digits, c=4, streams=4))
    gpts = [tuple(tf.to_int(tf.canonicalize(c))[i] for c in pts) for i in range(5)]
    assert jged.point_equal(got, golden_msm(gpts, scalars))
    assert jged.point_equal(got, jged.IDENTITY) == (case == "valid")


def _port_decompress(encoded):
    pts, valid = tcurve.decompress(encoded, "cpu")
    return tuple(np.asarray(c.numpy(), np.uint32) for c in pts), valid.numpy()


def test_prepare_batch_matches_jax(monkeypatch):
    """The JAX package's prepare_batch with its jitted decompression replaced
    by the port's (held to the golden model in tests/test_torch_curve.py)."""
    items = BATCHES["valid"]
    pts, digits, n_invalid = ted.prepare_batch(items, c=4, device="cpu")
    monkeypatch.setattr(jcurve, "decompress", _port_decompress)
    j_pts, j_digits, j_invalid = jed.prepare_batch(items, c=4)
    np.testing.assert_array_equal(digits, j_digits)
    assert n_invalid == j_invalid == 0 and pts[0].shape == (16, 5)
    for g, w in zip(pts, j_pts):
        assert tf.to_int(tf.canonicalize(g)) == [v % Q for v in jf.to_int(w)]
    # the prepared inputs are the batch equation: their MSM is the identity
    assert jged.point_equal(tmsm.msm_host_combined(pts, digits, c=4, streams=4), jged.IDENTITY)
    assert ted.prepare_batch(BATCHES["s >= L"], device="cpu") is None is jed.prepare_batch(BATCHES["s >= L"])
    _, _, bad = ted.prepare_batch(BATCHES["invalid R encoding"], device="cpu")
    assert bad == 1


@pytest.mark.slow
def test_batch_verify_matches_jax_device_program():
    """JAX's real jitted device program (minutes of XLA:CPU compile)."""
    for case in ("valid", "tampered message", "wrong key", "invalid R encoding"):
        items = BATCHES[case]
        assert ted.batch_verify(items, streams=4, device="cpu") == jed.batch_verify(items, streams=4)
