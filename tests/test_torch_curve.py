"""Port edwards25519 ops and batch verification (blobstreamx_tpu_torch.ops)
vs the JAX package and the golden model, on the CPU. On CPU tensors the
port's add_fused and pow22523 run their plain versions, the code the CUDA
kernels are held against on the card; field values are compared after
canonicalization, and the plain add is compared with JAX limb for limb."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.ops import curve25519 as jcurve
from blobstreamx_tpu_torch.fields import gf25519 as tf
from blobstreamx_tpu_torch.golden import ed25519 as ged
from blobstreamx_tpu_torch.ops import curve25519 as tcurve, ed25519 as ted, msm as tmsm

torch.set_num_threads(1)
Q = ged.Q


def points(seed: int, n: int):
    """n extended-coordinate points with random projective scale, as ints."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pt = ged.point_mul(int(rng.integers(1, 1 << 62)), ged.BASE)
        lam = int(rng.integers(1, 1 << 62))
        out.append(tuple(c * lam % Q for c in pt))
    return out


def to_port(pts):
    return tuple(tf.from_int([p[i] for p in pts]) for i in range(4))


def affine(pt):
    zi = pow(pt[2], Q - 2, Q)
    return pt[0] * zi % Q, pt[1] * zi % Q


def signed_items(n: int, seed: int = 0):
    items = []
    for i in range(n):
        sk = bytes([seed + i + 1]) * 32
        msg = b"skip-commit-%d" % i
        items.append((ged.public_key(sk), msg, ged.sign(sk, msg)))
    return items


def test_add_limbs_match_jax():
    p, q = points(1, 8), points(2, 8)
    p[0] = q[0]  # a doubling lane
    got = tcurve.add(to_port(p), to_port(q))
    jp = tuple(np.asarray(c) for c in jcurve.add(
        tuple(jcurve.f.from_int([x[i] for x in p]) for i in range(4)),
        tuple(jcurve.f.from_int([x[i] for x in q]) for i in range(4)),
    ))
    for g, w in zip(got, jp):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


def test_add_fused_matches_golden():
    p, q = points(3, 6), points(4, 6)
    q[1] = ged.IDENTITY
    out = tcurve.add_fused(to_port(p), to_port(q))
    ints = [tf.to_int(c) for c in out]
    for j in range(6):
        got = tuple(ints[i][j] % Q for i in range(4))
        assert ged.point_equal(got, ged.point_add(p[j], q[j]))


def test_decompress_matches_golden_and_rejects_invalid():
    pts = points(5, 5)
    encs = [ged.point_compress(p) for p in pts]
    bad_y = (Q + 3).to_bytes(32, "little")  # non-canonical y
    not_on_curve = (2).to_bytes(32, "little")  # y = 2 has no x
    raw = encs + [bad_y, not_on_curve]
    dec, valid = tcurve.decompress(tcurve.encode_points_host(raw))
    assert valid.tolist() == [True] * 5 + [False, ged.point_decompress(not_on_curve) is not None]
    got = tcurve.to_affine_ints(dec)
    for j, pt in enumerate(pts):
        assert got[j] == affine(pt)


def test_decompress_y_limbs_match_jax():
    encs = [ged.point_compress(p) for p in points(6, 4)]
    raw = tcurve.encode_points_host(encs)
    ty, ts = tcurve.unpack_y_limbs_host(raw)
    jy, js = jcurve.unpack_y_limbs_host(raw)
    np.testing.assert_array_equal(ty, jy.astype(np.int64))
    np.testing.assert_array_equal(ts, js.astype(np.int64))


@pytest.mark.parametrize("group", [2, 4, 8])
def test_fold_group_sums_matches_golden(group):
    pts = points(7, 16)
    out = tmsm.fold_group_sums(to_port(pts), group)
    ints = [tf.to_int(c) for c in out]
    for g in range(16 // group):
        want = ged.IDENTITY
        for pt in pts[g * group : (g + 1) * group]:
            want = ged.point_add(want, pt)
        assert ged.point_equal(tuple(ints[i][g] % Q for i in range(4)), want)


def test_msm_buckets_match_golden():
    pts = points(8, 8)
    rng = np.random.default_rng(9)
    scalars = [int.from_bytes(rng.bytes(32), "little") % ged.L for _ in pts]
    digits = torch.from_numpy(tmsm.scalars_to_digits(scalars, 4).astype(np.int64))
    buckets = tmsm.accumulate_buckets(to_port(pts), digits, streams=4, c=4)
    wins = torch.stack(tmsm.reduce_buckets(buckets, digits.shape[0], c=4))
    got = tmsm.combine_windows_host(wins, 4)
    want = ged.IDENTITY
    for s, pt in zip(scalars, pts):
        want = ged.point_add(want, ged.point_mul(s, pt))
    assert ged.point_equal(got, want)


def test_scalars_to_digits_matches_jax():
    from blobstreamx_tpu.ops import msm as jmsm

    scalars = [0, 1, ged.L - 1, (1 << 255) + 12345]
    for c in (1, 4, 8):
        np.testing.assert_array_equal(tmsm.scalars_to_digits(scalars, c), jmsm.scalars_to_digits(scalars, c))


def test_derive_z_matches_jax():
    from blobstreamx_tpu.ops import ed25519 as jed

    items = signed_items(3)
    assert ted.derive_z(items) == jed.derive_z(items)


@pytest.mark.parametrize("case", ["valid", "flipped_signature_byte", "wrong_message"])
def test_batch_verify_matches_golden(case):
    items = signed_items(3)
    if case == "flipped_signature_byte":
        pk, msg, sig = items[1]
        items[1] = (pk, msg, sig[:5] + bytes([sig[5] ^ 1]) + sig[6:])
    elif case == "wrong_message":
        pk, _msg, sig = items[2]
        items[2] = (pk, b"another message", sig)
    ok, info = ted.batch_verify(items, device="cpu")
    want = all(ged.verify(pk, m, s) for pk, m, s in items)
    assert ok == want == (case == "valid")
    if ok:
        assert info["n"] == 3
        assert ged.batch_verify_equation(items, ted.derive_z(items))
