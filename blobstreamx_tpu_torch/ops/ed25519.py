"""Ed25519 batch verification via Pippenger MSM.

Checks the random-linear-combination batch equation (cofactorless, matching
TendermintX semantics and golden.ed25519.batch_verify_equation):

    sum_i z_i R_i + sum_i (z_i h_i mod L) A_i + [(-sum_i z_i s_i) mod L] B
        == identity

as ONE (2n+1)-point MSM on the device. Host work is O(n) small scalar math:
h_i = SHA-512(R_i ‖ A_i ‖ M_i) mod L, the z_i coefficients (derived
deterministically by hashing the whole batch, so verification is
reproducible) and the digit matrix. Point decompression, the bucket
accumulation and the window reduction run on the device; the O(W) window
combine and the identity test run on host bigints.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from blobstreamx_tpu_torch.device import resolve
from blobstreamx_tpu_torch.golden import ed25519 as gold
from blobstreamx_tpu_torch.ops import curve25519 as curve, msm as msm_ops

L = gold.L


def derive_z(items: list[tuple[bytes, bytes, bytes]], bits: int = 128) -> list[int]:
    """Deterministic 128-bit batch coefficients from the batch transcript."""
    h = hashlib.sha512()
    for pk, msg, sig in items:
        h.update(pk)
        h.update(sig)
        h.update(hashlib.sha512(msg).digest())
    seed = h.digest()
    zs = []
    for i in range(len(items)):
        d = hashlib.sha512(seed + i.to_bytes(4, "little")).digest()
        zs.append((int.from_bytes(d[:16], "little") | 1) & ((1 << bits) - 1))
    return zs


def _equation_scalars(items: list[tuple[bytes, bytes, bytes]], zs: list[int] | None):
    """Host scalar math of the batch equation: the 2n+1 scalars (z_i, z_i h_i,
    then -sum z_i s_i for B) and the 2n encodings (R_i, then A_i), or None if
    an input is malformed or some s >= L."""
    assert len(items) > 0
    if zs is None:
        zs = derive_z(items)
    z_r, z_a = [], []
    s_sum = 0
    enc_r, enc_a = [], []
    for (pk, msg, sig), z in zip(items, zs):
        if len(sig) != 64 or len(pk) != 32:
            return None
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            return None
        h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
        z_r.append(z % L)
        z_a.append(z * h % L)
        s_sum = (s_sum + z * s) % L
        enc_r.append(sig[:32])
        enc_a.append(pk)
    return z_r + z_a + [(L - s_sum) % L], enc_r + enc_a


def prepare_batch(
    items: list[tuple[bytes, bytes, bytes]],
    zs: list[int] | None = None,
    c: int = msm_ops.WINDOW_BITS,
    device=None,
):
    """Host scalar math and device decompression for the batch equation.

    Returns (points, digits, n_invalid), the (2n+1)-point MSM inputs, or
    None if any input is malformed or any s >= L. n_invalid counts lanes
    whose point encoding failed to decompress. c: digit window bits."""
    device = resolve(device)
    prep = _equation_scalars(items, zs)
    if prep is None:
        return None
    scalars, encodings = prep
    y_limbs, signs = curve.unpack_y_limbs_host(curve.encode_points_host(encodings))
    points, valid = _decompressed_with_base(
        torch.from_numpy(y_limbs).to(device), torch.from_numpy(signs).to(device), len(scalars))
    return points, msm_ops.scalars_to_digits(scalars, c), int((~valid).sum())


def _decompressed_with_base(y_limbs, signs, n_lanes: int):
    """Decompress the 2n R/A encodings, append the base point and pad with
    the identity to n_lanes. Returns (points, the (2n,) mask of encodings
    that decompressed)."""
    dev = y_limbs.device
    pts, valid = curve.decompress_limbs(y_limbs, signs)
    b = curve.base_point(1, dev)
    points = tuple(torch.cat([co, cb], dim=1) for co, cb in zip(pts, b))
    pad = n_lanes - points[0].shape[1]
    if pad:
        idn = curve.identity(pad, dev)
        points = tuple(torch.cat([co, ci], dim=1) for co, ci in zip(points, idn))
    return points, valid


def batch_device(y_limbs, signs, digits, c: int, streams: int):
    """The device side of batch verification: decompression of the 2n R/A
    encodings, the base point appended, identity padding to the stream
    multiple, bucket accumulation and window reduction. Returns the (4, 16,
    W) window points and whether every encoding decompressed."""
    n_pts = y_limbs.shape[1] + 1
    points, valid = _decompressed_with_base(y_limbs, signs, n_pts + (-n_pts) % streams)
    w = digits.shape[0]
    buckets = msm_ops.accumulate_buckets(points, digits, streams=streams, c=c)
    wins = msm_ops.reduce_buckets(buckets, w, c=c)
    return torch.stack(wins), valid.all()


def batch_verify(
    items: list[tuple[bytes, bytes, bytes]],
    zs: list[int] | None = None,
    c: int | None = None,
    streams: int | None = None,
    device=None,
):
    """items: [(pubkey32, message, signature64)]. Returns (ok, diagnostics).

    ok is False if any encoding is invalid, any s >= L, or the batch equation
    fails. The device work runs on `device` (default: the card); c/streams
    default to 4-bit windows and fast_streams(device)."""
    device = resolve(device)
    c = msm_ops.FAST_WINDOW_BITS if c is None else c
    streams = msm_ops.fast_streams(device) if streams is None else streams
    prep = _equation_scalars(items, zs)
    if prep is None:
        return False, {"reason": "malformed input or s >= L"}
    scalars, encodings = prep
    y_limbs, signs = curve.unpack_y_limbs_host(curve.encode_points_host(encodings))
    digits = msm_ops.scalars_to_digits(scalars, c)
    pad = (-digits.shape[1]) % streams
    if pad:
        digits = np.concatenate([digits, np.zeros((digits.shape[0], pad), np.uint32)], axis=1)
    wins, valid = batch_device(
        torch.from_numpy(y_limbs).to(device),
        torch.from_numpy(signs).to(device),
        torch.from_numpy(digits.astype(np.int64)).to(device),
        c,
        streams,
    )
    result = msm_ops.combine_windows_host(wins, c)
    if not bool(valid):
        return False, {"reason": "invalid point encoding"}
    ok = gold.point_equal(result, gold.IDENTITY)
    return ok, {"n": len(items), "msm_points": int(digits.shape[1]), "method": "bucket"}
