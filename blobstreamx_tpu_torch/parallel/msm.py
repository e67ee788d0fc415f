"""Pippenger MSM and Ed25519 batch verification over a mesh.

  1. points and digits are split over the ranks; each rank accumulates its
     slice's buckets (ops.msm.accumulate_buckets);
  2. the bucket copies are combined by a recursive-doubling all-reduce
     whose monoid is the complete Edwards addition: log2(D) rounds of an
     exchange with the XOR partner and one batched point add (one launch of
     the Edwards-add kernel a round on the card);
  3. the per-window weighted bucket reduction is sharded over the windows:
     each rank reduces W/D windows;
  4. the window results are gathered (W points) and the Horner combine runs
     on every rank, on the host as in ops.msm.msm_host_combined.
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.golden import ed25519 as gold
from blobstreamx_tpu_torch.ops import curve25519 as curve, msm as msm_ops
from .mesh import Mesh


def _allreduce_points(p: curve.Point, mesh: Mesh) -> curve.Point:
    """Recursive-doubling all-reduce with the Edwards group law as monoid
    (D a power of two). Every rank ends with the sum of all ranks' points."""
    d = mesh.size
    assert d & (d - 1) == 0, d
    step = 1
    while step < d:
        partner = mesh.rank ^ step
        got = mesh.exchange(torch.stack(p), partner, partner)
        p = curve.add_fused(p, tuple(got))
        step *= 2
    return p


def msm_sharded(points: curve.Point, digits, mesh: Mesh, streams: int = 16):
    """MSM over the mesh. points: the whole (16, N) coordinate tuple on the
    mesh's device on every rank; digits: the (W, N) digit matrix (numpy or a
    tensor). The window width c is inferred from the digit rows
    (W = ceil(256/c)). Pads N to a multiple of D*streams with identity
    lanes and digit 0 (free: bucket 0 is never reduced). Returns the result
    as host extended coordinates (x, y, z, t), python ints, the same on
    every rank."""
    d = mesh.size
    w = int(digits.shape[0])
    c = -(-256 // w)
    assert -(-256 // c) == w, f"digit rows {w} do not match a window width"
    # W -> c is not injective (c=17 also gives W=16): a digit built with a
    # wider window would overflow the 2^c bucket lanes
    arr = digits.cpu().numpy() if isinstance(digits, torch.Tensor) else np.asarray(digits)
    dmax = int(arr.max()) if arr.size else 0
    assert dmax < (1 << c), f"digit {dmax} overflows inferred window c={c}"
    points, digits = msm_ops.pad_to_streams(points, digits, streams=streams * d)
    per = digits.shape[1] // d
    a, b = mesh.rank * per, (mesh.rank + 1) * per
    local = tuple(x[:, a:b].contiguous() for x in points)
    buckets = msm_ops.accumulate_buckets(local, digits[:, a:b].contiguous(), streams=streams, c=c)
    buckets = _allreduce_points(buckets, mesh)
    nb = 1 << c
    if w % d == 0:
        w_local = w // d
        lo = mesh.rank * w_local * nb
        sliced = tuple(x[:, lo : lo + w_local * nb].contiguous() for x in buckets)
        windows = msm_ops.reduce_buckets(sliced, w_local, c=c)
        windows = torch.cat(mesh.all_gather(torch.stack(windows)), dim=2)  # (4, 16, W)
    else:
        windows = torch.stack(msm_ops.reduce_buckets(buckets, w, c=c))
    return msm_ops.combine_windows_host(windows, c)


def msm_bitwise_sharded(points: curve.Point, scalars: list[int], mesh: Mesh):
    """Bitwise-window MSM over the mesh (ops.msm.msm_bitwise_windows_device):
    each rank masked-tree-sums its slice's 256 window sums, and the (16, 256)
    window points all-reduce over the ranks, a fixed 256-lane payload a
    round whatever N. points: the whole (16, N) tuple on every rank. Returns
    host extended coordinates (x, y, z, t) as python ints."""
    d = mesh.size
    bits = msm_ops.scalars_to_digits(scalars, c=1)
    n = bits.shape[1]
    # equal power-of-two slices (>= 2 lanes) for the local compacting tree
    per = max(2, -(-n // d))
    per = 1 << (per - 1).bit_length()
    n2 = d * per
    dev = points[0].device
    if n2 != n:
        idn = curve.identity(n2 - n, dev)
        points = tuple(torch.cat([p, q], dim=1) for p, q in zip(points, idn))
        bits = np.concatenate([bits, np.zeros((bits.shape[0], n2 - n), np.uint32)], axis=1)
    a, b = mesh.rank * per, (mesh.rank + 1) * per
    local = tuple(x[:, a:b].contiguous() for x in points)
    bits_local = torch.from_numpy(bits[:, a:b].astype(np.int64)).to(dev)
    wins = _allreduce_points(msm_ops.msm_bitwise_windows_device(local, bits_local), mesh)
    return msm_ops.combine_windows_host(torch.stack(wins), 1)


def batch_verify_sharded(items, mesh: Mesh, zs=None, streams: int = 16, c: int = msm_ops.FAST_WINDOW_BITS):
    """Ed25519 batch verification over the mesh: the same protocol as
    ops.ed25519.batch_verify, its (2n+1)-point MSM sharded (msm_sharded).
    Narrow windows (c=4) by default, as the single-card path. Returns (ok,
    diagnostics), the same on every rank."""
    from blobstreamx_tpu_torch.ops import ed25519 as dev_ed

    prep = dev_ed.prepare_batch(items, zs, c=c, device=mesh.device)
    if prep is None:
        return False, {"reason": "malformed input or s >= L"}
    points, digits, n_invalid = prep
    if n_invalid:
        return False, {"reason": "invalid point encoding"}
    result = msm_sharded(points, digits, mesh, streams=streams)
    ok = gold.point_equal(result, gold.IDENTITY)
    return ok, {"n": len(items), "msm_points": int(digits.shape[1])}
