"""Pippenger bucketized multi-scalar multiplication.

No data-dependent branching: bucket accumulation walks the points in
groups, with K parallel streams each owning a private bucket copy, so every
step performs one vectorized complete-Edwards addition across
(windows x streams) lanes:

  - scalars -> (W, N) c-bit digit matrix (host, tiny)
  - step i: for every window w and stream k, add point i_k into bucket
    digits[w, i_k] of stream k's copy — a gather + batched point add +
    scatter over W*K lanes
  - merge the K stream copies (a compacting pairwise tree, log K adds)
  - per-window weighted bucket reduction sum_b b*S_b via a reversed
    Hillis-Steele suffix scan (c batched adds) + a compacting tree
  - window combine by Horner, either on the device (``combine_windows``:
    c doublings and one add a window on one lane, ``msm``) or on the host
    (``combine_windows_host``: W points of bigint work, ``msm_host_combined``)

Buckets are identity-initialized; digit-0 entries land in bucket 0, which
the weighted reduction excludes, so padding points with digit 0 is free.

The bitwise MSM (c = 1, ``msm_bitwise_windows_device``) needs no buckets:
window w's sum is a masked tree sum of the points whose bit w is set, so it
does no gather and no scatter, at four times the additions of c = 4 and a
power-of-two point count.

Every point addition goes through ``curve25519.add_fused`` (the Edwards-add
kernel on the card, one launch each).
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.ops import curve25519 as curve

WINDOW_BITS = 8
NUM_WINDOWS = 32  # ceil(256 / 8)

# Batch-verify defaults: narrow windows and a moderate stream count keep the
# number of sequential point additions low.
FAST_WINDOW_BITS = 4
FAST_STREAMS = 64


def fast_streams(device) -> int:
    """Stream count for the batch-verify path: 64 on the card, 4 on the CPU
    (a 64*16*64-lane bucket array is slow in the plain CPU version). The
    verdict is the same either way."""
    return FAST_STREAMS if torch.device(device).type == "cuda" else 4


def scalars_to_digits(scalars: list[int], c: int = WINDOW_BITS) -> np.ndarray:
    """(W, N) uint32 digit matrix, digit[w, i] = (s_i >> (c*w)) & (2^c - 1)."""
    w = -(-256 // c)
    out = np.zeros((w, len(scalars)), dtype=np.uint32)
    for i, s in enumerate(scalars):
        assert 0 <= s < (1 << 256)
        for j in range(w):
            out[j, i] = (s >> (c * j)) & ((1 << c) - 1)
    return out


def _index_tensor(x, dev) -> torch.Tensor:
    """A host digit matrix (numpy) or a tensor, as an int64 tensor on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(dev)


def _gather_point(p: curve.Point, idx) -> curve.Point:
    return tuple(c.index_select(1, idx) for c in p)


def _scatter_set(dst: curve.Point, idx, src: curve.Point) -> curve.Point:
    return tuple(d.index_copy(1, idx, s) for d, s in zip(dst, src))


def pad_to_streams(points: curve.Point, digits, streams: int = 16):
    """Pad (points, digits) with identity/digit-0 lanes to a multiple of the
    stream count (digit-0 padding is free: bucket 0 is never reduced).
    Returns the points and the digits as a tensor on the points' device."""
    dev = points[0].device
    digits = _index_tensor(digits, dev)
    w, n = digits.shape
    pad = (-n) % streams
    if pad:
        idn = curve.identity(pad, dev)
        points = tuple(torch.cat([a, b], dim=1) for a, b in zip(points, idn))
        digits = torch.cat([digits, torch.zeros((w, pad), dtype=torch.int64, device=dev)], dim=1)
    return points, digits


def fold_group_sums(p: curve.Point, group: int) -> curve.Point:
    """Sum each contiguous `group`-lane block, compacting: returns the
    (16, M/group) block sums. Each tree level adds only the surviving half
    (2M lane-adds in all), and every add is one clean slab."""
    m = p[0].shape[1]
    assert group & (group - 1) == 0 and m % group == 0
    n_groups = m // group
    x = tuple(c.reshape(16, n_groups, group) for c in p)
    g = group
    while g > 1:
        half = g // 2
        left = tuple(c[:, :, :half].reshape(16, n_groups * half) for c in x)
        right = tuple(c[:, :, half:].reshape(16, n_groups * half) for c in x)
        s = curve.add_fused(left, right)
        x = tuple(c.reshape(16, n_groups, half) for c in s)
        g = half
    return tuple(c.reshape(16, n_groups) for c in x)


def accumulate_buckets(points: curve.Point, digits, streams: int = 16, c: int = WINDOW_BITS) -> curve.Point:
    """Bucket accumulation. points: (16, N) coords; digits: (W, N) tensor, N
    a multiple of `streams`.

    Returns the merged bucket points as a (16, W*2^c)-lane Point:
    lane w*2^c + b  =  sum of points whose window-w digit is b.
    """
    n_buckets = 1 << c
    w, n = digits.shape
    k = streams  # power of two required by the pairwise merge
    assert k & (k - 1) == 0 and n % k == 0, (n, k)
    dev = points[0].device
    steps = n // k

    # per-stream bucket copies: lane layout (w * n_buckets + b) * k + stream
    buckets = curve.identity(w * n_buckets * k, dev)
    buckets = tuple(b.contiguous() for b in buckets)

    # step i handles points [i, i+steps, i+2*steps, ...], one per stream
    order = torch.arange(n, device=dev).reshape(k, steps).T.reshape(-1)
    pts = _gather_point(points, order)
    digs = digits.index_select(1, order).reshape(w, steps, k)
    win = torch.arange(w, device=dev)[:, None] * n_buckets
    stream = torch.arange(k, device=dev)[None, :]
    for i in range(steps):
        lane = ((win + digs[:, i]) * k + stream).reshape(-1)  # (W*K,)
        cur = _gather_point(buckets, lane)
        pt_wk = tuple(c[:, i * k : (i + 1) * k].repeat(1, w) for c in pts)
        buckets = _scatter_set(buckets, lane, curve.add_fused(cur, pt_wk))
    return fold_group_sums(buckets, k)  # (16, W*B)


def reduce_buckets(buckets: curve.Point, w: int = NUM_WINDOWS, c: int = WINDOW_BITS) -> curve.Point:
    """Per-window weighted sum sum_b b * S_b -> (16, W) window results.

    Suffix sums U_j = sum_{b>=j} S_b via a reversed Hillis-Steele scan
    (c steps of shifted gathers), then sum_{j>=1} U_j by fold_group_sums."""
    b = 1 << c
    m = w * b
    dev = buckets[0].device
    lane = torch.arange(m, device=dev)
    lane_b = lane % b
    idn = curve.identity(m, dev)
    suf = buckets
    for i in range(c):
        shift = 1 << i
        src = _gather_point(suf, torch.clamp(lane + shift, max=m - 1))
        src = curve.select(lane_b + shift < b, src, idn)
        suf = curve.add_fused(suf, src)
    # suf lane (w, j) = U_j; want sum_{j>=1} U_j: zero out U_0, fold each window
    suf = curve.select(lane_b != 0, suf, idn)
    return fold_group_sums(suf, b)  # (16, W)


def combine_windows(windows: curve.Point, c: int = WINDOW_BITS) -> curve.Point:
    """Horner on the device: result = sum_w 2^(c*w) W_w from the top window,
    c doublings and one add a window on one lane. Returns a (16, 1) point."""
    acc = curve.identity(1, windows[0].device)
    for j in reversed(range(windows[0].shape[1])):
        for _ in range(c):
            acc = curve.double(acc)
        acc = curve.add_fused(acc, tuple(x[:, j : j + 1] for x in windows))
    return acc


def msm(points: curve.Point, digits, streams: int = 16, c: int = WINDOW_BITS) -> curve.Point:
    """Full Pippenger MSM with the device combine: returns the (16, 1)-lane
    result point. digits: (W, N) tensor, N a multiple of `streams`."""
    w = digits.shape[0]
    buckets = accumulate_buckets(points, digits, streams=streams, c=c)
    windows = reduce_buckets(buckets, w, c=c)
    return combine_windows(windows, c=c)


def msm_windows(points: curve.Point, digits, c: int = FAST_WINDOW_BITS, streams: int | None = None):
    """Device Pippenger up to the per-window results, stacked (4, 16, W)."""
    streams = fast_streams(points[0].device) if streams is None else streams
    points, digits = pad_to_streams(points, digits, streams=streams)
    buckets = accumulate_buckets(points, digits, streams=streams, c=c)
    return torch.stack(reduce_buckets(buckets, digits.shape[0], c=c))


def msm_host_combined(points: curve.Point, digits, c: int = FAST_WINDOW_BITS, streams: int | None = None):
    """Full MSM: device buckets and windows, host combine. Returns host
    extended coordinates (x, y, z, t) as python ints."""
    return combine_windows_host(msm_windows(points, digits, c, streams), c)


def combine_windows_host(windows, c: int):
    """Host Horner over the (4, 16, W) window points: returns the extended-
    coordinate result as python ints (x, y, z, t)."""
    from blobstreamx_tpu_torch.fields import gf25519 as f
    from blobstreamx_tpu_torch.golden import ed25519 as gold

    stacked = windows.cpu().numpy() if isinstance(windows, torch.Tensor) else np.asarray(windows)
    coords = [f.to_int(stacked[i]) for i in range(4)]  # 4 x [W ints]
    w = len(coords[0])
    acc = gold.IDENTITY
    for j in reversed(range(w)):  # acc = 2^c * acc + W_j, top window first
        if j != w - 1:
            for _ in range(c):
                acc = gold.point_add(acc, acc)
        acc = gold.point_add(acc, tuple(coords[i][j] % gold.Q for i in range(4)))
    return acc


# ---------------------------------------------------------------------------
# bitwise-window MSM (c = 1): no buckets, no gathers, no scatters
# ---------------------------------------------------------------------------


def msm_bitwise_windows_device(points: curve.Point, bits) -> curve.Point:
    """All W window sums at once. points: (16, N) coords; bits: (W, N) 0/1
    tensor (scalars_to_digits with c=1), N a power of two >= 2. Level 0
    selects point or identity for each (window, lane) and adds the two
    halves; fold_group_sums does the rest. Returns (16, W): lane w = T_w."""
    w, n = bits.shape
    assert n & (n - 1) == 0 and n >= 2, n
    h = n // 2
    dev = points[0].device
    idn = curve.identity(w * h, dev)

    def masked_half(sel, pts):
        flat = tuple(c[:, None, :].expand(16, w, h).reshape(16, w * h) for c in pts)
        return curve.select(sel.reshape(-1) != 0, flat, idn)

    a = masked_half(bits[:, :h], tuple(c[:, :h] for c in points))
    b = masked_half(bits[:, h:], tuple(c[:, h:] for c in points))
    return fold_group_sums(curve.add_fused(a, b), h)  # (16, w)


def pad_points_bits_pow2(points: curve.Point, bits):
    """Identity/zero-bit pad N up to the next power of two (>= 2). Returns the
    points and the bits as a tensor on the points' device."""
    dev = points[0].device
    bits = _index_tensor(bits, dev)
    w, n = bits.shape
    n2 = max(2, 1 << (n - 1).bit_length())
    if n2 != n:
        idn = curve.identity(n2 - n, dev)
        points = tuple(torch.cat([a, b], dim=1) for a, b in zip(points, idn))
        bits = torch.cat([bits, torch.zeros((w, n2 - n), dtype=torch.int64, device=dev)], dim=1)
    return points, bits


def msm_bitwise_host_combined(points: curve.Point, scalars: list[int]):
    """Full MSM via bitwise windows and the host Horner (c=1: W doublings and
    adds of host bigint work). Returns extended coords as python ints."""
    points, bits = pad_points_bits_pow2(points, scalars_to_digits(scalars, c=1))
    return combine_windows_host(torch.stack(msm_bitwise_windows_device(points, bits)), 1)
