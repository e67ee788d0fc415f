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
  - window combine by Horner on the host (W points of bigint work)

Buckets are identity-initialized; digit-0 entries land in bucket 0, which
the weighted reduction excludes, so padding points with digit 0 is free.
Every point addition goes through ``curve25519.add_fused`` (the Edwards-add
kernel on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.ops import curve25519 as curve

# Batch-verify defaults: narrow windows and a moderate stream count keep the
# number of sequential point additions low.
FAST_WINDOW_BITS = 4
FAST_STREAMS = 64


def fast_streams(device) -> int:
    """Stream count for the batch-verify path: 64 on the card, 4 on the CPU
    (a 64*16*64-lane bucket array is slow in the plain CPU version). The
    verdict is the same either way."""
    return FAST_STREAMS if torch.device(device).type == "cuda" else 4


def scalars_to_digits(scalars: list[int], c: int) -> np.ndarray:
    """(W, N) uint32 digit matrix, digit[w, i] = (s_i >> (c*w)) & (2^c - 1)."""
    w = -(-256 // c)
    out = np.zeros((w, len(scalars)), dtype=np.uint32)
    for i, s in enumerate(scalars):
        assert 0 <= s < (1 << 256)
        for j in range(w):
            out[j, i] = (s >> (c * j)) & ((1 << c) - 1)
    return out


def _gather_point(p: curve.Point, idx) -> curve.Point:
    return tuple(c.index_select(1, idx) for c in p)


def _scatter_set(dst: curve.Point, idx, src: curve.Point) -> curve.Point:
    return tuple(d.index_copy(1, idx, s) for d, s in zip(dst, src))


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


def accumulate_buckets(points: curve.Point, digits, streams: int, c: int) -> curve.Point:
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


def reduce_buckets(buckets: curve.Point, w: int, c: int) -> curve.Point:
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
