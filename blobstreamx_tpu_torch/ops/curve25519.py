"""Batched edwards25519 point arithmetic.

Points are extended homogeneous coordinates (X, Y, Z, T), each a (16, N)
gf25519 limb tensor. The addition law is the *complete* unified
twisted-Edwards formula (a = -1 is a square mod p, d is a non-square, so one
formula handles generic adds, doublings and the identity with no branches).

``add`` is the plain version; ``add_fused`` is the entry point the MSM
and ``double`` call: on CUDA tensors it launches the Edwards-add kernel
(csrc/ed25519.cu), whose outputs are canonical; on CPU tensors it runs
``add``. The two agree as field values.

Golden oracle: blobstreamx_tpu_torch.golden.ed25519.
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch import kernels
from blobstreamx_tpu_torch.device import on_cuda
from blobstreamx_tpu_torch.fields import gf25519 as f
from blobstreamx_tpu_torch.golden import ed25519 as gold

Q = gold.Q
D = gold.D
TWO_D = (2 * D) % Q
SQRT_M1 = pow(2, (Q - 1) // 4, Q)  # sqrt(-1)

# A point batch is a tuple (X, Y, Z, T) of (16, N) int64 tensors.
Point = tuple


def identity(n: int, device=None) -> Point:
    return (f.zeros(n, device), f.full(n, 1, device), f.full(n, 1, device), f.zeros(n, device))


def base_point(n: int, device=None) -> Point:
    return (
        f.full(n, gold.BASE_X, device),
        f.full(n, gold.BASE_Y, device),
        f.full(n, 1, device),
        f.full(n, gold.BASE_X * gold.BASE_Y % Q, device),
    )


def add(p: Point, q: Point) -> Point:
    """Complete unified addition (add-2008-hwcd-3 with k = 2d), plain."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = f.mul(f.sub(y1, x1), f.sub(y2, x2))
    b = f.mul(f.add(y1, x1), f.add(y2, x2))
    k2d = f.full(x1.shape[1], TWO_D, x1.device)
    c = f.mul(f.mul(t1, k2d), t2)
    d = f.mul(f.add(z1, z1), z2)
    e = f.sub(b, a)
    ff = f.sub(d, c)
    g = f.add(d, c)
    h = f.add(b, a)
    return (f.mul(e, ff), f.mul(g, h), f.mul(ff, g), f.mul(e, h))


def _add_cuda(p: Point, q: Point) -> Point:
    coords = [c.contiguous() for c in (*p, *q)]
    n = coords[0].shape[1]
    for c in coords:
        if c.dtype != torch.int64 or c.shape != (f.NLIMB, n) or c.device != coords[0].device:
            raise ValueError("add_fused expects eight (16, N) int64 tensors on one device")
    outs = [torch.empty_like(coords[0]) for _ in range(4)]
    lib = kernels.load("ed25519")
    with torch.cuda.device(coords[0].device):
        rc = lib.bsx_ed25519_add(
            *(c.data_ptr() for c in coords), *(o.data_ptr() for o in outs), n,
            kernels.stream_of(coords[0]),
        )
    kernels.check(rc, "edwards-add kernel")
    kernels.count("edwards_add")
    return tuple(outs)


def add_fused(p: Point, q: Point) -> Point:
    """Complete addition: the Edwards-add kernel on CUDA tensors, the plain
    formula on CPU tensors (equal field values)."""
    if on_cuda(p[0]):
        return _add_cuda(p, q)
    return add(p, q)


def double(p: Point) -> Point:
    """2p by the complete addition law, add_fused(p, p): one Edwards-add
    launch on CUDA tensors."""
    return add_fused(p, p)


def neg(p: Point) -> Point:
    return (f.neg(p[0]), p[1], p[2], f.neg(p[3]))


def select(mask, p: Point, q: Point) -> Point:
    return tuple(f.select(mask, a, b) for a, b in zip(p, q))


def equal(p: Point, q: Point):
    """Projective equality mask (N,): X1Z2 == X2Z1 and Y1Z2 == Y2Z1."""
    ex = f.eq(f.mul(p[0], q[2]), f.mul(q[0], p[2]))
    ey = f.eq(f.mul(p[1], q[2]), f.mul(q[1], p[2]))
    return ex & ey


def is_identity(p: Point):
    return equal(p, identity(p[0].shape[1], p[0].device))


def on_curve(p: Point):
    """-x^2 + y^2 == z^2 + d*t^2  and  x*y == z*t (extended-coords invariants)."""
    x, y, z, t = p
    lhs = f.sub(f.mul(y, y), f.mul(x, x))
    rhs = f.add(f.mul(z, z), f.mul(f.full(x.shape[1], D, x.device), f.mul(t, t)))
    return f.eq(lhs, rhs) & f.eq(f.mul(x, y), f.mul(z, t))


# ----------------------------------------------------------------------------
# decompression (RFC 8032 §5.1.3), batched on the device
# ----------------------------------------------------------------------------


def decompress(encoded: np.ndarray, device=None):
    """encoded: (32, N) uint8 little-endian point encodings (host numpy).

    Returns (Point, valid_mask). Invalid lanes decode to the identity with
    valid=False."""
    y_limbs, sign = unpack_y_limbs_host(encoded)
    return decompress_limbs(
        torch.from_numpy(y_limbs).to(device), torch.from_numpy(sign).to(device)
    )


def decompress_limbs(y, sign):
    n = y.shape[1]
    dev = y.device
    one = f.full(n, 1, dev)
    y2 = f.mul(y, y)
    u = f.sub(y2, one)  # y^2 - 1
    v = f.add(f.mul(f.full(n, D, dev), y2), one)  # d y^2 + 1
    # x = u v^3 (u v^7)^((q-5)/8): one ~254-mul chain; the candidate-root
    # checks are multiplicative (v x^2 ?= u), so no inversion is needed
    v3 = f.mul(f.mul(v, v), v)
    v7 = f.mul(f.mul(v3, v3), v)
    x = f.mul(f.mul(u, v3), f.pow22523(f.mul(u, v7)))
    vx2 = f.mul(v, f.mul(x, x))
    needs_sqrtm1 = ~f.eq(vx2, u)
    x_alt = f.mul(x, f.full(n, SQRT_M1, dev))
    x = f.select(needs_sqrtm1, x_alt, x)
    valid = f.eq(f.mul(v, f.mul(x, x)), u)
    # y must be < p for a canonical encoding
    valid = valid & (y == f.canonicalize(y)).all(dim=0)

    x_can = f.canonicalize(x)
    x_is_zero = f.is_zero(x_can)
    # sign==1 with x==0 is invalid
    valid = valid & ~(x_is_zero & (sign == 1))
    flip = (x_can[0] & 1) != sign
    x_final = f.select(flip, f.sub(f.zeros(n, dev), x_can), x_can)

    pt = (x_final, y, one, f.mul(x_final, y))
    return select(valid, pt, identity(n, dev)), valid


def unpack_y_limbs_host(encoded: np.ndarray):
    """(32, N) uint8 encodings -> ((16, N) int64 y limbs, (N,) sign bits)."""
    n = encoded.shape[1]
    sign = (encoded[31] >> 7).astype(np.int64)
    enc = encoded.copy()
    enc[31] &= 0x7F
    y_limbs = np.zeros((16, n), dtype=np.int64)
    for i in range(16):
        y_limbs[i] = enc[2 * i].astype(np.int64) | (enc[2 * i + 1].astype(np.int64) << 8)
    return y_limbs, sign


def encode_points_host(raw: list[bytes]) -> np.ndarray:
    """list of 32-byte encodings -> (32, N) uint8."""
    return np.frombuffer(b"".join(raw), dtype=np.uint8).reshape(-1, 32).T.copy()


def to_affine_ints(p: Point) -> list[tuple[int, int]]:
    """Host-side: canonical (x, y) pairs for comparison with the golden model."""
    zinv = f.inv(p[2])
    x = f.to_int(f.canonicalize(f.mul(p[0], zinv)))
    y = f.to_int(f.canonicalize(f.mul(p[1], zinv)))
    return list(zip(x, y))
