"""Pure-Python golden model of Ed25519 (RFC 8032) — keygen, sign, verify.

Spec-derived (curve constants computed, not pasted) and cross-checked in tests
against the independent ``cryptography`` package. This model generates the
validator-signature fixtures and the expected results for the TPU batch
verifier (Pippenger bucketized MSM, config 3 at BASELINE.json:9).

Curve: twisted Edwards -x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19),
d = -121665/121666, base point B with y = 4/5 and even x, group order
L = 2^252 + 27742317777372353535851937790883648493.
"""

from __future__ import annotations

from .sha512 import sha512

Q = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, Q - 2, Q)) % Q


def _recover_x(y: int, sign: int) -> int | None:
    """Solve x^2 = (y^2 - 1) / (d y^2 + 1); pick root with given low bit."""
    if y >= Q:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, Q - 2, Q) % Q
    if x2 == 0:
        return None if sign else 0
    # sqrt via x = x2^((q+3)/8); multiply by sqrt(-1) if needed.
    x = pow(x2, (Q + 3) // 8, Q)
    if (x * x - x2) % Q != 0:
        x = x * pow(2, (Q - 1) // 4, Q) % Q
    if (x * x - x2) % Q != 0:
        return None
    if x & 1 != sign:
        x = Q - x
    return x


BASE_Y = 4 * pow(5, Q - 2, Q) % Q
BASE_X = _recover_x(BASE_Y, 0)

# Extended homogeneous coordinates (X, Y, Z, T), x = X/Z, y = Y/Z, T = XY/Z.
IDENTITY = (0, 1, 1, 0)
BASE = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % Q)


def point_add(p, q):
    """Complete twisted-Edwards addition (a = -1); valid for all inputs."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % Q
    b = (y1 + x1) * (y2 + x2) % Q
    c = 2 * t1 * t2 * D % Q
    dd = 2 * z1 * z2 % Q
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % Q, g * h % Q, f * g % Q, e * h % Q)


def point_mul(s: int, p):
    r = IDENTITY
    while s:
        if s & 1:
            r = point_add(r, p)
        p = point_add(p, p)
        s >>= 1
    return r


def point_equal(p, q) -> bool:
    # x1/z1 == x2/z2  and  y1/z1 == y2/z2
    return (p[0] * q[2] - q[0] * p[2]) % Q == 0 and (p[1] * q[2] - q[1] * p[2]) % Q == 0


def point_compress(p) -> bytes:
    zinv = pow(p[2], Q - 2, Q)
    x = p[0] * zinv % Q
    y = p[1] * zinv % Q
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def point_decompress(s: bytes):
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    sign = val >> 255
    y = val & ((1 << 255) - 1)
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % Q)


def _hash_mod_l(data: bytes) -> int:
    return int.from_bytes(sha512(data), "little") % L


def secret_expand(secret: bytes):
    assert len(secret) == 32
    h = sha512(secret)
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(secret: bytes) -> bytes:
    a, _ = secret_expand(secret)
    return point_compress(point_mul(a, BASE))


def sign(secret: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(secret)
    A = point_compress(point_mul(a, BASE))
    r = _hash_mod_l(prefix + msg)
    R = point_compress(point_mul(r, BASE))
    h = _hash_mod_l(R + A + msg)
    s = (r + h * a) % L
    return R + s.to_bytes(32, "little")


def verify(pubkey: bytes, msg: bytes, signature: bytes) -> bool:
    """Single-signature verify: [s]B == R + [h]A (cofactorless, as TendermintX)."""
    if len(signature) != 64:
        return False
    A = point_decompress(pubkey)
    R = point_decompress(signature[:32])
    if A is None or R is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    h = _hash_mod_l(signature[:32] + pubkey + msg)
    return point_equal(point_mul(s, BASE), point_add(R, point_mul(h, A)))


def batch_verify_equation(items: list[tuple[bytes, bytes, bytes]], zs: list[int]) -> bool:
    """Golden model of the batch equation the TPU MSM evaluates:

        [sum z_i s_i mod L] B == sum [z_i] R_i + sum [z_i h_i mod L] A_i

    items = [(pubkey, msg, signature)], zs = random 128-bit coefficients.
    """
    lhs_scalar = 0
    rhs = IDENTITY
    for (pk, msg, sig), z in zip(items, zs):
        A = point_decompress(pk)
        R = point_decompress(sig[:32])
        if A is None or R is None:
            return False
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            return False
        h = _hash_mod_l(sig[:32] + pk + msg)
        lhs_scalar = (lhs_scalar + z * s) % L
        rhs = point_add(rhs, point_mul(z % L, R))
        rhs = point_add(rhs, point_mul(z * h % L, A))
    return point_equal(point_mul(lhs_scalar, BASE), rhs)
