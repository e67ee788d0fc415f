"""Ed25519 (RFC 8032): keys, signing and cofactorless verification, as
Tendermint validators sign and TendermintX checks, in plain Python.

Points are extended homogeneous coordinates (X, Y, Z, T) on
-x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19). Multiples of the base point
come from a table of j * 16^i * B (i < 64, j < 16), so a fixed-base
multiplication is 64 additions; other points take a 4-bit window.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

Q = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, Q - 2, Q)) % Q
D2 = 2 * D % Q
SQRT_M1 = pow(2, (Q - 1) // 4, Q)


def _recover_x(y: int, sign: int) -> int | None:
    if y >= Q:
        return None
    x2 = (y * y - 1) * pow(D * y * y + 1, Q - 2, Q) % Q
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (Q + 3) // 8, Q)
    if (x * x - x2) % Q != 0:
        x = x * SQRT_M1 % Q
    if (x * x - x2) % Q != 0:
        return None
    if x & 1 != sign:
        x = Q - x
    return x


BASE_Y = 4 * pow(5, Q - 2, Q) % Q
BASE_X = _recover_x(BASE_Y, 0)
IDENTITY = (0, 1, 1, 0)
BASE = (BASE_X, BASE_Y, 1, BASE_X * BASE_Y % Q)


def point_add(p, q):
    """Complete addition on the a = -1 twisted Edwards curve."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % Q
    b = (y1 + x1) * (y2 + x2) % Q
    c = t1 * t2 % Q * D2 % Q
    dd = 2 * z1 * z2 % Q
    e, f, g, h = b - a, dd - c, dd + c, b + a
    return (e * f % Q, g * h % Q, f * g % Q, e * h % Q)


@lru_cache(maxsize=None)
def _base_table() -> tuple:
    rows = []
    p = BASE
    for _ in range(64):
        row = [IDENTITY, p]
        for _ in range(14):
            row.append(point_add(row[-1], p))
        rows.append(tuple(row))
        for _ in range(4):
            p = point_add(p, p)
    return tuple(rows)


def base_mul(s: int):
    """[s]B for 0 <= s < 2^256."""
    table = _base_table()
    r = IDENTITY
    for i in range(64):
        digit = (s >> (4 * i)) & 15
        if digit:
            r = point_add(r, table[i][digit])
    return r


def point_mul(s: int, p):
    """[s]P, 4-bit window, most significant digit first."""
    row = [IDENTITY, p]
    for _ in range(14):
        row.append(point_add(row[-1], p))
    r = IDENTITY
    for i in range(63, -1, -1):
        for _ in range(4):
            r = point_add(r, r)
        digit = (s >> (4 * i)) & 15
        if digit:
            r = point_add(r, row[digit])
    return r


def point_equal(p, q) -> bool:
    return (p[0] * q[2] - q[0] * p[2]) % Q == 0 and (p[1] * q[2] - q[1] * p[2]) % Q == 0


def compress(p) -> bytes:
    zinv = pow(p[2], Q - 2, Q)
    x = p[0] * zinv % Q
    y = p[1] * zinv % Q
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def decompress(s: bytes):
    if len(s) != 32:
        return None
    val = int.from_bytes(s, "little")
    y = val & ((1 << 255) - 1)
    x = _recover_x(y, val >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % Q)


def _hash_mod_l(data: bytes) -> int:
    return int.from_bytes(hashlib.sha512(data).digest(), "little") % L


def expand_secret(secret: bytes) -> tuple[int, bytes, bytes]:
    """(scalar a, prefix, public key A) of a 32-byte secret seed."""
    h = hashlib.sha512(secret).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:], compress(base_mul(a))


def sign(expanded: tuple[int, bytes, bytes], msg: bytes) -> bytes:
    a, prefix, pub = expanded
    r = _hash_mod_l(prefix + msg)
    big_r = compress(base_mul(r))
    h = _hash_mod_l(big_r + pub + msg)
    return big_r + ((r + h * a) % L).to_bytes(32, "little")


def verify(pubkey: bytes, msg: bytes, signature: bytes) -> bool:
    """[s]B == R + [h]A, cofactorless, s < L."""
    if len(signature) != 64:
        return False
    a_pt = decompress(pubkey)
    r_pt = decompress(signature[:32])
    if a_pt is None or r_pt is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    if s >= L:
        return False
    h = _hash_mod_l(signature[:32] + pubkey + msg)
    return point_equal(base_mul(s), point_add(r_pt, point_mul(h, a_pt)))
