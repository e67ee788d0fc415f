"""The GF(2^255-19) arithmetic of csrc/ed25519.cu, run on the CPU.

The kernel's field operations are inline-PTX blocks (carry-flag chains over
8 u32 words). These tests read each block out of the .cu text and run its
instructions one by one in Python integers, a model of the PTX semantics
(mad.lo/hi, add/sub with the carry flag, selp), and hold the results to
bigints and to the JAX package's gf25519 (jnp on the CPU), on edge values and
on semi-reduced inputs in [p, 2^256). Every instruction that does not write
the carry flag is also checked not to carry out of its 32 bits, which is the
range argument the .cu's comments make. The Edwards add's role schedule and
the pow22523 chain are then run on the model, as the kernels run them, and
held to the golden model. The kernel itself runs only on the card
(tests/test_torch_kernels_cuda.py)."""

import re
from pathlib import Path

import jax
import numpy as np
import pytest

from blobstreamx_tpu.fields import gf25519 as jf
from blobstreamx_tpu.ops import curve25519 as jcurve
from blobstreamx_tpu_torch.golden import ed25519 as ged

SRC = (Path(__file__).resolve().parent.parent / "blobstreamx_tpu_torch" / "csrc" / "ed25519.cu").read_text()
Q = ged.Q
M32 = (1 << 32) - 1
SQRT_M1 = pow(2, (Q - 1) // 4, Q)

EDGES = [0, 1, 2, 19, 38, Q - 1, Q, Q + 1, Q + 18, 2 * Q - 1, 2 * Q, (1 << 255) - 1, 1 << 255,
         (1 << 256) - 39, (1 << 256) - 38, (1 << 256) - 1, (1 << 128) - 1,
         int("0000ffff" * 8, 16), int("ffff0000" * 8, 16), int("ffffffff00000000" * 4, 16)]


def _values(seed: int, n: int) -> list[int]:
    """EDGES, then random values below 2^256 and random semi-reduced ones in [p, 2^256)."""
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    semi = [Q + int.from_bytes(rng.bytes(32), "little") % ((1 << 256) - Q) for _ in range(n)]
    return EDGES + rand + semi


# ----------------------------------------------------------------------------
# the PTX blocks of the .cu and a model of their instructions
# ----------------------------------------------------------------------------


def _block(fn: str) -> list[tuple]:
    """The instructions of the asm block inside `fe <fn>(...)`, parsed."""
    body = SRC[SRC.index(f" {fn}(") :]
    text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', re.search(r"asm\((.*?)\n\s*:", body, re.S).group(1)))
    out = []
    for ins in text.replace("\\n", "\n").replace("\\t", "").split(";"):
        ins = ins.strip().strip("{}").strip()
        if not ins or ins.startswith(".reg"):
            continue
        op, rest = ins.split(None, 1)
        out.append((op, [a.strip() for a in rest.split(",")]))
    return out


BLOCKS = {fn: _block(fn) for fn in ("fe_add", "fe_sub", "fe_mul", "fe_sq", "fe_canonical")}


def run_ptx(block: str, operands: dict) -> dict:
    """Run a block over u32 registers; the carry flag is a carry for add and
    mad, a borrow for sub (as in PTX). Raises if an instruction without .cc
    carries or borrows out of 32 bits (subc's 0 - 0 - borrow mask aside)."""
    regs, cf, pred = dict(operands), 0, {}

    def val(x):
        return regs[x] if x in regs else int(x, 0)

    for op, args in BLOCKS[block]:
        parts = op.split(".")
        base, cc = parts[0], "cc" in parts
        d = args[0]
        if base == "selp":
            regs[d] = val(args[1]) if pred[args[3]] else val(args[2])
            continue
        src = [val(a) for a in args[1:]]
        if base == "setp":
            assert parts[1] == "ne"
            pred[d] = src[0] != src[1]
            continue
        if base in ("mul", "mad", "madc"):
            prod = src[0] * src[1]
            s = (prod >> 32 if "hi" in parts else prod & M32) + (src[2] if base != "mul" else 0)
            s += cf if base == "madc" else 0
        elif base in ("add", "addc"):
            s = src[0] + src[1] + (cf if base == "addc" else 0)
        elif base in ("sub", "subc"):
            s = src[0] - src[1] - (cf if base == "subc" else 0)
        elif base == "and":
            s = src[0] & src[1]
        elif base == "shr":
            s = src[0] >> src[1]
        else:
            raise ValueError(f"instruction not modelled: {op}")
        if cc:
            cf = int(s < 0) if base in ("sub", "subc") else int(s > M32)
        elif base in ("add", "addc", "mad", "madc", "sub"):
            assert 0 <= s <= M32, f"{op} {', '.join(args)} carries out of 32 bits ({s:#x})"
        regs[d] = s & M32
    return regs


def words(x: int) -> list[int]:
    return [(x >> (32 * k)) & M32 for k in range(8)]


def fe_op(block: str, *xs: int) -> int:
    """One field operation of the .cu on values < 2^256: inputs bound to
    %8.. (8 words each), the result read from %0..%7."""
    ops = {f"%{8 + 8 * i + k}": w for i, x in enumerate(xs) for k, w in enumerate(words(x))}
    regs = run_ptx(block, ops)
    return sum(regs[f"%{k}"] << (32 * k) for k in range(8))


def fe_load(limbs: list[int]) -> int:
    """fe_load: __byte_perm(limb 2k, limb 2k+1, 0x5410), the low 16 bits of each."""
    return sum(((limbs[2 * k] & 0xFFFF) | (limbs[2 * k + 1] & 0xFFFF) << 16) << (32 * k) for k in range(8))


def fe_store(x: int) -> list[int]:
    """fe_store: fe_canonical, then each word as two 16-bit limbs."""
    c = fe_op("fe_canonical", x)
    return [(c >> (16 * i)) & 0xFFFF for i in range(16)]


def limbs_of(x: int) -> list[int]:
    return [(x >> (16 * i)) & 0xFFFF for i in range(16)]


def from_limbs(limbs: list[int]) -> int:
    return sum(v << (16 * i) for i, v in enumerate(limbs))


# ----------------------------------------------------------------------------
# constants
# ----------------------------------------------------------------------------


def test_ed25519_kernel_constants_match_jax():
    """FE_K2D is the JAX package's 2d; the fold's immediates are 2^256 mod p
    and the canonical step's 2^255 mod p."""
    k2d = [int(v.rstrip("u"), 16) for v in re.search(r"FE_K2D\[8\] = \{([^}]*)\}", SRC).group(1).split(",")]
    assert sum(w << (32 * k) for k, w in enumerate(k2d)) == jcurve.TWO_D == 2 * ged.D % Q
    folds = {a for blk in ("fe_add", "fe_mul", "fe_sq") for op, args in BLOCKS[blk]
             if op.split(".")[0] in ("mul", "mad", "madc") for a in args[1:3] if a.isdigit()}
    assert folds == {str(2**256 % Q)} == {"38"}
    assert {a for op, args in BLOCKS["fe_canonical"] for a in args if a.isdigit() and a != "0"} \
        >= {str(2**255 % Q)} == {"19"}


# ----------------------------------------------------------------------------
# the field operations vs bigints and the JAX package
# ----------------------------------------------------------------------------

_JAX_OPS = {"fe_add": jf.add, "fe_sub": jf.sub, "fe_mul": jf.mul, "fe_sq": lambda a: jf.mul(a, a)}
_BIG = {"fe_add": lambda a, b: a + b, "fe_sub": lambda a, b: a - b, "fe_mul": lambda a, b: a * b,
        "fe_sq": lambda a: a * a}


@pytest.mark.parametrize("seed, block", enumerate(["fe_add", "fe_sub", "fe_mul", "fe_sq"]))
def test_ptx_field_op_matches_bigints_and_jax(seed, block):
    vals = _values(seed, 12)
    if block == "fe_sq":
        pairs = [(a,) for a in vals]
    else:
        pairs = [(a, b) for a in vals for b in EDGES] + list(zip(vals, reversed(vals)))
    got = [fe_op(block, *xs) for xs in pairs]
    assert all(g < 1 << 256 for g in got)
    assert [g % Q for g in got] == [_BIG[block](*xs) % Q for xs in pairs]
    args = [jf.from_int([xs[i] for xs in pairs]) for i in range(len(pairs[0]))]
    want = jf.to_int(jax.jit(_JAX_OPS[block])(*args))
    assert [g % Q for g in got] == [w % Q for w in want]


def test_ptx_canonical_store_matches_bigints_and_jax():
    vals = _values(5, 30)
    got = [fe_store(v) for v in vals]
    assert all(max(limbs) < 1 << 16 for limbs in got)
    assert [from_limbs(limbs) for limbs in got] == [v % Q for v in vals]
    assert [from_limbs(limbs) for limbs in got] == jf.to_int(jax.jit(jf.canonicalize)(jf.from_int(vals)))
    assert [fe_load(limbs_of(v)) for v in vals] == vals
    assert fe_load([0x1FFFF] * 16) == (1 << 256) - 1  # only each limb's low 16 bits are read


# ----------------------------------------------------------------------------
# the Edwards add's role schedule and the power chain, on the model
# ----------------------------------------------------------------------------


def edwards_add_roles(p, q):
    """edwards_add_kernel's schedule for one lane: the four roles' products
    (a, b, c, d), which meet in shared memory, then each role's output
    coordinate, stored canonical."""
    x1, y1, z1, t1 = (fe_load(limbs_of(v)) for v in p)
    x2, y2, z2, t2 = (fe_load(limbs_of(v)) for v in q)
    k2d = jcurve.TWO_D
    a = fe_op("fe_mul", fe_op("fe_sub", y1, x1), fe_op("fe_sub", y2, x2))  # role 0
    b = fe_op("fe_mul", fe_op("fe_add", y1, x1), fe_op("fe_add", y2, x2))  # role 1
    c = fe_op("fe_mul", fe_op("fe_mul", t1, k2d), t2)  # role 2
    d = fe_op("fe_mul", fe_op("fe_add", z1, z1), z2)  # role 3
    outs = (
        fe_op("fe_mul", fe_op("fe_sub", b, a), fe_op("fe_sub", d, c)),  # role 0: X = e f
        fe_op("fe_mul", fe_op("fe_add", d, c), fe_op("fe_add", b, a)),  # role 1: Y = g h
        fe_op("fe_mul", fe_op("fe_sub", d, c), fe_op("fe_add", d, c)),  # role 2: Z = f g
        fe_op("fe_mul", fe_op("fe_sub", b, a), fe_op("fe_add", b, a)),  # role 3: T = e h
    )
    return tuple(from_limbs(fe_store(o)) for o in outs)


def _point(seed: int):
    rng = np.random.default_rng(seed)
    pt = ged.point_mul(int(rng.integers(1, 1 << 62)), ged.BASE)
    lam = int(rng.integers(1, 1 << 62))
    return tuple(c * lam % Q for c in pt)


def _neg(pt):
    return ((-pt[0]) % Q, pt[1], pt[2], (-pt[3]) % Q)


def _lift(pt):
    """The same point with every coordinate stored semi-reduced (+ p) where that stays < 2^256."""
    return tuple(c + Q if c + Q < 1 << 256 else c for c in pt)


_P1, _P2 = _point(1), _point(2)
ADD_CASES = {
    "generic": (_P1, _P2),
    "identity": (_P1, ged.IDENTITY),
    "identity_plus_identity": (ged.IDENTITY, ged.IDENTITY),
    "doubling": (_P1, _P1),
    "p_plus_minus_p": (_P1, _neg(_P1)),
    "order_2_point": (_P1, (0, Q - 1, 1, 0)),
    "order_4_point": ((SQRT_M1, 0, 1, 0), (SQRT_M1, 0, 1, 0)),
    "semi_reduced_coordinates": (_lift(_P1), _lift(_P2)),
}


@pytest.mark.parametrize("case", list(ADD_CASES))
def test_edwards_add_role_schedule_matches_golden(case):
    p, q = ADD_CASES[case]
    got = edwards_add_roles(p, q)
    want = ged.point_add(tuple(c % Q for c in p), tuple(c % Q for c in q))
    assert got == want  # the same formula: equal coordinates, not only the same point
    if case == "p_plus_minus_p":
        assert ged.point_equal(got, ged.IDENTITY)


def test_power_chain_on_the_model_matches_bigints():
    """pow22523_kernel's chain (fe_sq for every squaring, 11 multiplies) and
    sqn_kernel's loop, on the model."""

    def sqn(a, k):
        for _ in range(k):
            a = fe_op("fe_sq", a)
        return a

    def mul(a, b):
        return fe_op("fe_mul", a, b)

    def pow22523(z):
        z2 = fe_op("fe_sq", z)
        z9 = mul(sqn(z2, 2), z)
        z11 = mul(z9, z2)
        z_5 = mul(fe_op("fe_sq", z11), z9)
        z_10 = mul(sqn(z_5, 5), z_5)
        z_20 = mul(sqn(z_10, 10), z_10)
        z_40 = mul(sqn(z_20, 20), z_20)
        z_50 = mul(sqn(z_40, 10), z_10)
        z_100 = mul(sqn(z_50, 50), z_50)
        z_200 = mul(sqn(z_100, 100), z_100)
        z_250 = mul(sqn(z_200, 50), z_50)
        return mul(sqn(z_250, 2), z)

    for z in (0, 1, Q - 1, Q + 5, (1 << 256) - 1, _P1[0]):
        assert from_limbs(fe_store(pow22523(z))) == pow(z, (1 << 252) - 3, Q)
        for k in (1, 5):
            assert from_limbs(fe_store(sqn(z, k))) == pow(z, 1 << k, Q)
