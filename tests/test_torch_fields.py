"""Port field arithmetic (blobstreamx_tpu_torch.fields) vs the JAX package
and the golden models, on the CPU. Exact equality: the system is
integer-only. GF(2^255-19) values are compared limb for limb where the two
packages run the same plain algorithm, and after canonicalization
otherwise."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.fields import gf64 as jgf
from blobstreamx_tpu.fields import gf25519 as jf
from blobstreamx_tpu_torch.fields import gf64 as tgf
from blobstreamx_tpu_torch.fields import gf25519 as tf
from blobstreamx_tpu_torch.golden import goldilocks as gold

torch.set_num_threads(1)
P = gold.P
Q = tf.Q


def gl_values(seed: int, n: int) -> np.ndarray:
    """Canonical Goldilocks values, the edge cases near 0, 2^32 and p first."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 63, size=n, dtype=np.uint64) * np.uint64(2)
    v = (v + rng.integers(0, 2, size=n, dtype=np.uint64)) % np.uint64(P)
    edges = [0, 1, 2, P - 1, P - 2, P - (1 << 32), P - (1 << 32) + 1, (1 << 32) - 1,
             1 << 32, (1 << 32) + 1, (1 << 63), (1 << 64) - (1 << 33)]
    v[: len(edges)] = edges
    return v


def fe_values(seed: int, n: int) -> list[int]:
    """GF(2^255-19) limb values < 2^256 (semi-reduced allowed), edges first."""
    rng = np.random.default_rng(seed)
    edges = [0, 1, 2, Q - 1, Q, Q + 1, 2 * Q - 1, 2 * Q, (1 << 256) - 1, (1 << 255) - 20, 1 << 128]
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    vals[: len(edges)] = edges
    return vals


def jax_gl(v):
    return jgf.from_u64(v)


def torch_gl(v):
    return tgf.from_u64(v)


GOLD_BINARY = {
    "gl_add": lambda a, b: (a + b) % P,
    "gl_sub": lambda a, b: (a - b) % P,
    "gl_mul": lambda a, b: (a * b) % P,
}


@pytest.mark.parametrize("op", sorted(GOLD_BINARY))
def test_gl_binary_matches_jax_and_golden(op):
    a, b = gl_values(1, 300), gl_values(2, 300)[::-1].copy()
    got = tgf.to_u64(getattr(tgf, op)(torch_gl(a), torch_gl(b)))
    want = jgf.to_u64(getattr(jgf, op)(jax_gl(a), jax_gl(b)))
    np.testing.assert_array_equal(got, want)
    assert [int(x) for x in got] == [GOLD_BINARY[op](int(x), int(y)) for x, y in zip(a, b)]


@pytest.mark.parametrize("op", ["gl_neg", "gl_square", "gl_inv"])
def test_gl_unary_matches_jax(op):
    a = gl_values(3, 200)
    got = tgf.to_u64(getattr(tgf, op)(torch_gl(a)))
    want = jgf.to_u64(getattr(jgf, op)(jax_gl(a)))
    np.testing.assert_array_equal(got, want)


def test_gl_inv_golden():
    a = gl_values(4, 64)
    got = tgf.to_u64(tgf.gl_inv(torch_gl(a)))
    assert [int(x) for x in got] == [pow(int(x), P - 2, P) for x in a]


def test_gl_roundtrip_and_full():
    a = gl_values(6, 50)
    np.testing.assert_array_equal(tgf.to_u64(torch_gl(a)), a)
    f = tgf.full((3, 2), P + 5)
    np.testing.assert_array_equal(tgf.to_u64(f), np.full((3, 2), 5, np.uint64))


def _ext(seed, n):
    return gl_values(seed, n), gl_values(seed + 100, n)


@pytest.mark.parametrize("op", ["ext_add", "ext_sub", "ext_mul", "ext_inv"])
def test_ext_matches_golden(op):
    a, b = _ext(7, 40), _ext(8, 40)
    ta = (torch_gl(a[0]), torch_gl(a[1]))
    tb = (torch_gl(b[0]), torch_gl(b[1]))
    if op == "ext_inv":
        out = tgf.ext_inv(ta)
        want = [gold.ext_inv((int(x), int(y))) if (x or y) else (0, 0) for x, y in zip(*a)]
    else:
        out = getattr(tgf, op)(ta, tb)
        want = [getattr(gold, op)((int(x), int(y)), (int(u), int(v))) for x, y, u, v in zip(*a, *b)]
    got = list(zip(map(int, tgf.to_u64(out[0])), map(int, tgf.to_u64(out[1]))))
    assert got == want


def test_ext_mul_matches_jax():
    a, b = _ext(9, 40), _ext(10, 40)
    got = tgf.ext_mul((torch_gl(a[0]), torch_gl(a[1])), (torch_gl(b[0]), torch_gl(b[1])))
    want = jgf.ext_mul((jax_gl(a[0]), jax_gl(a[1])), (jax_gl(b[0]), jax_gl(b[1])))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tgf.to_u64(g), jgf.to_u64(w))


# ----------------------------------------------------------------------------
# GF(2^255 - 19)
# ----------------------------------------------------------------------------


def fe_pair(seed, n=40):
    vals = fe_values(seed, n)
    return tf.from_int(vals), np.asarray(jf.from_int(vals))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_fe_binary_limbs_match_jax(op):
    ta, ja = fe_pair(11)
    tb, jb = fe_pair(12)
    tb, jb = tb.flip(1), jb[:, ::-1].copy()
    got = getattr(tf, op)(ta, tb).numpy()
    want = np.asarray(getattr(jf, op)(ja, jb)).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    py = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "mul": lambda x, y: x * y}[op]
    a_int, b_int = tf.to_int(ta), tf.to_int(tb)
    assert [v % Q for v in tf.to_int(getattr(tf, op)(ta, tb))] == [py(x, y) % Q for x, y in zip(a_int, b_int)]


def test_fe_canonicalize_matches_jax():
    ta, ja = fe_pair(13)
    got = tf.canonicalize(ta).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.canonicalize(ja)).astype(np.int64))
    assert tf.to_int(tf.canonicalize(ta)) == [v % Q for v in fe_values(13, 40)]


@pytest.mark.parametrize("k", [1, 3])
def test_fe_sqn_matches_jax(k):
    ta, ja = fe_pair(14, 16)
    got = tf.sqn(ta, k).numpy()
    np.testing.assert_array_equal(got, np.asarray(jf.sqn(ja, k)).astype(np.int64))


def test_fe_sqn_matches_pallas_interpret():
    """The Pallas sqn kernel (interpret mode, 128 lanes) against the port."""
    from jax.experimental.pallas import tpu as pltpu

    vals = fe_values(15, 128)
    with pltpu.force_tpu_interpret_mode():
        want = jf.to_int(jf.canonicalize(jf._sqn_call(128, 3)(jf.from_int(vals))))
    assert tf.to_int(tf.canonicalize(tf.sqn(tf.from_int(vals), 3))) == want


def test_fe_pow22523_and_inv_golden():
    vals = fe_values(16, 12)
    a = tf.from_int(vals)
    assert tf.to_int(tf.canonicalize(tf.pow22523(a))) == [pow(v, (1 << 252) - 3, Q) for v in vals]
    assert tf.to_int(tf.canonicalize(tf.inv(a))) == [pow(v, Q - 2, Q) for v in vals]


# ----------------------------------------------------------------------------
# Goldilocks: pow, select, eq, mul_pow2, and the ext helpers
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("e", [0, 1, 7, 15, 16, P - 2])
def test_gl_pow_matches_jax_and_golden(e):
    a = gl_values(20, 64)
    got = tgf.to_u64(tgf.gl_pow(torch_gl(a), e))
    np.testing.assert_array_equal(got, jgf.to_u64(jgf.gl_pow(jax_gl(a), e)))
    assert [int(x) for x in got] == [pow(int(x), e, P) for x in a]


@pytest.mark.parametrize("k", [0, 1, 5, 16, 31])
def test_gl_mul_pow2_matches_jax_and_golden(k):
    a = gl_values(21, 200)
    got = tgf.to_u64(tgf.gl_mul_pow2(torch_gl(a), k))
    np.testing.assert_array_equal(got, jgf.to_u64(jgf.gl_mul_pow2(jax_gl(a), k)))
    assert [int(x) for x in got] == [int(x) * (1 << k) % P for x in a]


def test_gl_select_and_eq_match_jax():
    a, b = gl_values(22, 100), gl_values(23, 100)
    b[::3] = a[::3]
    mask = np.random.default_rng(24).integers(0, 2, size=100).astype(bool)
    eq = tgf.gl_eq(torch_gl(a), torch_gl(b)).numpy()
    np.testing.assert_array_equal(eq, np.asarray(jgf.gl_eq(jax_gl(a), jax_gl(b))))
    np.testing.assert_array_equal(eq, a == b)
    got = tgf.to_u64(tgf.gl_select(torch.from_numpy(mask), torch_gl(a), torch_gl(b)))
    np.testing.assert_array_equal(got, jgf.to_u64(jgf.gl_select(mask, jax_gl(a), jax_gl(b))))
    np.testing.assert_array_equal(got, np.where(mask, a, b))


EXT_K = (0x123456789ABCDEF, P - 3)


@pytest.mark.parametrize("op", ["ext_neg", "ext_scale", "ext_scale_ext", "ext_select", "ext_zeros"])
def test_ext_helpers_match_jax(op):
    a, b = _ext(25, 60), _ext(26, 60)
    ta, ja = (torch_gl(a[0]), torch_gl(a[1])), (jax_gl(a[0]), jax_gl(a[1]))
    tb, jb = (torch_gl(b[0]), torch_gl(b[1])), (jax_gl(b[0]), jax_gl(b[1]))
    mask = np.random.default_rng(27).integers(0, 2, size=60).astype(bool)
    got, want = {
        "ext_neg": lambda: (tgf.ext_neg(ta), jgf.ext_neg(ja)),
        "ext_scale": lambda: (tgf.ext_scale(ta[0], EXT_K), jgf.ext_scale(ja[0], EXT_K)),
        "ext_scale_ext": lambda: (tgf.ext_scale_ext(ta, EXT_K), jgf.ext_scale_ext(ja, EXT_K)),
        "ext_select": lambda: (tgf.ext_select(torch.from_numpy(mask), ta, tb), jgf.ext_select(mask, ja, jb)),
        "ext_zeros": lambda: (tgf.ext_zeros((3, 4)), jgf.ext_zeros((3, 4))),
    }[op]()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tgf.to_u64(g), jgf.to_u64(w))
    if op == "ext_scale_ext":
        gold_out = [gold.ext_mul((int(x), int(y)), EXT_K) for x, y in zip(*a)]
        assert list(zip(map(int, tgf.to_u64(got[0])), map(int, tgf.to_u64(got[1])))) == gold_out
