"""The long-column NTT's pass schedule (csrc/ntt.cu, columns longer than
NTT_SMEM_MAX_N) on the CPU, where the CUDA kernel cannot run: a numpy model
of the kernel's index arithmetic, with the design constants read from
ntt.cu, held to the JAX package's jitted ntt_cols and to the port's
ntt_cols_plain with exact equality.

The model follows bsx_ntt_cols: the plan (the column tile, the passes and
their stages), then per pass every block's tile of 2^L positions x CT
columns (the rows high | t << s0 | low, the position tiles of the first
pass in bit-reversed order), its radix passes (ntt_stages and ntt_pass:
radix 8 but the last one or two radix 4; groups, k, base, the positions
base + j << st), the fused bit-reversed read of the first pass, each
stage's twiddle exponent (ntt_radix, in the whole column's stage and
position) and the n^-1 of the inverse at the last write. Field arithmetic
is the port's plain gf64 (held to the JAX package elsewhere); gl64.cuh's
PTX, which the kernel computes with, is run on a model of its instructions
at the end of this file."""

import re
from functools import lru_cache
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from blobstreamx_tpu.fields import gf64 as jgf
from blobstreamx_tpu.ops import ntt as jntt
from blobstreamx_tpu_torch.fields import gf64 as tgf
from blobstreamx_tpu_torch.fields.gf64 import gl_add, gl_mul, gl_sub
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.ops import ntt as tntt

torch.set_num_threads(1)
P = gold.P
SMEM, LOHI, U64 = "smem", "lohi", "u64"
COLS = (1, 3, 5)
LOG_NS = (15, 16, 17)  # odd and even splits: 8 + 7, 8 + 8, 9 + 8


def _constants() -> dict:
    src = (Path(tntt.__file__).resolve().parent.parent / "csrc" / "ntt.cu").read_text()
    consts = {}
    for name in ("NTT_SMEM_MAX_N", "NTT_LONG_THREADS", "NTT_LONG_COLS", "NTT_LONG_SMEM", "NTT_MAX_PASSES"):
        expr = re.search(rf"#define {name} (.+)", src).group(1).strip()
        assert re.fullmatch(r"[\d\s()*<]+", expr), expr
        consts[name] = eval(expr)  # an integer expression of the source's #define
    assert "return i + (i >> 3);" in src  # ntt_pad: one padding row after every 8
    return consts


K = _constants()


def pad(i):
    return i + (i >> 3)


def tile_smem(log_t: int, log_ct: int) -> int:
    """ntt_tile_smem: the tile's shared memory (none for a single radix pass)."""
    return (pad(1 << log_t) << log_ct) * 8 if log_t > 3 else 0


def plan(log_n: int, c: int, smem_limit: int = K["NTT_LONG_SMEM"]) -> tuple[int, list[int]]:
    """ntt_long_plan: (log2 of the column tile, the stages of each pass)."""
    log_ct = 0
    while (2 << log_ct) <= K["NTT_LONG_COLS"] and (2 << log_ct) <= c:
        log_ct += 1
    max_tile = 3
    while tile_smem(max_tile + 1, log_ct) <= smem_limit:
        max_tile += 1
    passes = -(-log_n // max_tile)
    assert passes <= K["NTT_MAX_PASSES"]
    return log_ct, [log_n // passes + (1 if p < log_n % passes else 0) for p in range(passes)]


def radixes(log_t: int) -> list[int]:
    """ntt_stages: the stages of each radix pass of a tile of 2^log_t
    positions (more than 3), radix 8 but the last one or two radix 4."""
    passes = (log_t + 2) // 3
    radix8 = log_t - 2 * passes
    return [3] * radix8 + [2] * (passes - radix8)


def bitrev(i: np.ndarray, log_n: int) -> np.ndarray:
    out = np.zeros_like(i)
    for b in range(log_n):
        out |= ((i >> b) & 1) << (log_n - 1 - b)
    return out


def radix_pass(state, R, st, src, dst, blk):
    """ntt_pass<R, src, dst, SPLIT = true> for every block of one pass at once."""
    log_n, c, log_ct, s0, log_t = blk["log_n"], blk["c"], blk["log_ct"], blk["s0"], blk["log_t"]
    ct = 1 << log_ct
    g = np.arange(ct << (log_t - R))
    b_idx, g = np.repeat(np.arange(blk["blocks"]), g.size), np.tile(g, blk["blocks"])
    col = g & (ct - 1)
    keep = col < blk["cw"][b_idx]
    b_idx, g, col = b_idx[keep], g[keep], col[keep]
    gi = g >> log_ct
    k = gi & ((1 << st) - 1)
    base = ((gi >> st) << (st + R)) | k
    low, high, gcol = blk["low"][b_idx], blk["high"][b_idx], blk["col0"][b_idx] + col
    pos = [base + (j << st) for j in range(1 << R)]
    rows = [high | (i << s0) | low for i in pos]
    slots = [torch.from_numpy((b_idx * pad(1 << log_t) + pad(i)) * ct + col) for i in pos]

    def load(j):
        if src == LOHI:
            return tuple(t[torch.from_numpy(bitrev(rows[j], log_n) * c + gcol)] for t in state["x"])
        if src == U64:
            return tuple(t[torch.from_numpy(rows[j] * c + gcol)] for t in state["buf"])
        return tuple(t[slots[j]] for t in state["smem"])

    v = [load(j) for j in range(1 << R)]
    st_g, k_g, first = s0 + st, (k << s0) | low, src == LOHI
    for q in range(R):
        h = 1 << q
        w = [tgf.from_u64(state["tw"][(k_g + (m << st_g)) << (log_n - 1 - st_g - q)], "cpu") for m in range(h)]
        for j in range(1 << R):
            if j & h:
                continue
            m = j & (h - 1)
            u = v[j + h] if first and m == 0 else gl_mul(v[j + h], w[m])
            v[j], v[j + h] = gl_add(v[j], u), gl_sub(v[j], u)
    for j in range(1 << R):
        if dst == LOHI:
            idx = torch.from_numpy(rows[j] * c + gcol)
            val = gl_mul(v[j], tgf.full((), state["n_inv"], "cpu")) if state["inverse"] else v[j]
            state["writes"] += np.bincount(rows[j] * c + gcol, minlength=state["writes"].size)
            target = state["out"]
        elif dst == U64:
            idx, val, target = torch.from_numpy(rows[j] * c + gcol), v[j], state["buf"]
        else:
            idx, val, target = slots[j], v[j], state["smem"]
        for t, x in zip(target, val):
            t[idx] = x


def long_ntt_model(x: np.ndarray, inverse: bool, smem_limit: int = K["NTT_LONG_SMEM"]) -> np.ndarray:
    """bsx_ntt_cols's long-column path on an (n, c) uint64 matrix."""
    n, c = x.shape
    log_n = n.bit_length() - 1
    assert n > K["NTT_SMEM_MAX_N"]
    log_ct, stages = plan(log_n, c, smem_limit)
    ct, tiles_c = 1 << log_ct, -(-c // (1 << log_ct))
    flat = tuple(t.reshape(-1) for t in tgf.from_u64(x, "cpu"))
    state = dict(x=flat, buf=tuple(torch.zeros(n * c, dtype=torch.int64) for _ in range(2)),
                 out=tuple(torch.zeros(n * c, dtype=torch.int64) for _ in range(2)),
                 tw=tntt.power_table(log_n, inverse), inverse=inverse, n_inv=gold.inv(n % P),
                 writes=np.zeros(n * c, dtype=np.int64))
    s0 = 0
    for p, log_t in enumerate(stages):
        src = LOHI if p == 0 else U64
        dst = LOHI if p == len(stages) - 1 else U64
        blocks = tiles_c << (log_n - log_t)
        bi = np.arange(blocks)
        b = bi // tiles_c
        if src == LOHI:
            b = bitrev(b, log_n - log_t)  # ntt_long_pass: blocks running together read neighbouring rows
        col0 = (bi % tiles_c) << log_ct
        blk = dict(log_n=log_n, c=c, log_ct=log_ct, s0=s0, log_t=log_t, blocks=blocks, col0=col0,
                   cw=np.minimum(ct, c - col0), low=b & ((1 << s0) - 1), high=(b >> s0) << (s0 + log_t))
        threads = min(K["NTT_LONG_THREADS"], -(-(ct << (log_t - 3)) // 32) * 32)
        assert threads % 32 == 0 and blocks < 1 << 31
        state["smem"] = tuple(torch.zeros(blocks * pad(1 << log_t) * ct, dtype=torch.int64) for _ in range(2))
        st = 0
        for i, r in enumerate(radixes(log_t)):
            radix_pass(state, r, st, src if i == 0 else SMEM, SMEM if st + r < log_t else dst, blk)
            st += r
        s0 += log_t
    assert s0 == log_n
    assert (state["writes"] == 1).all()  # the last pass writes every element once
    return tgf.to_u64(tuple(t.reshape(n, c) for t in state["out"]))


def gl_input(log_n: int, c: int) -> np.ndarray:
    rng = np.random.default_rng(100 * log_n + c)
    v = rng.integers(0, P, size=(1 << log_n, c), dtype=np.uint64)
    edges = np.array([0, 1, P - 1, P - 2, (1 << 32) - 1, 1 << 32, P - (1 << 32), 1 << 63], np.uint64)
    v.reshape(-1)[: edges.size] = edges
    return v


@lru_cache(maxsize=None)
def jax_references() -> dict:
    """{(log_n, inverse): the JAX package's jitted ntt_cols of
    gl_input(log_n, max(COLS))} for every log_n of LOG_NS, from one compile:
    every input zero-padded to the longest n, side by side, transformed
    forward. With m = n / 2^s, the length-n transform of a zero-padded
    length-m column holds the length-m one at rows 2^s k, since
    w_n^(2^s) = w_m; and the inverse is m^-1 NTT(x)[(m - k) mod m]. The LLVM
    backend's expensive passes are off and the code is generated in one
    split, which changes compile time only."""
    n = 1 << max(LOG_NS)
    cols = max(COLS)
    x = np.zeros((n, cols * len(LOG_NS)), dtype=np.uint64)
    for i, log_n in enumerate(LOG_NS):
        x[: 1 << log_n, i * cols:(i + 1) * cols] = gl_input(log_n, cols)
    jx = jgf.from_u64(x)
    compiled = jax.jit(jntt.ntt_cols, static_argnums=1).lower(jx, False).compile(
        compiler_options={"xla_llvm_disable_expensive_passes": True, "xla_cpu_parallel_codegen_split_count": 1})
    y = jgf.to_u64(compiled(jx))
    out = {}
    for i, log_n in enumerate(LOG_NS):
        m = 1 << log_n
        fwd = np.ascontiguousarray(y[:: n // m, i * cols:(i + 1) * cols])
        out[log_n, False] = fwd
        rev = fwd[(-np.arange(m)) % m]
        out[log_n, True] = tgf.to_u64(gl_mul(tgf.from_u64(rev, "cpu"), tgf.full((), gold.inv(m), "cpu")))
    return out


@lru_cache(maxsize=None)
def plain_reference(log_n: int, inverse: bool) -> np.ndarray:
    """The port's ntt_cols_plain of gl_input(log_n, max(COLS)); a narrower
    case takes its first columns (the columns are independent transforms)."""
    return tgf.to_u64(tntt.ntt_cols_plain(tgf.from_u64(gl_input(log_n, max(COLS)), "cpu"), inverse))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", COLS)
@pytest.mark.parametrize("log_n", LOG_NS)
def test_long_ntt_model_matches_jax_and_plain(log_n, c, inverse):
    got = long_ntt_model(gl_input(log_n, max(COLS))[:, :c].copy(), inverse)
    np.testing.assert_array_equal(got, plain_reference(log_n, inverse)[:, :c])
    np.testing.assert_array_equal(got, jax_references()[log_n, inverse][:, :c])


@pytest.mark.parametrize("log_n, c, inverse, passes", [(15, 3, True, 3), (16, 4, False, 4)])
def test_long_ntt_model_three_and_four_passes(log_n, c, inverse, passes):
    """The middle passes (u64 in and out, in place), with the shared-memory
    limit cut to 2 KB so that short columns need them."""
    assert len(plan(log_n, c, smem_limit=2048)[1]) == passes
    x = gl_input(log_n, c)
    plain = tgf.to_u64(tntt.ntt_cols_plain(tgf.from_u64(x, "cpu"), inverse))
    np.testing.assert_array_equal(long_ntt_model(x, inverse, smem_limit=2048), plain)


def test_long_ntt_plan():
    """Two passes (ceil and floor of log n / 2 stages) from 2^15 to 2^22 at
    every column count, three above; two blocks' tiles fit an SM."""
    assert plan(21, 32) == (2, [11, 10])
    assert plan(18, 32) == (2, [9, 9])
    assert plan(17, 5) == (2, [9, 8])
    assert plan(15, 1) == (0, [8, 7])
    assert plan(23, 4) == (2, [8, 8, 7])
    assert [radixes(t) for t in (4, 7, 8, 10, 11, 13)] == [[2, 2], [3, 2, 2], [3, 3, 2], [3, 3, 2, 2], [3, 3, 3, 2],
                                                          [3, 3, 3, 2, 2]]
    for log_n in range(15, 23):
        for c in (1, 2, 3, 4, 5, 20, 32):
            log_ct, stages = plan(log_n, c)
            assert stages == [(log_n + 1) // 2, log_n // 2]
            assert 2 * (max(tile_smem(s, log_ct) for s in stages) + 1024) <= 228 * 1024
    assert len(plan(23, 32)[1]) == 3 and len(plan(24, 32)[1]) == 3


# ----------------------------------------------------------------------------
# gl64.cuh's PTX, run instruction by instruction on the CPU
# ----------------------------------------------------------------------------

GL64 = (Path(tntt.__file__).resolve().parent.parent / "csrc" / "gl64.cuh").read_text()
M32 = (1 << 32) - 1


def ptx_block(fn: str) -> list[str]:
    """The instructions of the asm block inside `uint64_t <fn>(...)`."""
    body = GL64[GL64.index(f" {fn}(") :]
    text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', re.search(r"asm\((.*?)\n\s*:", body, re.S).group(1)))
    ins = [re.sub(r"^\{\s", "", i.strip()).strip() for i in text.replace("\\n", "\n").replace("\\t", "").split(";")]
    return [i for i in ins if i and i != "}" and not i.startswith(".reg")]


def run_ptx(fn: str, *operands: int) -> int:
    """One of gl64.cuh's asm blocks on u64 operands %1, %2, returning %0: a
    model of the PTX (32-bit registers, the carry flag a carry for add and
    mad, a borrow for sub). Raises if an instruction without .cc carries or
    borrows out of 32 bits (subc's 0 - 0 - borrow mask aside), or if a
    carry-in instruction reads a flag that the other family set: on the
    card a subtraction's flag is "no borrow", which this model does not
    follow."""
    regs = {f"%{i + 1}": v for i, v in enumerate(operands)}
    cf, pred = 0, {}
    cf_from = None  # the family that set the flag: ptxas reads a subtraction's flag as "no borrow"

    def val(x):
        return regs[x] if x in regs else int(x, 0)

    for ins in ptx_block(fn):
        m = re.fullmatch(r"mov\.b64 \{(\w+), (\w+)\}, (%?\w+)", ins)
        if m:
            regs[m.group(1)], regs[m.group(2)] = val(m.group(3)) & M32, val(m.group(3)) >> 32
            continue
        m = re.fullmatch(r"mov\.b64 (%?\w+), \{(\w+), (\w+)\}", ins)
        if m:
            regs[m.group(1)] = val(m.group(2)) | val(m.group(3)) << 32
            continue
        op, rest = ins.split(None, 1)
        args = [a.strip() for a in rest.split(",")]
        parts, d = op.split("."), args[0]
        base, cc = parts[0], "cc" in parts
        if base == "selp":
            regs[d] = val(args[1]) if pred[args[3]] else val(args[2])
            continue
        src = [val(a) for a in args[1:]]
        if base == "setp":
            assert parts[1] == "ne"
            pred[d] = src[0] != src[1]
            continue
        if base == "mul" and "wide" in parts:
            regs[d] = src[0] * src[1]
            continue
        if base == "neg":
            regs[d] = -src[0] & M32
            continue
        if base in ("mul", "mad", "madc"):
            prod = src[0] * src[1]
            s = (prod >> 32 if "hi" in parts else prod & M32) + (src[2] if base != "mul" else 0)
            s += cf if base == "madc" else 0
        elif base in ("add", "addc"):
            s = src[0] + src[1] + (cf if base == "addc" else 0)
        elif base in ("sub", "subc"):
            s = src[0] - src[1] - (cf if base == "subc" else 0)
        else:
            raise ValueError(f"instruction not modelled: {ins}")
        family = "sub" if base in ("sub", "subc") else "add"
        if base in ("addc", "madc", "subc"):
            assert cf_from == family, f"{ins} reads a flag set by {cf_from} (the card differs from this model there)"
        if cc:
            cf = int(s < 0) if base in ("sub", "subc") else int(s > M32)
            cf_from = family
        elif not (base == "subc" and args[1:] == ["0", "0"]):
            assert 0 <= s <= M32, f"{ins} carries out of 32 bits ({s:#x})"
        regs[d] = s & M32
    return regs["%0"]


def u64_values(seed: int, n: int) -> list[int]:
    """Edges (0, 1, p - 1, p, 2^64 - 1, around 2^32, EPS multiples) and random u64."""
    eps = (1 << 32) - 1
    edges = [0, 1, 2, P - 1, P, P + 1, (1 << 64) - 1, (1 << 64) - 2, eps, eps + 1, eps + 2, 1 << 63,
             (1 << 63) - 1, eps << 32, P - eps, 2 * eps]
    rng = np.random.default_rng(seed)
    return edges + [int(v) for v in rng.integers(0, 1 << 64, size=n, dtype=np.uint64)]


def test_gl64_ptx_mul_is_canonical_product():
    """gl_mul (the NTT kernels' multiply) on any u64 operands: a * b mod p,
    in [0, p); and gl_reduce128_nc's reduction: congruent, below 2^64."""
    vals = u64_values(17, 40)
    for a in vals:
        for b in vals[::3]:
            got = run_ptx("gl_mul", a, b)
            assert got == a * b % P, (a, b)
            r = run_ptx("gl_reduce128_nc", a, b)
            assert r < 1 << 64 and r % P == (a + (b << 64)) % P, (a, b)


def test_gl64_ptx_add_sub_on_canonical_values():
    vals = [v % P for v in u64_values(18, 40)]
    for a in vals:
        for b in vals[::3]:
            assert run_ptx("gl_add", a, b) == (a + b) % P, (a, b)
            assert run_ptx("gl_sub", a, b) == (a - b) % P, (a, b)
