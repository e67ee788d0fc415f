"""The two launches of the port's four-step NTT on the CPU, exact equality:
their plain versions (four_step_first_plain: steps A and B of the JAX
package's ntt_four_step; four_step_last_plain: step C; the inverse's
n2^-1 of step C moved into the first, C being linear) against the JAX
package, the route four_step_plan picks, the first launch's twiddle tables
and the u64 intermediate's layout, and the two CUDA kernels' own source
(csrc/ntt.cu) run on a host model against the plain versions.

The JAX package's steps run under jax.jit at log n 3 (n1 = 2, n2 = 4),
both ways: each jitted program costs this machine 1.5-3 s to trace and
compile (62.8 s for log n 1-12 both ways), so log n 1-12 are held to the
JAX package's golden model (pure Python column NTTs and its twiddle matrix)
instead. The file's tests take under 10 s together."""

import shutil
import subprocess
from functools import partial

import jax
import numpy as np
import pytest
import torch

from blobstreamx_tpu.fields import gf64 as jgf
from blobstreamx_tpu.golden import ntt as jgold_ntt
from blobstreamx_tpu.ops import ntt as jntt
from blobstreamx_tpu_torch import kernels
from blobstreamx_tpu_torch.fields import gf64 as tgf
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.ops import ntt as tntt

torch.set_num_threads(1)
P = gold.P


def gl_matrix(seed: int, shape) -> np.ndarray:
    """Canonical values with the edges near 0, 2^32 and p first."""
    v = np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)
    edges = np.array([0, 1, P - 1, (1 << 32) - 1, 1 << 32, P - (1 << 32)], np.uint64)
    flat = v.reshape(-1)
    flat[: min(len(edges), flat.size)] = edges[: flat.size]
    return v


def golden_steps(mat: np.ndarray, log_n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """Steps A+B and C of ntt_four_step from the JAX package's golden column
    NTTs and its twiddle matrix: (n2, n1) after B, and after C."""
    col_ntt = jgold_ntt.intt if inverse else jgold_ntt.ntt
    tw = jntt._four_step_twiddles(log_n, inverse)
    a = np.array([col_ntt([int(v) for v in mat[:, i2]]) for i2 in range(mat.shape[1])], dtype=object)
    b = a * tw.T.astype(object) % P
    c = np.array([col_ntt(list(b[:, k1])) for k1 in range(b.shape[1])], dtype=object).T
    return b.astype(np.uint64), c.astype(np.uint64)


@partial(jax.jit, static_argnums=(1, 2))
def _jax_steps_ab(mat, inverse: bool, log_n: int):
    m = jntt.ntt_cols(mat, inverse)
    m = jgf.gl_mul(m, jgf.from_u64(jntt._four_step_twiddles(log_n, inverse)))
    return m[0].T, m[1].T


_jax_step_c = jax.jit(jntt.ntt_cols, static_argnums=1)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", range(1, 13))
def test_plain_passes_match_the_jax_packages_steps(log_n, inverse):
    n1, n2 = tntt.four_step_shape(log_n)
    mat = gl_matrix(log_n, (n1, n2))
    want_b, want_c = golden_steps(mat, log_n, inverse)
    # the inverse's n2^-1 rides on the first pass
    scale = pow(n2, P - 2, P) if inverse else 1
    got_b = tntt.four_step_first_plain(tgf.from_u64(mat), log_n, inverse)
    np.testing.assert_array_equal(tgf.to_u64(got_b), (want_b.astype(object) * scale % P).astype(np.uint64))
    got_c = tntt.four_step_last_plain(got_b, log_n, inverse)
    np.testing.assert_array_equal(tgf.to_u64(got_c), want_c)
    if log_n == 3:
        jax_b = jgf.to_u64(_jax_steps_ab(jgf.from_u64(mat), inverse, log_n))
        np.testing.assert_array_equal(jax_b, want_b)
        np.testing.assert_array_equal(tgf.to_u64(got_c), jgf.to_u64(_jax_step_c(jgf.from_u64(jax_b), inverse)))
    flat = tntt.ntt_four_step_plain(tgf.from_u64(mat.reshape(-1)), inverse)
    np.testing.assert_array_equal(tgf.to_u64(flat), want_c.reshape(-1))


def test_plan_takes_two_launches_up_to_2_28():
    assert [tntt.four_step_plan(k) for k in range(29)] == ["two_launch"] * 29
    assert [tntt.four_step_plan(k) for k in range(29, 33)] == ["long_columns"] * 4
    with pytest.raises(ValueError):
        tntt.four_step_plan(-1)
    # the plan's limit is the tile kernel's largest column in csrc/ntt.cu
    src = (kernels.CSRC / "ntt.cu").read_text()
    assert f"#define NTT_SMEM_MAX_N (1 << {tntt.TILE_MAX_LOG_N})" in src
    assert all(n <= 1 << tntt.TILE_MAX_LOG_N for n in tntt.four_step_shape(28))
    assert max(tntt.four_step_shape(29)) > 1 << tntt.TILE_MAX_LOG_N


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [0, 1, 2, 5, 12, 13])
def test_twiddle_tables(log_n, inverse):
    """high[e >> h] * low[e mod 2^h] is W[k1, i2] (times n^-1 for the
    inverse) for every e = k1*i2 of the (n1, n2) matrix."""
    high, low = tntt.four_step_twiddle_tables(log_n, inverse)
    h = (log_n + 1) // 2
    assert high.shape == (1 << (log_n - h),) and low.shape == (1 << h,)
    n1, n2 = tntt.four_step_shape(log_n)
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    i2 = np.arange(n2, dtype=np.int64)[None, :]
    e = k1 * i2
    got = tgf.gl_mul(tgf.from_u64(high[e >> h]), tgf.from_u64(low[e & ((1 << h) - 1)]))
    want = tgf.from_u64(tntt.four_step_twiddles(log_n, inverse))
    if inverse:
        want = tgf.gl_mul(want, tgf.full((), gold.inv(n1 * n2)))
    np.testing.assert_array_equal(tgf.to_u64(got), tgf.to_u64(want))


def test_intermediate_layout():
    """The first launch's intermediate is the (n2, n1) matrix as one u64 an
    element, rows in bit-reversed order."""
    m = tgf.from_u64(gl_matrix(5, (8, 4)))
    buf = tntt.scratch_from_gl(m)
    words = tgf.to_u64(m)
    assert buf.dtype == torch.int64 and tuple(buf.shape) == (8, 4)
    for r in range(8):
        np.testing.assert_array_equal(buf[r].numpy().view(np.uint64), words[int(tntt.bitrev_indices(3)[r])])
    back = tntt.gl_from_scratch(buf)
    assert torch.equal(back[0], m[0]) and torch.equal(back[1], m[1])


# ----------------------------------------------------------------------------
# the kernels' source on a host model
# ----------------------------------------------------------------------------

# CUDA's names as one thread a block runs them on the host: a block's thread
# walks every butterfly group of a pass (ntt_pass's loop), so the barriers
# have nothing to order. The field operations keep gl64.cuh's contracts on
# u64 words (gl_add_nc's and gl_sub's results only congruent, their second
# operand below p) and abort where an operand breaks them; their PTX is
# checked on its own (tests/test_torch_ntt_multi.py, and gl_add_nc below).
HOST_CUDA = """#pragma once
#include <stdint.h>
#include <stddef.h>
#include <algorithm>
#define __global__
#define __device__
#define __host__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
extern Dim3 threadIdx, blockIdx, blockDim;
inline void __syncthreads() {}
template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __brev(unsigned x) {
  unsigned r = 0;
  for (int i = 0; i < 32; i++) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
using std::min;
"""
HOST_GL64 = """#pragma once
#include <stdint.h>
#include <stdlib.h>
#define GL_P 0xFFFFFFFF00000001ULL
#define GL_EPS 0xFFFFFFFFULL
typedef unsigned __int128 u128;
static void need(bool ok) { if (!ok) abort(); }
// canonical operands only
inline uint64_t gl_add(uint64_t a, uint64_t b) { need(a < GL_P && b < GL_P); return (uint64_t)(((u128)a + b) % GL_P); }
// any a, b < p: the sum, plus EPS on a carry, which must not carry again
inline uint64_t gl_add_nc(uint64_t a, uint64_t b) {
  need(b < GL_P);
  uint64_t s = a + b;
  if (s < a) { need(s + GL_EPS >= s); s += GL_EPS; }
  return s;
}
// any a, b < p: the difference, minus EPS on a borrow, which must not borrow again
inline uint64_t gl_sub(uint64_t a, uint64_t b) {
  need(b < GL_P);
  uint64_t d = a - b;
  if (a < b) { need(d >= GL_EPS); d -= GL_EPS; }
  return d;
}
inline uint64_t gl_mul(uint64_t a, uint64_t b) { return (uint64_t)(((u128)a * b) % GL_P); }
// any u64 congruent to the product: here the canonical one plus p where that stays below 2^64
inline uint64_t gl_mul_nc(uint64_t a, uint64_t b) { uint64_t r = gl_mul(a, b); return r < GL_EPS ? r + GL_P : r; }
inline uint64_t gl_canonical(uint64_t x) { return x >= GL_P ? x - GL_P : x; }
inline uint64_t gl_join(int64_t lo, int64_t hi) { return ((uint64_t)hi << 32) | ((uint64_t)lo & GL_EPS); }
"""
# stdin: log_n1 log_n2, then the u64 words of the input (n),
# tw1 (max(n1/2, 1)), tw2 (max(n2/2, 1)), high, low; stdout: the
# intermediate (n), then the output (n)
HOST_MAIN = """#include "ntt_kernels.cu"
#include <stdio.h>
#include <vector>
Dim3 threadIdx, blockIdx, blockDim;
uint64_t ntt_smem[1 << 16];
static std::vector<uint64_t> words(size_t n) {
  std::vector<uint64_t> v(n);
  if (fread(v.data(), 8, n, stdin) != n) throw 1;
  return v;
}
static int tile_cols(int c) { int l = 0; while ((2 << l) <= NTT_TILE_COLS && (2 << l) <= c) l++; return l; }
int main() {
  int l1, l2;
  if (scanf("%d %d\\n", &l1, &l2) != 2) return 1;
  const size_t n1 = (size_t)1 << l1, n2 = (size_t)1 << l2, n = n1 * n2, h = (l1 + l2 + 1) / 2;
  auto x = words(n), tw1 = words(std::max<size_t>(n1 / 2, 1)), tw2 = words(std::max<size_t>(n2 / 2, 1));
  auto high = words(n >> h), low = words((size_t)1 << h);
  std::vector<int64_t> lo(n), hi(n), out_lo(n), out_hi(n);
  for (size_t i = 0; i < n; i++) { lo[i] = x[i] & GL_EPS; hi[i] = x[i] >> 32; }
  std::vector<uint64_t> buf(n), out(n);
  blockDim.x = 1;
  int ct = tile_cols((int)n2);
  for (blockIdx.x = 0; blockIdx.x < (n2 >> ct); blockIdx.x++)
    four_step_first_kernel<-1, -1>(lo.data(), hi.data(), buf.data(), tw1.data(), high.data(), low.data(), l1, l2, ct);
  ct = tile_cols((int)n1);
  for (blockIdx.x = 0; blockIdx.x < (n1 >> ct); blockIdx.x++)
    four_step_last_kernel<-1, -1>(buf.data(), out_lo.data(), out_hi.data(), tw2.data(), l1, l2, ct);
  for (size_t i = 0; i < n; i++) out[i] = ((uint64_t)out_hi[i] << 32) | (uint64_t)out_lo[i];
  fwrite(buf.data(), 8, n, stdout);
  fwrite(out.data(), 8, n, stdout);
  return 0;
}
"""


def _drop_functions(src: str, head: str) -> str:
    """src without every function whose text starts with `head` (its body
    found by matching braces)."""
    while (i := src.find(head)) >= 0:
        depth, k = 0, src.index("{", i)
        while True:
            depth += {"{": 1, "}": -1}.get(src[k], 0)
            if depth == 0:
                break
            k += 1
        src = src[:i] + src[k + 1:]
    return src


@pytest.fixture(scope="module")
def host_model(tmp_path_factory):
    """csrc/ntt.cu's kernels compiled for the host (the C entry points and
    the launch helpers taken out), driven by HOST_MAIN."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the host model of the kernels")
    d = tmp_path_factory.mktemp("ntt_host")
    src = (kernels.CSRC / "ntt.cu").read_text()
    src = _drop_functions(_drop_functions(src, 'extern "C"'), "static cudaError_t ")
    (d / "ntt_kernels.cu").write_text(src)
    (d / "cuda_runtime.h").write_text(HOST_CUDA)
    (d / "gl64.cuh").write_text(HOST_GL64)
    (d / "main.cpp").write_text(HOST_MAIN)
    built = subprocess.run([gxx, "-O0", "-std=c++17", "-I", str(d), "-o", str(d / "model"), str(d / "main.cpp")],
                           capture_output=True, text=True)
    assert built.returncode == 0, built.stderr
    return d / "model"


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [0, 1, 2, 3, 4, 5, 7, 8, 11, 12, 15])
def test_kernels_on_a_host_model(host_model, log_n, inverse):
    """four_step_first_kernel's intermediate and four_step_last_kernel's
    output, from their source, against four_step_first_plain and the whole
    plain four-step (which the JAX package's steps hold above)."""
    n1, n2 = tntt.four_step_shape(log_n)
    l1, l2 = n1.bit_length() - 1, n2.bit_length() - 1
    # half the elements from the edges (sums of two of them land in [p, 2^64), so
    # the lazy sums' contracts are exercised), the rest random
    rng = np.random.default_rng(300 + log_n)
    x = gl_matrix(300 + log_n, (1 << log_n,))
    edges = np.array([0, 1, 2, (1 << 32) - 1, 1 << 32, P - 1, P - 2, P - (1 << 32), 1 << 63], np.uint64)
    pick = rng.random(x.size) < 0.5
    x[pick] = edges[rng.integers(0, edges.size, size=int(pick.sum()))]
    high, low = tntt.four_step_twiddle_tables(log_n, inverse)
    data = b"".join(a.tobytes() for a in (x, tntt.power_table(l1, inverse), tntt.power_table(l2, inverse), high, low))
    run = subprocess.run([str(host_model)], input=f"{l1} {l2}\n".encode() + data,
                         capture_output=True)
    assert run.returncode == 0, "the host model aborted: an operand broke a field operation's contract"
    words = np.frombuffer(run.stdout, dtype=np.uint64)
    buf, out = words[: x.size].reshape(n2, n1), words[x.size:]
    first = tntt.four_step_first_plain(tgf.from_u64(x.reshape(n1, n2)), log_n, inverse)
    np.testing.assert_array_equal(tgf.to_u64(tntt.gl_from_scratch(torch.from_numpy(buf.view(np.int64).copy()))),
                                  tgf.to_u64(first))
    np.testing.assert_array_equal(out, tgf.to_u64(tntt.ntt_four_step_plain(tgf.from_u64(x), inverse)))


def test_gl_add_nc_ptx():
    """gl64.cuh's gl_add_nc (the four-step kernels' butterfly sum) on the
    PTX model: congruent to a + b, for any u64 a and canonical b, and no
    instruction without .cc carries out."""
    from test_torch_ntt_multi import run_ptx, u64_values

    vals = u64_values(19, 40)
    for a in vals:
        for b in [v % P for v in vals[::3]]:
            r = run_ptx("gl_add_nc", a, b)
            assert r < 1 << 64 and r % P == (a + b) % P, (a, b)
            assert run_ptx("gl_sub", a, b) % P == (a - b) % P, (a, b)
