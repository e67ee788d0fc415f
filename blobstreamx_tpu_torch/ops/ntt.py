"""Radix-2 Goldilocks NTT / LDE over (n, C) column batches.

Polynomials live column-wise: a batch is a Gl pair of shape ``(n, C)`` —
coefficient index on axis 0, one polynomial per column. ``ntt_cols`` is the
entry point: on a CUDA tensor it launches the NTT kernel (csrc/ntt.cu), on a
CPU tensor it runs ``ntt_cols_plain``, the DIT butterfly stages written as
reshapes over the whole array (the JAX package's ``_apply_stages``). Both
are natural order in and out and bit-identical.

``ntt_four_step`` transforms one long vector as an (n1, n2) matrix: column
NTTs of length n1 (step A), the twiddle multiply and the transpose (B),
column NTTs of length n2 (C). ``four_step_plan`` picks its route from the
length alone. Up to 2^28 (n1 and n2 at most the tile kernel's 2^14) it is
two launches (``four_step_first``: A and B, into a u64 intermediate of the
(n2, n1) matrix with its rows bit-reversed, and the inverse's whole n^-1;
``four_step_last``: C), 48 B an element moved. Above, it is the column NTT's long-column passes around
``twiddle_transpose``. On CPU tensors both routes are ``ntt_four_step_plain``.

Golden oracle: blobstreamx_tpu_torch.golden.ntt.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from blobstreamx_tpu_torch import kernels
from blobstreamx_tpu_torch.device import on_cuda
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl, gl_add, gl_mul, gl_sub
from blobstreamx_tpu_torch.golden import goldilocks as gold

P = gold.P


# ----------------------------------------------------------------------------
# host-side tables (cached per size, and per device once uploaded)
# ----------------------------------------------------------------------------


@lru_cache(maxsize=None)
def power_table(log_n: int, inverse: bool = False) -> np.ndarray:
    """np.uint64 table [w^0, w^1, ..., w^(n/2 - 1)] for w = root_of_unity(log_n)."""
    n = 1 << log_n
    w = gold.root_of_unity(log_n)
    if inverse:
        w = gold.inv(w)
    out = np.empty(max(n // 2, 1), dtype=np.uint64)
    cur = 1
    for i in range(out.shape[0]):
        out[i] = cur
        cur = (cur * w) % P
    return out


@lru_cache(maxsize=None)
def shift_table(log_n: int, shift: int, inverse: bool = False) -> np.ndarray:
    """np.uint64 table [s^0 .. s^(n-1)] (s^-i for inverse)."""
    n = 1 << log_n
    s = gold.inv(shift) if inverse else shift % P
    out = np.empty(n, dtype=np.uint64)
    cur = 1
    for i in range(n):
        out[i] = cur
        cur = (cur * s) % P
    return out


@lru_cache(maxsize=None)
def bitrev_indices(log_n: int) -> np.ndarray:
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool, device: str) -> list:
    """Per stage s, the (1, half, 1) twiddle Gl full[::stride][:half]."""
    full = power_table(log_n, inverse)
    out = []
    for s in range(log_n):
        half = 1 << s
        stride = 1 << (log_n - 1 - s)
        lo, hi = gf64.from_u64(full[::stride][:half], device)
        out.append((lo[None, :, None], hi[None, :, None]))
    return out


@lru_cache(maxsize=None)
def _bitrev_device(log_n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(bitrev_indices(log_n)).to(device)


@lru_cache(maxsize=None)
def _power_table_device(log_n: int, inverse: bool, device: str) -> torch.Tensor:
    """power_table as u64 bit patterns in an int64 tensor (the kernel's table)."""
    return torch.from_numpy(power_table(log_n, inverse).view(np.int64).copy()).to(device)


@lru_cache(maxsize=None)
def _shift_table_device(log_n: int, shift: int, inverse: bool, device: str) -> Gl:
    lo, hi = gf64.from_u64(shift_table(log_n, shift, inverse), device)
    return lo[:, None], hi[:, None]


# ----------------------------------------------------------------------------
# core transform
# ----------------------------------------------------------------------------


def _log2_exact(n: int) -> int:
    log_n = n.bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError(f"NTT length {n} is not a power of two")
    return log_n


def ntt_cols_plain(x: Gl, inverse: bool = False) -> Gl:
    """The plain PyTorch NTT along axis 0 of an (n, C) batch, natural in/out:
    bit-reversal gather, then every DIT stage as a reshape + broadcast pass."""
    lo, hi = _ntt_cols_unscaled_plain(x, inverse)
    if inverse:
        lo, hi = gl_mul((lo, hi), gf64.full((), gold.inv(x[0].shape[0] % P), lo.device))
    return lo, hi


def _ntt_cols_unscaled_plain(x: Gl, inverse: bool) -> Gl:
    """ntt_cols_plain without the inverse's n^-1."""
    n, c = x[0].shape
    log_n = _log2_exact(n)
    dev = str(x[0].device)
    rev = _bitrev_device(log_n, dev)
    lo, hi = x[0].index_select(0, rev), x[1].index_select(0, rev)
    for s, tw in enumerate(_stage_twiddles(log_n, inverse, dev)):
        half = 1 << s
        l4 = lo.reshape(n // (2 * half), 2, half, c)
        h4 = hi.reshape(n // (2 * half), 2, half, c)
        t = gl_mul((l4[:, 1], h4[:, 1]), tw)
        e = gl_add((l4[:, 0], h4[:, 0]), t)
        o = gl_sub((l4[:, 0], h4[:, 0]), t)
        lo = torch.stack([e[0], o[0]], dim=1).reshape(n, c)
        hi = torch.stack([e[1], o[1]], dim=1).reshape(n, c)
    return lo, hi


def _ntt_cols_cuda(x: Gl, inverse: bool) -> Gl:
    lo, hi = (t.contiguous() for t in x)
    if lo.dtype != torch.int64 or hi.dtype != torch.int64 or lo.dim() != 2 or lo.shape != hi.shape or lo.device != hi.device:
        raise ValueError("ntt_cols expects two equal-shape (n, C) int64 tensors on one device")
    n, c = lo.shape
    log_n = _log2_exact(n)
    lib = kernels.load("ntt")
    out_lo, out_hi = torch.empty_like(lo), torch.empty_like(hi)
    scratch = None
    if n > lib.bsx_ntt_smem_max_n():
        scratch = torch.empty((n, c), dtype=torch.int64, device=lo.device)
    tw = _power_table_device(log_n, inverse, str(lo.device))
    n_inv = gold.inv(n % P) if inverse else 1
    with torch.cuda.device(lo.device):
        rc = lib.bsx_ntt_cols(
            lo.data_ptr(), hi.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(),
            tw.data_ptr(), log_n, c, int(inverse), n_inv,
            None if scratch is None else scratch.data_ptr(), kernels.stream_of(lo),
        )
    kernels.check(rc, "ntt kernel")
    kernels.count("ntt" if scratch is None else "ntt_multi")
    return out_lo, out_hi


def ntt_cols(x: Gl, inverse: bool = False) -> Gl:
    """Forward/inverse NTT along axis 0 of an (n, C) batch, natural in/out.
    CUDA tensors go through the NTT kernel, CPU tensors through the plain
    version."""
    if on_cuda(x[0]):
        return _ntt_cols_cuda(x, inverse)
    return ntt_cols_plain(x, inverse)


def coset_scale(x: Gl, shift: int, inverse: bool = False) -> Gl:
    """Multiply row i by shift^i (shift^-i when inverse)."""
    log_n = _log2_exact(x[0].shape[0])
    return gl_mul(x, _shift_table_device(log_n, shift, inverse, str(x[0].device)))


def coset_ntt_cols(x: Gl, shift: int = gold.COSET_SHIFT) -> Gl:
    return ntt_cols(coset_scale(x, shift))


def coset_intt_cols(x: Gl, shift: int = gold.COSET_SHIFT) -> Gl:
    return coset_scale(ntt_cols(x, inverse=True), shift, inverse=True)


def lde_cols(coeffs: Gl, rate_bits: int, shift: int = gold.COSET_SHIFT) -> Gl:
    """Low-degree extension: zero-pad rows x 2^rate_bits, coset-evaluate."""
    n, c = coeffs[0].shape
    pad = n * ((1 << rate_bits) - 1)
    z = torch.zeros((pad, c), dtype=torch.int64, device=coeffs[0].device)
    padded = (torch.cat([coeffs[0], z], dim=0), torch.cat([coeffs[1], z], dim=0))
    return coset_ntt_cols(padded, shift)


# ----------------------------------------------------------------------------
# four-step single-polynomial NTT (one long vector as an (n1, n2) matrix)
# ----------------------------------------------------------------------------


def four_step_shape(log_n: int) -> tuple[int, int]:
    """(n1, n2) with n1 = 2^(log_n // 2): the matrix a length-2^log_n vector
    is reshaped to."""
    log_n1 = log_n // 2
    return 1 << log_n1, 1 << (log_n - log_n1)


@lru_cache(maxsize=None)
def four_step_twiddles(log_n: int, inverse: bool) -> np.ndarray:
    """W[k1, i2] = w^(±k1*i2) as an (n1, n2) uint64 matrix.

    k1*i2 < n, and power_table holds w^j for j < n/2; w^(n/2) = -1, so
    w^j = p - w^(j - n/2) above that."""
    n1, n2 = four_step_shape(log_n)
    tab = power_table(log_n, inverse)
    half = tab.shape[0]
    e = np.arange(n1, dtype=np.int64)[:, None] * np.arange(n2, dtype=np.int64)[None, :]
    low = e < half
    return np.where(low, tab[np.where(low, e, 0)], np.uint64(P) - tab[np.where(low, 0, e - half)])


@lru_cache(maxsize=None)
def _four_step_twiddles_device(log_n: int, inverse: bool, device: str) -> Gl:
    return gf64.from_u64(four_step_twiddles(log_n, inverse), device)


def _check_four_step_input(mat: Gl, log_n: int, shape: tuple[int, int], what: str) -> None:
    lo, hi = mat
    if lo.dtype != torch.int64 or hi.dtype != torch.int64 or lo.shape != hi.shape or lo.device != hi.device:
        raise ValueError(f"{what} expects two equal-shape int64 tensors on one device")
    if tuple(lo.shape) != shape:
        raise ValueError(f"{what} expects shape {shape} at log_n={log_n}, got {tuple(lo.shape)}")


def twiddle_transpose_plain(mat: Gl, log_n: int, inverse: bool = False) -> Gl:
    """The plain version of the four-step middle step: (n1, n2) -> (n2, n1),
    out[i2, k1] = mat[k1, i2] * w^(±k1*i2)."""
    _check_four_step_input(mat, log_n, four_step_shape(log_n), "twiddle_transpose")
    lo, hi = gl_mul(mat, _four_step_twiddles_device(log_n, inverse, str(mat[0].device)))
    return lo.t().contiguous(), hi.t().contiguous()


def _twiddle_transpose_cuda(mat: Gl, log_n: int, inverse: bool) -> Gl:
    _check_four_step_input(mat, log_n, four_step_shape(log_n), "twiddle_transpose")
    lo, hi = mat
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("twiddle_transpose expects contiguous (row-major) tensors")
    n1, n2 = lo.shape
    lib = kernels.load("ntt")
    out_lo = torch.empty((n2, n1), dtype=torch.int64, device=lo.device)
    out_hi = torch.empty((n2, n1), dtype=torch.int64, device=lo.device)
    tw = _power_table_device(log_n, inverse, str(lo.device))
    with torch.cuda.device(lo.device):
        rc = lib.bsx_twiddle_transpose(
            lo.data_ptr(), hi.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(), tw.data_ptr(),
            n1.bit_length() - 1, n2.bit_length() - 1, kernels.stream_of(lo),
        )
    kernels.check(rc, "twiddle-transpose kernel")
    kernels.count("twiddle_transpose")
    return out_lo, out_hi


def twiddle_transpose(mat: Gl, log_n: int, inverse: bool = False) -> Gl:
    """Four-step twiddle multiply fused with the transpose: the kernel
    (csrc/ntt.cu) on CUDA tensors, the plain version on CPU tensors."""
    if on_cuda(mat[0]):
        return _twiddle_transpose_cuda(mat, log_n, inverse)
    return twiddle_transpose_plain(mat, log_n, inverse)


# the largest column of the tile kernel (csrc/ntt.cu NTT_SMEM_MAX_N): the
# two-launch four-step takes n1, n2 <= 2^TILE_MAX_LOG_N
TILE_MAX_LOG_N = 14


def four_step_plan(log_n: int) -> str:
    """The route of ``ntt_four_step`` on the card at length 2^log_n:
    "two_launch" (four_step_first, then four_step_last) while both factors
    fit the tile kernel, else "long_columns" (ntt_cols, twiddle_transpose,
    ntt_cols; the columns of length n2 > 2^14 on the long-column passes)."""
    if log_n < 0:
        raise ValueError(f"negative log_n {log_n}")
    return "two_launch" if log_n <= 2 * TILE_MAX_LOG_N else "long_columns"


@lru_cache(maxsize=None)
def four_step_twiddle_tables(log_n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """The first launch's twiddle tables (high, low): W[k1, i2] = w^e,
    e = k1*i2, is high[e >> h] * low[e mod 2^h] with h = ceil(log_n / 2);
    high[j] = w^(j * 2^h) times n^-1 for the inverse (the inverse's whole
    scale, so it costs no multiply), low[j] = w^j."""
    h = (log_n + 1) // 2
    w = gold.root_of_unity(log_n)
    if inverse:
        w = gold.inv(w)
    scale = gold.inv((1 << log_n) % P) if inverse else 1

    def powers(step: int, count: int, first: int) -> np.ndarray:
        out = np.empty(count, dtype=np.uint64)
        cur = first
        for j in range(count):
            out[j] = cur
            cur = cur * step % P
        return out

    return powers(pow(w, 1 << h, P), 1 << (log_n - h), scale), powers(w, 1 << h, 1)


@lru_cache(maxsize=None)
def _four_step_twiddle_tables_device(log_n: int, inverse: bool, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(t.view(np.int64).copy()).to(device)
                 for t in four_step_twiddle_tables(log_n, inverse))


@lru_cache(maxsize=None)
def _inverse(n: int) -> int:
    return gold.inv(n % P)


def four_step_first_plain(mat: Gl, log_n: int, inverse: bool = False) -> Gl:
    """The plain version of the first launch: steps A and B of the JAX
    package's ntt_four_step, (n1, n2) -> (n2, n1): column NTTs of length n1,
    times W[k1, i2], transposed; for the inverse times n^-1 (step A's n1^-1
    and step C's n2^-1)."""
    _check_four_step_input(mat, log_n, four_step_shape(log_n), "four_step_first")
    out = twiddle_transpose_plain(_ntt_cols_unscaled_plain(mat, inverse), log_n, inverse)
    return gl_mul(out, gf64.full((), _inverse(1 << log_n), mat[0].device)) if inverse else out


def four_step_last_plain(mat: Gl, log_n: int, inverse: bool = False) -> Gl:
    """The plain version of the second launch: step C, column NTTs of
    length n2 of the (n2, n1) matrix, without the inverse's n2^-1 (the
    first launch applied it)."""
    n1, n2 = four_step_shape(log_n)
    _check_four_step_input(mat, log_n, (n2, n1), "four_step_last")
    return _ntt_cols_unscaled_plain(mat, inverse)


def scratch_from_gl(mat: Gl) -> torch.Tensor:
    """The intermediate the first launch writes, from its value as a Gl
    (n2, n1): each element as one u64 (in an int64 tensor), rows in
    bit-reversed order."""
    rev = _bitrev_device(_log2_exact(mat[0].shape[0]), str(mat[0].device))
    return ((mat[1] << 32) | mat[0]).index_select(0, rev)


def gl_from_scratch(buf: torch.Tensor) -> Gl:
    """The Gl (n2, n1) that an intermediate of the first launch holds."""
    rev = _bitrev_device(_log2_exact(buf.shape[0]), str(buf.device))
    v = buf.index_select(0, rev)
    return v & gf64.M32, (v >> 32) & gf64.M32


def _four_step_first_cuda(mat: Gl, log_n: int, inverse: bool) -> torch.Tensor:
    """four_step_first_kernel: (n1, n2) (lo, hi) -> the (n2, n1) u64
    intermediate, rows bit-reversed (gl_from_scratch reads it)."""
    _check_four_step_input(mat, log_n, four_step_shape(log_n), "four_step_first")
    lo, hi = mat
    if not (lo.is_contiguous() and hi.is_contiguous()):
        raise ValueError("four_step_first expects contiguous (row-major) tensors")
    n1, n2 = lo.shape
    dev = str(lo.device)
    lib = kernels.load("ntt")
    buf = torch.empty((n2, n1), dtype=torch.int64, device=lo.device)
    tw = _power_table_device(n1.bit_length() - 1, inverse, dev)
    high, low = _four_step_twiddle_tables_device(log_n, inverse, dev)
    with torch.cuda.device(lo.device):
        rc = lib.bsx_four_step_first(
            lo.data_ptr(), hi.data_ptr(), buf.data_ptr(), tw.data_ptr(), high.data_ptr(), low.data_ptr(),
            n1.bit_length() - 1, n2.bit_length() - 1, kernels.stream_of(lo),
        )
    kernels.check(rc, "four-step first kernel")
    kernels.count("four_step_first")
    return buf


def _four_step_last_cuda(buf: torch.Tensor, log_n: int, inverse: bool) -> Gl:
    """four_step_last_kernel: the intermediate -> the (n2, n1) (lo, hi)
    output, natural order."""
    n1, n2 = four_step_shape(log_n)
    if buf.dtype != torch.int64 or tuple(buf.shape) != (n2, n1) or not buf.is_contiguous():
        raise ValueError(f"four_step_last expects a contiguous ({n2}, {n1}) int64 intermediate at log_n={log_n}")
    dev = str(buf.device)
    lib = kernels.load("ntt")
    out_lo = torch.empty((n2, n1), dtype=torch.int64, device=buf.device)
    out_hi = torch.empty((n2, n1), dtype=torch.int64, device=buf.device)
    tw = _power_table_device(n2.bit_length() - 1, inverse, dev)
    with torch.cuda.device(buf.device):
        rc = lib.bsx_four_step_last(
            buf.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(), tw.data_ptr(),
            n1.bit_length() - 1, n2.bit_length() - 1, kernels.stream_of(buf),
        )
    kernels.check(rc, "four-step last kernel")
    kernels.count("four_step_last")
    return out_lo, out_hi


def ntt_four_step(x: Gl, inverse: bool = False) -> Gl:
    """NTT of one length-n polynomial x (a Gl of shape (n,)), natural order
    in and out, as n1 x n2 column transforms. On CUDA tensors the route of
    four_step_plan: two launches up to 2^28, else the NTT kernel twice
    around the twiddle-transpose kernel; on CPU tensors the plain version."""
    if not on_cuda(x[0]):
        return ntt_four_step_plain(x, inverse)
    log_n = _log2_exact(x[0].shape[0])
    if four_step_plan(log_n) == "long_columns":
        return _four_step_long_columns_cuda(x, inverse)
    n1, n2 = four_step_shape(log_n)
    mat = (x[0].reshape(n1, n2), x[1].reshape(n1, n2))
    out = _four_step_last_cuda(_four_step_first_cuda(mat, log_n, inverse), log_n, inverse)
    # the row-major (n2, n1) result holds k = k1 + n1*k2 at [k2, k1]: natural order
    return out[0].reshape(-1), out[1].reshape(-1)


def _four_step_long_columns_cuda(x: Gl, inverse: bool) -> Gl:
    """ntt_four_step's route above 2^28: the column NTT of length n1 (n1^-1
    for the inverse), twiddle_transpose, the column NTT of length n2 (on the
    long-column passes above 2^14; n2^-1 for the inverse)."""
    n = x[0].shape[0]
    log_n = _log2_exact(n)
    n1, n2 = four_step_shape(log_n)
    mat = _ntt_cols_cuda((x[0].reshape(n1, n2), x[1].reshape(n1, n2)), inverse)
    out = _ntt_cols_cuda(_twiddle_transpose_cuda(mat, log_n, inverse), inverse)
    return out[0].reshape(n), out[1].reshape(n)


def ntt_four_step_plain(x: Gl, inverse: bool = False) -> Gl:
    """ntt_four_step on the plain versions alone, on the input's device:
    four_step_first_plain, then four_step_last_plain."""
    n = x[0].shape[0]
    log_n = _log2_exact(n)
    n1, n2 = four_step_shape(log_n)
    mat = four_step_first_plain((x[0].reshape(n1, n2), x[1].reshape(n1, n2)), log_n, inverse)
    out = four_step_last_plain(mat, log_n, inverse)
    return out[0].reshape(n), out[1].reshape(n)


def butterfly_count(log_n: int) -> int:
    """Total radix-2 butterflies in one length-2^log_n transform."""
    return (1 << (log_n - 1)) * log_n
