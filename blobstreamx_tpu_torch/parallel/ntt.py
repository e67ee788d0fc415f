"""The NTT over a mesh: the six-step factorization with one all-to-all.

A length-n polynomial is the (n1, n2) matrix x[i1, i2] = coeffs[i1*n2 + i2],
its columns sharded over the ranks. Then:

  A. local column NTTs (length n1): no communication
  B. local twiddle multiply by W[k1, i2] = w^(k1*i2) (this rank's columns of W)
  C. one all-to-all re-shard and a local transpose (n/D elements a rank)
  D. local column NTTs (length n2)

The result is the (n2, n1) matrix Z with natural-order flattening
out[k2*n1 + k1] = Z[k2, k1], columns (k1) sharded. A FRI fold's pairs
(i, i + n/2) are rows (k2, k2 + n2/2) of the same column, so every fold
stays on its rank.

The column-batched LDE of a trace matrix is data-parallel (columns sharded,
no communication): ``lde_cols_sharded``.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl, gl_mul
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.ops import ntt as ntt_ops
from .mesh import Mesh

_factor = ntt_ops.four_step_shape


@lru_cache(maxsize=8)
def _twiddle_cols(log_n: int, inverse: bool, a: int, b: int, device: str) -> Gl:
    """Columns [a, b) of the (n1, n2) four-step twiddle matrix, on `device`."""
    return gf64.from_u64(ntt_ops.four_step_twiddles(log_n, inverse)[:, a:b].copy(), device)


def ntt_matrix_sharded(x: Gl, mesh: Mesh, inverse: bool = False) -> Gl:
    """Six-step NTT. x: this rank's columns (n1, n2/D) of the (n1, n2)
    row-major view of the length-n input. Returns this rank's columns
    (n2, n1/D) of the (n2, n1) natural-order output. D must divide n1 and n2."""
    d = mesh.size
    n1, n2_local = x[0].shape
    n2 = n2_local * d
    log_n = (n1 * n2).bit_length() - 1
    assert _factor(log_n) == (n1, n2), "shape must match the canonical factorization"
    assert n1 % d == 0, (n1, d)
    a = mesh.rank * n2_local
    mat = ntt_ops.ntt_cols(x, inverse)  # A
    mat = gl_mul(mat, _twiddle_cols(log_n, inverse, a, a + n2_local, str(x[0].device)))  # B
    # C: (n1, n2/D) -> (n1/D, n2): rank s gets rows [s*n1/D, (s+1)*n1/D) of every column block
    m = n1 // d
    both = torch.stack(mat)
    chunks = [both[:, s * m : (s + 1) * m, :] for s in range(d)]
    recv = mesh.all_to_all(chunks, [(2, m, n2_local)] * d, dim=1)
    rows = torch.cat(recv, dim=2)  # (2, n1/D, n2), columns in rank order
    t = rows.transpose(1, 2).contiguous()  # (2, n2, n1/D)
    return ntt_ops.ntt_cols((t[0], t[1]), inverse)  # D


def ntt_sharded(coeffs: Gl, mesh: Mesh, inverse: bool = False) -> Gl:
    """Natural-order (n,) -> natural-order (n,) six-step NTT. Every rank
    passes the whole input and gets the whole output: it takes its columns,
    runs ntt_matrix_sharded and gathers the result (a convenience wrapper;
    a caller that can keep the sharded matrix should)."""
    n = coeffs[0].shape[0]
    log_n = n.bit_length() - 1
    n1, n2 = _factor(log_n)
    d = mesh.size
    assert n2 % d == 0, (n2, d)
    w = n2 // d
    a = mesh.rank * w
    x = tuple(c.reshape(n1, n2)[:, a : a + w].contiguous() for c in coeffs)
    z = ntt_matrix_sharded(x, mesh, inverse)
    parts = mesh.all_gather(torch.stack(z))  # D x (2, n2, n1/D)
    full = torch.cat(parts, dim=2)
    return full[0].reshape(n), full[1].reshape(n)


def lde_cols_sharded(coeffs: Gl, rate_bits: int, mesh: Mesh, shift: int = gold.COSET_SHIFT) -> Gl:
    """Data-parallel LDE of a trace matrix: this rank's columns of the (n, C)
    coefficients in, its columns of the (n * 2^rate, C) LDE out, no
    communication (the columns may be ragged: see mesh.col_bounds)."""
    if coeffs[0].shape[1] == 0:
        n = coeffs[0].shape[0] << rate_bits
        return gf64.zeros((n, 0), coeffs[0].device)
    return ntt_ops.lde_cols(coeffs, rate_bits, shift)
