"""Batched Poseidon permutation + sponge hashing.

Layout: a batch of width-12 states is a Gl pair of int64 tensors of shape
``(12, N)`` — state-element index on axis 0, batch on axis 1 (the JAX
package's layout).

``permute`` is the entry point: on a CUDA tensor it launches the Poseidon
kernel (csrc/poseidon.cu), on a CPU tensor it runs ``permute_plain``.

MDS in the plain version (the circulant matrix's entries are all powers of
two): ``out[r] = Σ_i state[(i+r) mod 12] << K[i]  (+ 8*state[0] for r=0)``.
Each state word is split into four 16-bit limbs; the shifted limbs of all
13 terms accumulate in int64 columns of 16-bit significance (each column
stays below 2^16 · Σ 2^(K mod 16) < 2^29), one carry pass turns them into words, and one
128 -> 64 reduction per row finishes.

Golden oracle: blobstreamx_tpu_torch.golden.poseidon (bit-exact).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from blobstreamx_tpu_torch import kernels
from blobstreamx_tpu_torch.device import on_cuda
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.fields.gf64 import Gl, gl_add, gl_mul, gl_square
from blobstreamx_tpu_torch.golden import poseidon as gold

WIDTH = gold.WIDTH
RATE = gold.RATE
DIGEST = gold.DIGEST
N_ROUNDS = gold.N_ROUNDS
HALF_FULL = gold.FULL_ROUNDS // 2
PARTIAL = gold.PARTIAL_ROUNDS

# log2 of the circulant MDS entries; diag entry is 8 = 2^3 on row 0 only.
MDS_LOG = tuple(int(c).bit_length() - 1 for c in gold.MDS_CIRC)
DIAG_LOG = 3
M16 = 0xFFFF


@lru_cache(maxsize=None)
def _round_constants_np() -> np.ndarray:
    return np.array(gold.round_constants(), dtype=np.uint64).reshape(N_ROUNDS, WIDTH)


@lru_cache(maxsize=None)
def _round_constants(device: str) -> list:
    lo, hi = gf64.from_u64(_round_constants_np(), device)
    return [(lo[r][:, None], hi[r][:, None]) for r in range(N_ROUNDS)]


def _sbox(x: Gl) -> Gl:
    """x^7 = (x^3)^2 * x with x^3 = x^2 * x  (2 squares + 2 muls)."""
    x3 = gl_mul(gl_square(x), x)
    return gl_mul(gl_square(x3), x)


def _mds(state: Gl) -> Gl:
    lo, hi = state
    limbs = torch.stack([lo & M16, lo >> 16, hi & M16, hi >> 16])  # (4, 12, N)
    cols = [None] * 6
    terms = [(torch.roll(limbs, -i, dims=1), k) for i, k in enumerate(MDS_LOG)]
    diag = torch.zeros_like(limbs)
    diag[:, 0] = limbs[:, 0]
    terms.append((diag, DIAG_LOG))
    for rolled, k in terms:
        q, r = divmod(k, 16)
        for li in range(4):
            term = rolled[li] << r
            c = li + q
            cols[c] = term if cols[c] is None else cols[c] + term
    words = []
    carry = 0
    for c in range(6):
        tot = carry if cols[c] is None else cols[c] + carry
        words.append(tot & M16)
        carry = tot >> 16
    # value < 2^85: words 0..5 plus the final carry hold it (n3 = 0)
    n0 = words[0] | (words[1] << 16)
    n1 = words[2] | (words[3] << 16)
    n2 = words[4] | (words[5] << 16) | (carry << 32)
    return gf64._fold(n0 - n2, n1 + n2)


def _full_round(state: Gl, rc: Gl) -> Gl:
    return _mds(_sbox(gl_add(state, rc)))


def _partial_round(state: Gl, rc: Gl) -> Gl:
    lo, hi = gl_add(state, rc)
    s0 = _sbox((lo[0:1], hi[0:1]))
    return _mds((torch.cat([s0[0], lo[1:]]), torch.cat([s0[1], hi[1:]])))


def permute_plain(state: Gl) -> Gl:
    """The plain PyTorch Poseidon permutation of a (12, N) batch."""
    rcs = _round_constants(str(state[0].device))
    for r in range(N_ROUNDS):
        if HALF_FULL <= r < HALF_FULL + PARTIAL:
            state = _partial_round(state, rcs[r])
        else:
            state = _full_round(state, rcs[r])
    return state


_RC_SET: set = set()


def _permute_cuda(state: Gl) -> Gl:
    lo, hi = (t.contiguous() for t in state)
    if (lo.dtype != torch.int64 or hi.dtype != torch.int64 or lo.dim() != 2 or lo.shape[0] != WIDTH
            or lo.shape != hi.shape or lo.device != hi.device):
        raise ValueError("permute expects two (12, N) int64 tensors on one device")
    n = lo.shape[1]
    lib = kernels.load("poseidon")
    out_lo, out_hi = torch.empty_like(lo), torch.empty_like(hi)
    with torch.cuda.device(lo.device):
        if lo.device.index not in _RC_SET:
            rc = np.ascontiguousarray(_round_constants_np())
            kernels.check(lib.bsx_poseidon_set_round_constants(rc.ctypes.data), "poseidon constants")
            _RC_SET.add(lo.device.index)
        rc = lib.bsx_poseidon_permute(
            lo.data_ptr(), hi.data_ptr(), out_lo.data_ptr(), out_hi.data_ptr(), n,
            kernels.stream_of(lo),
        )
    kernels.check(rc, "poseidon kernel")
    kernels.count("poseidon")
    return out_lo, out_hi


def permute(state: Gl) -> Gl:
    """Poseidon permutation of a (12, N) batch: the kernel on CUDA tensors,
    the plain version on CPU tensors (bit-identical)."""
    if on_cuda(state[0]):
        return _permute_cuda(state)
    return permute_plain(state)


# ----------------------------------------------------------------------------
# Sponge hashing over batches
# ----------------------------------------------------------------------------


def hash_columns(inputs: Gl) -> Gl:
    """Hash N vectors of L field elements each: inputs (L, N) -> digests (4, N).

    Sponge with rate 8/capacity 4, no padding (fixed-length input), matching
    golden hash_n_to_m_no_pad column-wise."""
    lo, hi = inputs
    n = lo.shape[1]
    state = gf64.zeros((WIDTH, n), lo.device)
    for start in range(0, lo.shape[0], RATE):
        chunk = min(RATE, lo.shape[0] - start)
        slo = torch.cat([lo[start : start + chunk], state[0][chunk:]])
        shi = torch.cat([hi[start : start + chunk], state[1][chunk:]])
        state = permute((slo, shi))
    return state[0][:DIGEST], state[1][:DIGEST]


def compress_pairs(left: Gl, right: Gl) -> Gl:
    """Two-to-one compression of N digest pairs: (4,N),(4,N) -> (4,N)."""
    z = torch.zeros((WIDTH - 2 * DIGEST,) + tuple(left[0].shape[1:]), dtype=torch.int64, device=left[0].device)
    state = permute((torch.cat([left[0], right[0], z]), torch.cat([left[1], right[1], z])))
    return state[0][:DIGEST], state[1][:DIGEST]
