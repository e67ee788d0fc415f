"""FRI helpers shared by the extension-field prover (prover/fri_ext.py).

- ``_xinv_table``: the 1/x_i factors of the arity-2 fold;
- ``grind``: the proof-of-work nonce search, batched on the device (2^14
  forked challenger states per Poseidon batch), returning the same first
  nonce the sequential golden grind finds.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.golden.challenger import Challenger
from blobstreamx_tpu_torch.golden.poseidon import RATE, WIDTH
from blobstreamx_tpu_torch.ops import ntt as ntt_ops, poseidon as pos

P = gold.P
INV2 = gold.inv(2)


@lru_cache(maxsize=None)
def _xinv_table(log_n: int, shift: int) -> np.ndarray:
    """(shift * w^i)^-1 for i < n/2, as uint64."""
    inv_pow = ntt_ops.power_table(log_n, inverse=True)  # w^-i, i < n/2
    si = gold.inv(shift)
    return np.array([(int(v) * si) % P for v in inv_pow], dtype=np.uint64)


def _grind_batch(state12: list[int], pending: list[int], start: int, batch: int, device):
    """Poseidon-permute `batch` forked challenger states with nonces
    start..start+batch-1 and return the sampled values' high words."""
    vals = np.zeros((WIDTH, batch), dtype=np.uint64)
    for i, v in enumerate(state12):
        vals[i, :] = v
    for i, v in enumerate(pending):
        vals[i, :] = v
    vals[len(pending), :] = np.arange(start, start + batch, dtype=np.uint64)
    out = pos.permute(gf64.from_u64(vals, device))
    # golden sample() pops output_buffer[-1] == state[RATE-1]
    return out[1][RATE - 1]


def grind(
    challenger: Challenger,
    bits: int,
    device=None,
    batch: int = 1 << 14,
    max_batches: int = 1 << 12,
) -> int:
    """First nonce n>=0 such that fork(observe(n); sample()) has `bits`
    leading zero bits. Bit-identical to golden.fri.grind, but evaluates
    nonce batches in one device permutation call.

    Requires len(pending inputs) <= RATE-1 (true for our transcripts; the
    grind follows observe_many(final_poly) which flushes in RATE chunks)."""
    assert 0 < bits <= 32
    pending = list(challenger.input_buffer)
    assert len(pending) < RATE
    state = list(challenger.state)
    bound = 1 << (32 - bits)
    for b in range(max_batches):
        start = b * batch
        hi = _grind_batch(state, pending, start, batch, device)
        ok = (hi < bound).nonzero()
        if ok.numel():
            return start + int(ok[0, 0])
    raise RuntimeError("grind exhausted max_batches")
