"""NTT calls on one Goldilocks polynomial, queued ahead of the card.

Two polynomials of 2^log_n coefficients, x and z, are drawn on the card
from the seed (a torch.Generator on the device). Calls alternate: even
calls the forward transform of x, odd calls the inverse of z, each through
the program's ``ntt_four_step`` into a fresh output. The host synchronises
once every ``sync_every`` calls, so it never waits on a single call; the
window ends at the first synchronisation after ``seconds``. With
``--trace 1``, ``trace_blocks`` more blocks run under the profiler after
the window.

Outputs are kept for the check by reservoir sampling, drawn from the seed:
``check_sample`` of the window's calls, each equally likely, held as they
are (no copy, no device work in the window). After the window the
reference transforms x and z on the host and every kept output is compared
with it, element by element.

Faults (``--fault``, never in a measured run), in place of the program's call:

- ``control``: the reference itself computed with a lazy reduction, its
  multiply's last carry (2^64 = 2^32 - 1 mod p) dropped: exact arithmetic,
  the guarantee the configuration states, broken; at 2^22 a call takes
  seconds on the host, so the window holds a few;
- ``stale``: the input comes back unchanged;
- ``half``: the second half of the output is the input's;
- ``altered``: one output element is off by one.
"""

from __future__ import annotations

import random
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.profiler import record_function

from portbench.reference import ntt as ref_ntt

M32 = 0xFFFFFFFF


def gl_to_u64(x) -> np.ndarray:
    lo = x[0].detach().cpu().numpy().astype(np.uint64)
    hi = x[1].detach().cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def gl_from_u64(v: np.ndarray, device):
    v = np.asarray(v, dtype=np.uint64)
    lo = torch.from_numpy((v & np.uint64(M32)).astype(np.int64)).to(device)
    hi = torch.from_numpy((v >> np.uint64(32)).astype(np.int64)).to(device)
    return lo, hi


class Op:
    family = "ntt"

    def __init__(self, cell, seed: int, device):
        self.log_n = int(cell.config["log_n"])
        self.n = 1 << self.log_n
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.kept: list[tuple[int, bool, object]] = []
        self.calls = 0

    def program_ntt(self):
        from blobstreamx_tpu_torch.ops import ntt as ntt_ops

        return ntt_ops.ntt_four_step

    def _poly(self, gen):
        lo = torch.randint(0, 1 << 32, (self.n,), generator=gen, device=self.device, dtype=torch.int64)
        hi = torch.randint(0, 1 << 32, (self.n,), generator=gen, device=self.device, dtype=torch.int64)
        return torch.where(hi == M32, torch.zeros_like(lo), lo), hi  # canonical: below p

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        self.fn = self.program_ntt()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed % (1 << 63))
        self.x = self._poly(gen)
        self.z = self._poly(gen)
        self.x_host = gl_to_u64(self.x)
        self.z_host = gl_to_u64(self.z)
        for _ in range(int(self.traffic["warmup_calls"])):
            self.fn(self.x, False)
            self.fn(self.z, True)
        self._sync()

    def _keep(self, rng: random.Random, i: int, inverse: bool, out) -> None:
        k = int(self.traffic["check_sample"])
        if len(self.kept) < k:
            self.kept.append((i, inverse, out))
        else:
            j = rng.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, inverse, out)

    def _block(self, rng: random.Random, every: int) -> None:
        with record_function("portbench.ntt_block"):
            for _ in range(every):
                inverse = self.calls % 2 == 1
                out = self.fn(self.z if inverse else self.x, inverse)
                self._keep(rng, self.calls, inverse, out)
                self.calls += 1
            self._sync()

    def window(self, seconds: float, tracer) -> dict:
        """The measured window, then (traced runs) trace_blocks more blocks
        under the profiler, outside the window."""
        rng = random.Random(self.seed ^ 0x5EED_C4EC)
        every = int(self.traffic["sync_every"])
        t_start = time.perf_counter()
        while True:
            self._block(rng, every)
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
        calls = self.calls
        if tracer.enabled:
            tracer.start()
            for _ in range(int(self.traffic.get("trace_blocks", 1))):
                self._block(rng, every)
            tracer.requests = self.calls - calls
            tracer.stop()
        return {"window_s": window_s, "attempted": self.calls, "failed": 0, "window_calls": calls}

    def release(self) -> None:
        self.x = self.z = None

    def check(self) -> dict:
        with ThreadPoolExecutor(max_workers=2) as pool:
            fwd = pool.submit(ref_ntt.ntt, self.x_host, False)
            inv = pool.submit(ref_ntt.ntt, self.z_host, True)
            want = {False: fwd.result(), True: inv.result()}
        mismatched = 0
        for _, inverse, out in self.kept:
            mismatched += int(np.count_nonzero(gl_to_u64(out) != want[inverse]))
        compared = len(self.kept)
        self.kept = []
        return {
            "mismatched_elements": {"value": mismatched, "limit": 0, "is": "at_most"},
            "outputs_compared": {"value": compared, "limit": 1, "is": "at_least"},
        }

    def record(self) -> dict:
        return {"family": self.family, "log_n": self.log_n}


def mul_lazy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference's multiply with its last carry dropped: t0 + t1 taken
    mod 2^64 without adding back 2^64 mod p when it wraps."""
    a0, a1 = a & np.uint64(M32), a >> np.uint64(32)
    b0, b1 = b & np.uint64(M32), b >> np.uint64(32)
    p00, p01, p10, p11 = a0 * b0, a0 * b1, a1 * b0, a1 * b1
    mid = p01 + p10
    lo = p00 + (mid << np.uint64(32))
    hi = p11 + (mid >> np.uint64(32)) + ((mid < p01).astype(np.uint64) << np.uint64(32)) + (lo < p00).astype(np.uint64)
    hi_hi, hi_lo = hi >> np.uint64(32), hi & np.uint64(M32)
    t0 = lo - hi_hi
    t0 = np.where(lo < hi_hi, t0 - np.uint64(M32), t0)
    t2 = t0 + hi_lo * np.uint64(M32)
    return np.where(t2 >= np.uint64(ref_ntt.P), t2 - np.uint64(ref_ntt.P), t2)


def _replace(op, make):
    fn = op.fn
    op.fn = make(fn)
    return lambda: setattr(op, "fn", fn)


def _control(fn, op):
    return lambda x, inverse: gl_from_u64(ref_ntt.ntt(gl_to_u64(x), inverse, mul=mul_lazy), op.device)


def _half(fn, op):
    def half(x, inverse):
        lo, hi = fn(x, inverse)
        m = lo.shape[0] // 2
        lo, hi = lo.clone(), hi.clone()
        lo[m:], hi[m:] = x[0][m:], x[1][m:]
        return lo, hi

    return half


def _altered(fn, op):
    def altered(x, inverse):
        lo, hi = fn(x, inverse)
        lo = lo.clone()
        lo[0] ^= 1
        return lo, hi

    return altered


FAULTS = {
    "control": lambda op: _replace(op, lambda fn: _control(fn, op)),
    "stale": lambda op: _replace(op, lambda fn: lambda x, inverse: (x[0].clone(), x[1].clone())),
    "half": lambda op: _replace(op, lambda fn: _half(fn, op)),
    "altered": lambda op: _replace(op, lambda fn: _altered(fn, op)),
}
