#!/usr/bin/env python3
"""Smoke run of the PyTorch port (blobstreamx_tpu_torch) on one NVIDIA card.

Run from the repository root:

    python3 chip_smoke.py [--profile]

It needs one CUDA card and the CUDA toolkit (nvcc), and no network. It
imports nothing of JAX or of the JAX package. Phases, each printed as it
ends (any failure raises, so the script exits non-zero and prints no
result):

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build: one nvcc per csrc/*.cu, started together, into
     build/kernels/;
  3. a kernel check per kernel: the kernel against its plain PyTorch version
     on the same seeded inputs (values near p, near 2^32 and 2^256, random
     valid curve points) at the main paths' shapes, among them Poseidon at
     config 4's (12, 2^21) and (12, 2^20) and the NTT at the FRI final
     polynomial's (8, 1), and at the edges of their designs: Poseidon at a
     ragged batch ((12, 16383), (12, 1)), the NTT at a ragged last column
     tile (2048, 2050), one-column tiles (2^14, 3), n = 1 (1, 4), both
     passes of an odd-log four-step ((1024, 2048), (2048, 1024)) and the
     256-validator StepAir's trace INTT (256, 4) and LDE (2048, 4), the NTT's
     long-column path (columns longer than 2^14, a launch a pass of
     shared-memory stages) at the SHA tier's shapes (the trace chunk's LDE
     (2^21, 32) and INTT (2^18, 32), the ragged last chunk (2^18, 20), the
     quotient's coset INTT (2^21, 2) and LDE (2^21, 16)), at phase 10's
     512-block shard (its 128-column trace chunks: INTT (2^15, 128), LDE
     (2^18, 128), and the ragged last chunk (2^15, 20), (2^18, 20)), at
     phase 12's Ed STARK (its 128-column trace chunks: INTT (2^16, 128),
     LDE (2^19, 128); its quotient: coset INTT (2^19, 2), LDE (2^19, 16)),
     at (2^16, 8) and
     at the edges of its design (the smallest long column (2^15, 1) and
     (2^15, 3) inverse, a ragged column tile; an uneven split (2^17, 5);
     the largest two-pass column (2^22, 8); three passes (2^23, 4)), each
     with the kernels one call launches (the NTT library's own count: 2 up
     to 2^22, 3 above) and their device time under torch.profiler;
     the Edwards add at config 5's lane counts 64, 1024, 4096 and 32768,
     each with edge lanes (an identity operand, a doubling, p + (-p),
     points of order 2 and 4, coordinates in [p, 2^256)), and pow22523 at
     64 and 4096 lanes; mismatches (must be 0), the kernel's and the
     plain version's time by CUDA events, and the
     kernel's bound from its counted bytes and operations (the
     twiddle-transpose also beside a bare transpose copy, the sqn chain
     timed at k = 1, 5 and 50, and an empty kernel's launch through the
     ed25519 library timed first as the launch floor, a yardstick);
  4. card vs CPU: the small chain of tests/test_pipeline.py proven on cuda
     and on cpu gives identical proof bytes, for the skip 2 -> 10 and for
     the step 9 -> 10 (the CPU path is held byte-equal to the JAX package
     by the CPU tests); and the 3-header, 1-validator chain of
     tests/test_torch_full_tier.py's slow test, proven on cuda at the
     full-coverage tier under that test's config, hashes to the SHA-256 of
     the CPU's proof, which the JAX package's verifier accepts; and the same
     chain at the Ed25519 tier (tests/test_torch_ed_tier.py's slow test)
     likewise;
  5. config 5 (1024 headers, 32 validators, seed 7, trusted 1 -> target
     1024, default StarkConfig): witness, a cold and a warm prove_skip on
     cuda, the port's verifier (must accept), a tampered publics[0] (must
     be rejected), the TimingTree, each kernel's launches in the warm prove
     (each must be > 0) and the peak device memory;
  6. only with --profile: one more warm prove under torch.profiler (device
     time by kernel, the Ed25519 kernels' total, host time by operator,
     kernel launches, the device's busy share of the wall), and the same
     for one more warm config-4 run at the end of phase 7;
  7. config 4 (benches/configs.py's config4: one 2^22 polynomial, numpy
     seed 0): a cold and a warm run of the path, the launches and peak
     device memory of the warm one (ntt, twiddle_transpose and poseidon must
     each launch) — the four-step NTT forward and inverse, a low-degree
     codeword (2^19 coefficients, coset_scale, four-step) and its FRI proof
     (default FriConfig) — then the checks: four-step == its plain version
     == ntt_cols of the (2^22, 1) column, inverse(forward) == identity, the
     codeword == lde_cols, fri_verify accepts the proof and rejects one
     changed query pair, and the 2^21 four-step (an odd log n) forward and
     inverse == their plain versions; then CUDA-event times of the four-step (16
     iterations each way, butterflies/s) and of its plain version, of the
     column path and of one
     fold of the codeword. One JSON line {"config4": {...}}.
  8. config 5 at the SHA-256 tier: first the memory fit behind
     stark_stream.AUTO_STREAM_BYTES (stark.prove's peak device memory on
     Sha256Air traces of 2^12, 2^13 and 2^14 rows against
     estimate_standard_bytes, a least-squares line, and the peak it predicts
     at the cutover, which must stay under 85 % of the card's memory); then
     phase 5's witness through a cold and a warm
     prove_skip(with_sha_stark=True) on cuda (the SHA STARK over the
     1023-leaf tuple tree: 4096 blocks, a 2^18 x 1300 trace, 2^21 rows
     extended, on the streaming path), the TimingTree, each kernel's
     launches in the warm prove (ntt, ntt_multi, poseidon, edwards_add and
     pow_chain must each be > 0), the peak device memory (under the card's)
     and what was resident before, the prover path prove_auto took (must be
     streaming), the SHA-256 of the warm proof's bytes; warm bytes == cold
     bytes, the port's verifier accepts with
     "ok: tuple tree", and rejects one word of a claimed digest changed, the
     SHA STARK stripped, and one embedded range data hash changed. One JSON
     line {"config5_sha": {...}}; with --profile, one more warm SHA-tier
     prove under torch.profiler.
  9. prove_step at config 5's shape (phase 5's chain, 1023 -> 1024, 32
     validators) and at config 3's signature count (a two-header chain of
     256 validators, all signing, 1 -> 2; the chain's host generation
     timed): for each, a cold and a warm prove_step on cuda, the TimingTree,
     the warm prove's launches (ntt, poseidon, edwards_add and pow_chain
     must each be > 0) and peak device memory, verify_step_proof accepts,
     and rejects a tampered publics[0] and a new_height off by one. One
     JSON line {"step": {...}}.
 10. config 5 at the full-coverage SHA-256 tier, cut in depth to 192
     headers (32 validators, seed 7, trusted 1 -> target 192): one
     prove_skip(w, device="cuda", with_sha_stark="full"), its shards as the
     prover recorded them (two, of 4096 and 512 padded blocks, asserted;
     each with the prover path prove_auto took and its time), the
     TimingTree, the launches (ntt, ntt_multi, poseidon, edwards_add and
     pow_chain must each be > 0), the peak device memory (under the card's)
     and what was resident before, the SHA-256 of the proof's bytes, a
     serializer round trip, the port's verifier (must accept with "ok: full
     coverage") and five tampers, each rejected with its own verdict: one
     word of a claimed digest in aux, one link_fields part-set hash and the
     SHA proof stripped (the claim digest binding), one embedded range data
     hash (the claim walk), a wrong quotient opening in the first shard's
     STARK (that shard's STARK check). One JSON line {"config5_full": {...}}.
 12. config 5 at the Ed25519 STARK tier (phase 5's witness; it runs after
     phase 10 and before phase 11): a cold and a warm prove_skip(w,
     device="cuda", with_ed_stark=True) (32 signatures, 65 scalar
     multiplications padded to 128 segments: a 65,536 x 1,069 trace, 2^19
     rows extended, on the streaming path, asserted), the TimingTree, the
     launches (ntt, ntt_multi, poseidon, edwards_add and pow_chain must each
     be > 0), the peak device memory (under the card's) and what was
     resident before, the SHA-256 of the warm proof's bytes (== the cold
     proof's), a serializer round trip, the port's verifier (must accept
     with ed_stark "ok" and binding "ok") and five tampers, each rejected
     with its own verdict: a claimed result point, a claimed scalar and the
     Ed STARK stripped (the claim digest binding; the first two also fail
     the Ed STARK's own check), a wrong quotient opening in the Ed STARK
     (the batch equation's STARK check) and an embedded claim bundle
     without the validator lists (fail closed). One JSON line
     {"config5_ed": {...}}; with --profile, one more warm Ed-tier prove
     under torch.profiler.
 13. the operator's surface on the card (after phase 12, on phase 5's
     chain and witness; operator_phase): (a) `python -m
     blobstreamx_tpu_torch prove-skip` at config 5's Ed tier with
     --checkpoint-dir, --metrics, --out and --claims-out, SIGKILLed once
     its consensus and trace checkpoints exist (in the Ed STARK), then run
     again: it must exit 0, note "consensus+trace resumed from checkpoint",
     write phase 12's proof bytes (SHA-256) and a metrics timing record,
     and `verify-skip --claims` must say "ok": true; (b) prove_skip in
     this process from the CLI's directory: every phase resumed, no kernel
     launched, the same bytes; then, with the main STARK's checkpoint
     deleted, run_with_retry with a fault injected into the first main
     STARK: the retry proves only the SkipAir STARK, the same bytes, and a
     heartbeat file with start, heartbeat and stop records; (c)
     prove_pipelined over three default-tier witnesses of one chain at
     config 5's width, then the same proves serially: equal bytes in
     order, both walls; (d) `prove-step --validators 32 --profile-dir T`
     through the CLI writes a non-empty Chrome trace (verify-skip of (a)
     runs beside it). Each part's wall, the checkpoint directory's bytes,
     the card's name and power limit. One JSON line {"operator": {...}}.
 11. every (n, columns, direction) that the NTT kernels were launched at in
     phases 4-10, 12 and 13 and phase 3 did not check (recorded at the
     kernel's wrapper while the paths ran), held against the plain version
     on seeded inputs: mismatches must be 0.

Each phase prints its wall time. Each path has its own list of kernels that
must launch. Before the last line come {"config5": ...}, {"config4": ...},
{"config5_sha": ...}, {"step": ...}, {"config5_full": ...},
{"config5_ed": ...}, {"operator": ...} and {"kernels": [...]}, where each
kernel's "launches" is from the warm run of its own path ("path") and
"launches_by_path" has all seven (the step path's from the 256-validator
warm prove; "operator" counts phase 13's in-process proves, (b) and (c));
the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Bounds: the least time the card could take, the larger of the bytes moved
(each input read once, each output written once) over 3.35 TB/s and the
counted operations over 67 T/s (the H100 SXM data-sheet HBM rate and its
float32 rate outside the tensor cores, used here for 32-bit integer
operations). Only multiplies are counted: one 32x32->64 multiply is 2
operations (like an FMA's 2 flops), so a 64x64->128 product is 16. Shifts,
adds and compares are not counted, so the bound is a floor.
"""

from __future__ import annotations

import dataclasses
import hashlib
from contextlib import contextmanager
import json
from pathlib import Path
import shutil
import subprocess
import sys
import time

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
PROD64_OPS = 16  # one 64x64->128-bit product
GL_MUL_OPS = PROD64_OPS  # Goldilocks mulmod: one product, reduction by shifts/adds
FE_MUL_OPS = 20 * PROD64_OPS  # GF(2^255-19) mul: 16 schoolbook products + 4 by 38
POW22523_MULS = 262  # field multiplies of the pow22523 chain
EDWARDS_ADD_MULS = 9

CONFIG5 = dict(seed=7, n_headers=1024, n_validators=32, trusted=1, target=1024)
CONFIG4 = dict(seed=0, log_n=22, fold_beta=0x123456789ABCDEF, iters=16)
# phase 10: config 5's chain generator and validator width, cut in depth to 192 headers
CONFIG5_FULL = dict(seed=7, n_headers=192, n_validators=32, trusted=1, target=192, shard_blocks=(4096, 512))
STEP_WIDE = dict(seed=7, n_headers=2, n_validators=256, prev_height=1)  # config 3's 256 signatures
PATH_KERNELS = {
    "config5": ("ntt", "poseidon", "edwards_add", "pow_chain"),
    "config4": ("ntt", "twiddle_transpose", "poseidon"),
    "config5_sha": ("ntt", "ntt_multi", "poseidon", "edwards_add", "pow_chain"),
    "step": ("ntt", "poseidon", "edwards_add", "pow_chain"),
    "config5_full": ("ntt", "ntt_multi", "poseidon", "edwards_add", "pow_chain"),
    "config5_ed": ("ntt", "ntt_multi", "poseidon", "edwards_add", "pow_chain"),
    # phase 13's in-process part: the retried SkipAir STARK and the pipelined default-tier proves
    "operator": ("ntt", "poseidon", "edwards_add", "pow_chain"),
}
# phase 13: the CLI's prove-skip at config 5's Ed tier (the chain of phase 5), and three pipelined
# default-tier proves at config 5's width, on one chain signed at each target
OPERATOR_CLI = ["prove-skip", "--headers", "1024", "--validators", "32", "--trusted", "1", "--target", "1024",
                "--seed", "7", "--ed-stark"]
PIPELINED = dict(seed=7, n_headers=1024, n_validators=32, trusted=1, targets=(1022, 1023, 1024))
# the small chains of phase 4 and tests/test_pipeline.py (seed 11, 12 headers, 4 validators) and of
# tests/test_torch_full_tier.py's slow test (seed 11, 3 headers, 1 validator), with their configs
SMALL_CHAIN = dict(seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75, sign_heights={10})
SMALL_CFG = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=4, final_poly_len=4)
TINY_CHAIN = dict(seed=11, n_headers=3, n_validators=1, sign_heights={2})
TINY_CFG = dict(rate_bits=2, cap_height=1, num_query_rounds=4, proof_of_work_bits=4, final_poly_len=4)
# SHA-256 of the tiny chain's full-tier proof (trusted 1 -> target 2) under TINY_CFG: the CPU's bytes,
# which the JAX package's verifier accepts (tests/test_torch_full_tier.py, slow)
TINY_FULL_PROOF_SHA256 = "bb54aad55410b55b278f68687e54041f092ef87be1a35d9ec14ab5d172dec522"
# SHA-256 of the tiny chain's Ed25519-tier proof (trusted 1 -> target 2, one signature: a 4-segment Ed
# STARK) under TINY_CFG: the CPU's bytes, which the JAX package's verifier accepts
# (tests/test_torch_ed_tier.py, slow)
TINY_ED_PROOF_SHA256 = "d43cd486407439988a3c28cc613130092ffee5173bafd1dbd262ff506d4f24ff"
ED_SEGMENTS = 128  # config 5: 32 signatures, 2 * 32 + 1 scalar multiplications, padded
CUTOVER_FIT_ROWS = (1 << 12, 1 << 13, 1 << 14)  # Sha256Air traces through stark.prove
CUTOVER_MEMORY_SHARE = 0.85  # of the card's memory, the most the fit may predict at the cutover


def log(*a):
    print(*a, flush=True)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def dev_us(e) -> float:
    """A profiler event's own device time in microseconds (the attribute's
    name differs between torch versions)."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)


def ntt_launches(fn, tries: int = 5) -> tuple[int, float | None]:
    """The kernels one call of `fn` launches through the NTT library (its
    own count), and their device time in ms under torch.profiler: taken
    again when the profile recorded fewer kernels than were launched, None
    if none of `tries` recorded them all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blobstreamx_tpu_torch import kernels

    lib = kernels.load("ntt")
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        before = lib.bsx_ntt_launch_count()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launched = lib.bsx_ntt_launch_count() - before
        rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.key.startswith("ntt_")]
        if sum(e.count for e in rows) == launched:
            return launched, sum(dev_us(e) for e in rows) / 1e3
    return launched, None


def max_abs(a, b) -> float:
    return float((a - b).abs().max().item()) if a.numel() else 0.0


def gl_mismatch(k, p) -> tuple[int, float]:
    """Elements where two Gl pairs differ, and the largest word difference."""
    mism = int(((k[0] != p[0]) | (k[1] != p[1])).sum().item())
    return mism, max(max_abs(k[0], p[0]), max_abs(k[1], p[1]))


# ----------------------------------------------------------------------------
# seeded inputs
# ----------------------------------------------------------------------------


def gl_values(rng, shape):
    """Canonical Goldilocks values with the edge cases first."""
    import numpy as np

    from blobstreamx_tpu_torch.fields.gf64 import P

    v = rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2)
    v = (v + rng.integers(0, 2, size=shape, dtype=np.uint64)) % np.uint64(P)
    edges = [0, 1, 2, P - 1, P - 2, P - (1 << 32), (1 << 32) - 1, 1 << 32, (1 << 32) + 1, (1 << 63) + 5]
    flat = v.reshape(-1)
    flat[: min(len(edges), flat.size)] = edges[: flat.size]
    return v


def fe_values(rng, n):
    """GF(2^255-19) inputs < 2^256 (semi-reduced allowed), edge cases first."""
    from blobstreamx_tpu_torch.fields.gf25519 import Q

    edges = [0, 1, 2, Q - 1, Q, Q + 1, 2 * Q - 1, (1 << 256) - 1, (1 << 255) - 20, 1 << 128]
    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    vals[: min(len(edges), n)] = edges[:n]
    return vals


def curve_lanes(rng, n):
    """(p, q) extended-coordinate point lanes as python ints: random points
    with random projective scale, and in every 16 lanes the edge lanes
    beside them: a doubling (q = p), an identity operand, p + (-p), a point
    of order 2 and one of order 4 added to itself; coordinates stored
    semi-reduced (value + p) at random where that stays < 2^256."""
    from blobstreamx_tpu_torch.golden import ed25519 as ged

    Q = ged.Q
    base = [ged.point_mul(int.from_bytes(rng.bytes(32), "little") % ged.L, ged.BASE) for _ in range(64)]
    order2, order4 = (0, Q - 1, 1, 0), (pow(2, (Q - 1) // 4, Q), 0, 1, 0)

    def scaled(pt, lam):
        return tuple(c * lam % Q for c in pt)

    def lift(pt):
        return tuple(c + Q if c + Q < (1 << 256) and rng.integers(0, 2) else c for c in pt)

    ps, qs = [], []
    for j in range(n):
        p = scaled(base[j % 64], int(rng.integers(1, 1 << 62)))
        lam = int(rng.integers(1, 1 << 62))
        if j % 16 == 0:
            q = p
        elif j % 16 == 1:
            q = scaled(ged.IDENTITY, lam)
        elif j % 16 == 2:
            q = scaled((Q - p[0], p[1], p[2], Q - p[3]), lam)
        elif j % 16 == 3:
            q = scaled(order2, lam)
        elif j % 16 == 4:
            p, q = scaled(order4, lam), order4
        else:
            q = scaled(base[(7 * j + 3) % 64], lam)
        ps.append(lift(p))
        qs.append(lift(q))
    return ps, qs


# ----------------------------------------------------------------------------
# phase 3: kernel checks
# ----------------------------------------------------------------------------


def check_ntt(rng, dev):
    """The tile kernel (columns of at most 2^14)."""
    return _ntt_cases(rng, dev, [
        ((32, 8), True, "trace INTT"),
        ((256, 8), False, "trace LDE"),
        ((256, 2), True, "quotient coset INTT"),
        ((2048, 2048), False, "four-step pass at 2^22"),
        ((2048, 2048), True, "four-step inverse pass at 2^22"),
        ((8, 1), True, "FRI final-poly coset INTT"),
        ((1024, 2048), False, "odd-log four-step first pass at 2^21"),
        ((2048, 1024), True, "odd-log four-step inverse second pass at 2^21"),
        ((2048, 2050), False, "ragged last column tile"),
        ((1 << 14, 3), True, "one-column tiles at the largest shared-memory n"),
        ((1, 4), False, "n = 1"),
        ((256, 4), True, "StepAir trace INTT (phase 9)"),
        ((2048, 4), False, "StepAir trace LDE (phase 9)"),
    ])


def check_ntt_multi(rng, dev):
    """The long-column path (columns longer than 2^14, a launch a pass of
    shared-memory stages) at the SHA tier's shapes (column chunks of 32 at
    2^18 rows, rate_bits 3), at the full tier's 512-block shard (column
    chunks of 128 at 2^15 rows) and at the edges of its design."""
    return _ntt_cases(rng, dev, [
        ((1 << 21, 32), False, "SHA trace chunk LDE"),
        ((1 << 18, 32), True, "SHA trace chunk INTT"),
        ((1 << 18, 20), True, "SHA last (ragged) trace chunk INTT"),
        ((1 << 21, 2), True, "SHA quotient coset INTT"),
        ((1 << 21, 16), False, "SHA quotient LDE"),
        ((1 << 15, 128), True, "full tier's 512-block shard: trace chunk INTT"),
        ((1 << 18, 128), False, "full tier's 512-block shard: trace chunk LDE"),
        ((1 << 15, 20), True, "full tier's 512-block shard: last (ragged) trace chunk INTT"),
        ((1 << 18, 20), False, "full tier's 512-block shard: last (ragged) trace chunk LDE"),
        ((1 << 16, 8), False, "long-column path at 2^16"),
        ((1 << 15, 1), False, "smallest long column, one-column tile"),
        ((1 << 15, 3), True, "smallest long column, ragged column tile"),
        ((1 << 17, 5), False, "uneven split (9 + 8), ragged column tile"),
        ((1 << 22, 8), False, "largest two-pass column"),
        ((1 << 23, 4), False, "three passes"),
        ((1 << 16, 128), True, "Ed STARK (phase 12): trace chunk INTT"),
        ((1 << 19, 128), False, "Ed STARK (phase 12): trace chunk LDE"),
        ((1 << 19, 2), True, "Ed STARK (phase 12): quotient coset INTT"),
        ((1 << 19, 16), False, "Ed STARK (phase 12): quotient LDE"),
    ], long_path=True)


def _ntt_cases(rng, dev, cases, long_path=False):
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt

    rows = []
    for (n, c), inverse, what in cases:
        x = gf64.from_u64(gl_values(rng, (n, c)), dev)
        mism, err = gl_mismatch(ntt._ntt_cols_cuda(x, inverse), ntt.ntt_cols_plain(x, inverse))
        reps = 20 if n * c <= 1 << 16 else 5
        ms = time_ms(lambda: ntt._ntt_cols_cuda(x, inverse), reps)
        plain_ms = time_ms(lambda: ntt.ntt_cols_plain(x, inverse), 3) if n * c <= 1 << 23 else time_ms(
            lambda: ntt.ntt_cols_plain(x, inverse), 1, warm=1)
        launches, dev_ms = ntt_launches(lambda: ntt._ntt_cols_cuda(x, inverse))
        log_n = n.bit_length() - 1
        muls = (n // 2) * log_n * c + (n * c if inverse else 0)
        b, by = bound(32 * n * c + 8 * (n // 2), muls * GL_MUL_OPS)
        log(f"  ntt ({n}, {c}) {'inverse' if inverse else 'forward'} [{what}]: mismatches {mism}, "
            f"kernel {ms:.4f} ms, device {dev_ms} ms in {launches} launches, plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms ({by})")
        assert mism == 0, f"ntt kernel disagrees with the plain version at ({n}, {c})"
        if long_path:
            most = 2 if n <= 1 << 22 else 3
            assert 2 <= launches <= most, f"the long-column path took {launches} launches at ({n}, {c})"
        rows.append(dict(shape=f"({n}, {c}) {'inverse' if inverse else 'forward'}", max_abs_err=err,
                         ms=ms, device_ms=dev_ms, launches_per_call=launches, plain_ms=plain_ms, bound_ms=b,
                         bound_by=by))
        del x
    return rows


@contextmanager
def recorded_ntt_shapes(seen: set):
    """Add the (n, columns, inverse) of every NTT kernel launch made inside
    the block to `seen`: the shapes the main paths gave the kernel."""
    from blobstreamx_tpu_torch.ops import ntt

    launch = ntt._ntt_cols_cuda

    def recording(x, inverse):
        seen.add((*x[0].shape, bool(inverse)))
        return launch(x, inverse)

    ntt._ntt_cols_cuda = recording
    try:
        yield seen
    finally:
        ntt._ntt_cols_cuda = launch


def check_recorded_ntt(rng, seen: set, rows: dict) -> int:
    """Phase 11: the NTT kernel against its plain version at every shape in
    `seen` that phase 3 did not check, on seeded inputs (mismatches must be
    0). Each result joins the rows of the tile ("ntt") or the long-column
    ("ntt_multi") kernel. Returns the number of shapes checked."""
    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt

    checked = {r["shape"] for name in ("ntt", "ntt_multi") for r in rows[name]}
    todo = [(n, c, inv) for n, c, inv in sorted(seen)
            if f"({n}, {c}) {'inverse' if inv else 'forward'}" not in checked]
    for n, c, inverse in todo:
        x = gf64.from_u64(gl_values(rng, (n, c)), "cuda")
        mism, err = gl_mismatch(ntt._ntt_cols_cuda(x, inverse), ntt.ntt_cols_plain(x, inverse))
        shape = f"({n}, {c}) {'inverse' if inverse else 'forward'}"
        log(f"  ntt {shape}: mismatches {mism}")
        assert mism == 0, f"ntt kernel disagrees with the plain version at a main path's shape {shape}"
        name = "ntt" if n <= kernels.load("ntt").bsx_ntt_smem_max_n() else "ntt_multi"
        rows[name].append(dict(shape=shape, max_abs_err=err, checked_in="phase 11"))
        del x
    log(f"  {len(seen)} shapes launched by the main paths, {len(todo)} of them not in phase 3, all equal")
    return len(todo)


def check_poseidon(rng, dev):
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import poseidon as pos

    rows = []
    # config 5's grind batch, two ragged batches (not a multiple of the block);
    # config 4's first FRI leaf hashes and its first compression
    for n in (16384, 16383, 1, 1 << 21, 1 << 20):
        s = gf64.from_u64(gl_values(rng, (12, n)), dev)
        mism, err = gl_mismatch(pos._permute_cuda(s), pos.permute_plain(s))
        ms = time_ms(lambda: pos._permute_cuda(s), 20)
        plain_ms = time_ms(lambda: pos.permute_plain(s), 3) if n <= 16384 else time_ms(
            lambda: pos.permute_plain(s), 1, warm=1)
        muls = (8 * 12 + 22) * 4
        b, by = bound(2 * 12 * 16 * n, n * muls * GL_MUL_OPS)
        log(f"  poseidon (12, {n}): mismatches {mism}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms ({by})")
        assert mism == 0, f"poseidon kernel disagrees with the plain version at (12, {n})"
        rows.append(dict(shape=f"(12, {n})", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
                         bound_by=by))
        del s
    return rows


def check_twiddle_transpose(rng, dev):
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt

    rows = []
    for n1, n2 in ((2048, 2048), (1024, 2048), (1, 2)):
        n = n1 * n2
        log_n = n.bit_length() - 1
        m = gf64.from_u64(gl_values(rng, (n1, n2)), dev)
        for inverse in (False, True):
            mism, err = gl_mismatch(ntt._twiddle_transpose_cuda(m, log_n, inverse),
                                    ntt.twiddle_transpose_plain(m, log_n, inverse))
            ms = time_ms(lambda: ntt._twiddle_transpose_cuda(m, log_n, inverse), 20)
            plain_ms = time_ms(lambda: ntt.twiddle_transpose_plain(m, log_n, inverse), 5)
            # the bare transpose copy, no multiply: a yardstick, not the same function
            copy_ms = time_ms(lambda: (m[0].t().contiguous(), m[1].t().contiguous()), 20)
            # the function's own bytes; the twiddle-table reads are this design's cost, not counted
            b, by = bound(32 * n, n * GL_MUL_OPS)
            shape = f"({n1}, {n2}) {'inverse' if inverse else 'forward'}"
            log(f"  twiddle_transpose {shape}: mismatches {mism}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"transpose copy {copy_ms:.4f} ms, bound {b:.6f} ms ({by})")
            assert mism == 0, f"twiddle-transpose kernel disagrees with the plain version at {shape}"
            rows.append(dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                             transpose_copy_ms=copy_ms))
    return rows


def _fe_tensor(vals, dev):
    from blobstreamx_tpu_torch.fields import gf25519 as f

    return f.from_int(vals, dev)


def _field_mismatch(kernel_out, plain_out):
    """Lanes where the kernel's canonical limbs differ from the canonical
    value of the plain version, or are not canonical themselves."""
    from blobstreamx_tpu_torch.fields import gf25519 as f

    want = f.canonicalize(plain_out)
    bad = (kernel_out != want).any(dim=0) | (kernel_out != f.canonicalize(kernel_out)).any(dim=0)
    return int(bad.sum().item()), max_abs(kernel_out, want)


def launch_floor_ms() -> float:
    """One empty kernel launched through the ed25519 library's C interface:
    the yardstick beside the Ed25519 kernels' times (not a bound)."""
    import torch

    from blobstreamx_tpu_torch import kernels

    lib, stream = kernels.load("ed25519"), torch.cuda.current_stream().cuda_stream
    return time_ms(lambda: kernels.check(lib.bsx_launch_floor(stream), "launch floor"), 100)


def check_edwards_add(rng, dev):
    from blobstreamx_tpu_torch.ops import curve25519 as curve

    rows = []
    # config 5's lane counts: the last fold (64), the suffix scan (1024), the
    # bucket accumulation (4096) and the largest fold (32768)
    for n in (64, 1024, 4096, 32768):
        ps, qs = curve_lanes(rng, n)
        p = tuple(_fe_tensor([pt[i] for pt in ps], dev) for i in range(4))
        q = tuple(_fe_tensor([pt[i] for pt in qs], dev) for i in range(4))
        k = curve._add_cuda(p, q)
        pl = curve.add(p, q)
        mism, err = 0, 0.0
        for kc, pc in zip(k, pl):
            m, e = _field_mismatch(kc, pc)
            mism, err = mism + m, max(err, e)
        ms = time_ms(lambda: curve._add_cuda(p, q), 20)
        plain_ms = time_ms(lambda: curve.add(p, q), 3)
        b, by = bound(12 * 16 * 8 * n, n * EDWARDS_ADD_MULS * FE_MUL_OPS)
        log(f"  edwards add ({n} lanes): mismatches {mism}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms ({by})")
        assert mism == 0, f"edwards-add kernel disagrees with the plain version at {n} lanes"
        rows.append(dict(shape=f"{n} lanes", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by))
    return rows


def check_pow_chain(rng, dev):
    from blobstreamx_tpu_torch.fields import gf25519 as f

    rows = []
    for n in (64, 4096):
        a = _fe_tensor(fe_values(rng, n), dev)
        mism, err = _field_mismatch(f._chain_cuda(a, None), f.pow22523_plain(a))
        ms = time_ms(lambda: f._chain_cuda(a, None), 20)
        plain_ms = time_ms(lambda: f.pow22523_plain(a), 2)
        b, by = bound(2 * 16 * 8 * n, n * POW22523_MULS * FE_MUL_OPS)
        log(f"  pow22523 ({n} lanes): mismatches {mism}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms ({by})")
        assert mism == 0, f"pow22523 kernel disagrees with the plain version at {n} lanes"
        rows.append(dict(shape=f"pow22523, {n} lanes", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by))
    a = _fe_tensor(fe_values(rng, 64), dev)
    for k in (1, 5, 50):
        mism, err = _field_mismatch(f._chain_cuda(a, k), f.sqn_plain(a, k))
        ms = time_ms(lambda: f._chain_cuda(a, k), 20)
        plain_ms = time_ms(lambda: f.sqn_plain(a, k), 3)
        b, by = bound(2 * 16 * 8 * 64, 64 * k * FE_MUL_OPS)
        log(f"  sqn k={k} (64 lanes): mismatches {mism}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b:.6f} ms ({by})")
        assert mism == 0, f"sqn kernel disagrees with the plain version at k={k}"
        rows.append(dict(shape=f"sqn k={k}, 64 lanes", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b, bound_by=by))
    return rows


KERNELS = [
    dict(name="ntt", counter="ntt", source="blobstreamx_tpu_torch/csrc/ntt.cu",
         replaces="blobstreamx_tpu/ops/ntt.py:332", also_replaces="blobstreamx_tpu/ops/ntt.py:248",
         path="config4", main_shape="(2048, 2048) forward", check=check_ntt),
    dict(name="ntt_multi", counter="ntt_multi", source="blobstreamx_tpu_torch/csrc/ntt.cu",
         replaces="blobstreamx_tpu/ops/ntt.py:332", also_replaces="blobstreamx_tpu/ops/ntt.py:248",
         path="config5_sha", main_shape="(2097152, 32) forward", check=check_ntt_multi),
    dict(name="twiddle_transpose", counter="twiddle_transpose", source="blobstreamx_tpu_torch/csrc/ntt.cu",
         replaces="blobstreamx_tpu/ops/ntt.py:374", also_replaces="blobstreamx_tpu/ops/ntt.py:289",
         path="config4", main_shape="(2048, 2048) forward", check=check_twiddle_transpose),
    dict(name="poseidon", counter="poseidon", source="blobstreamx_tpu_torch/csrc/poseidon.cu",
         replaces="blobstreamx_tpu/ops/poseidon.py:188", path="config5", main_shape="(12, 16384)",
         check=check_poseidon),
    dict(name="edwards_add", counter="edwards_add", source="blobstreamx_tpu_torch/csrc/ed25519.cu",
         replaces="blobstreamx_tpu/ops/curve25519.py:135", path="config5", main_shape="4096 lanes",
         check=check_edwards_add),
    dict(name="pow_chain", counter="pow_chain", source="blobstreamx_tpu_torch/csrc/ed25519.cu",
         replaces="blobstreamx_tpu/fields/gf25519.py:333", also_replaces="blobstreamx_tpu/fields/gf25519.py:267",
         path="config5", main_shape="pow22523, 64 lanes", check=check_pow_chain),
]


# ----------------------------------------------------------------------------
# phases 4, 5 and 7: the main paths
# ----------------------------------------------------------------------------


def small_chain_card_vs_cpu():
    from blobstreamx_tpu_torch.circuits import fixtures as fx, step, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.config import StarkConfig
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes, step_proof_to_bytes

    cfg = StarkConfig(**SMALL_CFG)
    chain = fx.generate_chain(**SMALL_CHAIN)
    w = wit.build_skip_witness(chain, trusted_height=2, target_height=10)
    ws = step.build_step_witness(chain, prev_height=9)
    for what, prove, to_bytes in (
        ("skip 2 -> 10", lambda dev: pipeline.prove_skip(w, cfg, device=dev), skip_proof_to_bytes),
        ("step 9 -> 10", lambda dev: pipeline.prove_step(ws, cfg, device=dev), step_proof_to_bytes),
    ):
        t0 = time.perf_counter()
        on_card = to_bytes(prove("cuda"))
        t1 = time.perf_counter()
        on_cpu = to_bytes(prove("cpu"))
        t2 = time.perf_counter()
        same = on_card == on_cpu
        log(f"  small chain (seed 11, 12 headers, 4 validators), {what}: card {t1 - t0:.3f} s, "
            f"cpu {t2 - t1:.3f} s, {len(on_card)} proof bytes, card bytes == cpu bytes: {same}")
        assert same, f"card proof bytes differ from the CPU proof bytes ({what})"

    tiny = wit.build_skip_witness(fx.generate_chain(**TINY_CHAIN), trusted_height=1, target_height=2)
    t0 = time.perf_counter()
    blob = skip_proof_to_bytes(pipeline.prove_skip(tiny, StarkConfig(**TINY_CFG), device="cuda",
                                                   with_sha_stark="full"))
    digest = hashlib.sha256(blob).hexdigest()
    log(f"  tiny chain (seed 11, 3 headers, 1 validator, 1 -> 2) at the full tier: card "
        f"{time.perf_counter() - t0:.3f} s, {len(blob)} proof bytes, SHA-256 {digest}")
    assert digest == TINY_FULL_PROOF_SHA256, "the card's full-tier proof differs from the CPU's (its SHA-256)"

    t0 = time.perf_counter()
    blob = skip_proof_to_bytes(pipeline.prove_skip(tiny, StarkConfig(**TINY_CFG), device="cuda",
                                                   with_ed_stark=True))
    digest = hashlib.sha256(blob).hexdigest()
    log(f"  tiny chain at the Ed25519 tier: card {time.perf_counter() - t0:.3f} s, {len(blob)} proof bytes, "
        f"SHA-256 {digest}")
    assert digest == TINY_ED_PROOF_SHA256, "the card's Ed-tier proof differs from the CPU's (its SHA-256)"


def warm_run(prove):
    """One warm run of a prove on the card: (result, wall s, kernel
    launches, peak device memory, what was resident before it)."""
    import torch

    from blobstreamx_tpu_torch import kernels

    kernels.reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = prove()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, dict(kernels.launches), torch.cuda.max_memory_allocated(), resident


def config5():
    import torch

    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes

    c = CONFIG5
    t0 = time.perf_counter()
    chain = fx.generate_chain(seed=c["seed"], n_headers=c["n_headers"], n_validators=c["n_validators"],
                              sign_heights={c["target"]})
    w = wit.build_skip_witness(chain, trusted_height=c["trusted"], target_height=c["target"])
    log(f"  witness (host): {time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    cold = pipeline.prove_skip(w, device="cuda")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    log(f"  cold prove_skip: {cold_s:.3f} s")

    warm, warm_s, launches, peak, resident = warm_run(lambda: pipeline.prove_skip(w, device="cuda"))
    log(f"  warm prove_skip: {warm_s:.3f} s")
    log("  warm TimingTree:\n" + "\n".join("    " + line for line in warm.timing.splitlines()))
    log(f"  kernel launches in the warm prove: {json.dumps(launches)}")
    log(f"  peak device memory in the warm prove: {peak} bytes ({resident} resident before it)")
    missing = [k for k in PATH_KERNELS["config5"] if launches[k] == 0]
    assert not missing, f"kernels of the config-5 path were not launched: {missing} ({launches})"
    assert skip_proof_to_bytes(warm) == skip_proof_to_bytes(cold), "warm and cold proofs differ"

    t0 = time.perf_counter()
    ok = pipeline.verify_skip_proof(warm)
    log(f"  verify_skip_proof: {ok} ({time.perf_counter() - t0:.3f} s)")
    assert ok, "the port's verifier rejected the config-5 proof"
    pub = list(warm.publics)
    pub[0] -= 1  # still above 2/3 of the total: only the STARK can catch it
    tampered = pipeline.verify_skip_proof(dataclasses.replace(warm, publics=pub))
    log(f"  tampered publics[0] accepted: {tampered}")
    assert not tampered, "a tampered proof was accepted"
    return launches, cold_s, warm_s, w, chain


def config4_inputs(seed: int, log_n: int, log_coeffs: int):
    """The 2^log_n vector of benches/configs.py's config4 and the
    2^log_coeffs coefficients of a low-degree codeword, from numpy, on the card."""
    import numpy as np

    from blobstreamx_tpu_torch.fields import gf64

    rng = np.random.default_rng(seed)
    x = gf64.from_u64(rng.integers(0, gf64.P, size=(1 << log_n,), dtype=np.uint64), "cuda")
    coeffs = gf64.from_u64(rng.integers(0, gf64.P, size=(1 << log_coeffs, 1), dtype=np.uint64), "cuda")
    return x, coeffs


def config4_path(x, coeffs, cfg, shift: int):
    """The config-4 path once: the four-step NTT of x and its inverse, the
    low-degree codeword of `coeffs` (zero-padded to len(x), coset_scale,
    four-step) and its FRI proof. Returns (forward, inverse of forward,
    codeword, proof, fri_prove wall in s)."""
    import torch

    from blobstreamx_tpu_torch.golden.challenger import Challenger
    from blobstreamx_tpu_torch.ops import fri, ntt

    n = x[0].shape[0]
    y = ntt.ntt_four_step(x)
    back = ntt.ntt_four_step(y, inverse=True)
    pad = torch.zeros((n - coeffs[0].shape[0], 1), dtype=torch.int64, device=x[0].device)
    col = ntt.coset_scale((torch.cat([coeffs[0], pad]), torch.cat([coeffs[1], pad])), shift)
    cw = ntt.ntt_four_step((col[0][:, 0], col[1][:, 0]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proof = fri.fri_prove(cw, cfg, Challenger(), shift)
    torch.cuda.synchronize()
    return y, back, cw, proof, time.perf_counter() - t0


def config4_checks(x, coeffs, y, back, cw, proof, cfg, shift: int) -> dict:
    """Each check of the config-4 outputs: the mismatch counts (each must be
    0), whether fri_verify accepts the proof (must) and rejects it with one
    query pair changed (must), and the verifier's time."""
    import copy

    from blobstreamx_tpu_torch.fields.gf64 import P
    from blobstreamx_tpu_torch.golden.challenger import Challenger
    from blobstreamx_tpu_torch.golden.fri import fri_verify
    from blobstreamx_tpu_torch.ops import ntt

    def col(v):
        return v[0][:, None], v[1][:, None]

    out = {"mismatches": {
        "forward_vs_plain": gl_mismatch(y, ntt.ntt_four_step_plain(x))[0],
        "inverse_vs_plain": gl_mismatch(back, ntt.ntt_four_step_plain(y, inverse=True))[0],
        "forward_vs_ntt_cols_column": gl_mismatch(col(y), ntt.ntt_cols(col(x)))[0],
        "inverse_vs_ntt_cols_column": gl_mismatch(col(back), ntt.ntt_cols(col(y), inverse=True))[0],
        "roundtrip_vs_input": gl_mismatch(back, x)[0],
        "codeword_vs_lde_cols": gl_mismatch(col(cw), ntt.lde_cols(coeffs, cfg.rate_bits, shift))[0],
    }}
    t0 = time.perf_counter()
    out["fri_verify_accepts"] = fri_verify(proof, x[0].shape[0], cfg, Challenger(), shift)
    out["fri_verify_s"] = time.perf_counter() - t0
    bad = copy.deepcopy(proof)
    fe, fo = bad.query_rounds[0].layers[0].pair
    bad.query_rounds[0].layers[0].pair = ((fe + 1) % P, fo)
    out["fri_verify_rejects_tampered"] = not fri_verify(bad, x[0].shape[0], cfg, Challenger(), shift)
    return out


def odd_log_four_step(seed: int, log_n: int, iters: int) -> dict:
    """The four-step at an odd log n, whose two passes have different shapes
    ((n1, n2) then (n2, n1)): forward and inverse against the plain version
    and the roundtrip against the input (mismatches, each must be 0), and
    the forward's CUDA-event time."""
    import numpy as np

    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt

    rng = np.random.default_rng(seed)
    x = gf64.from_u64(rng.integers(0, gf64.P, size=(1 << log_n,), dtype=np.uint64), "cuda")
    y = ntt.ntt_four_step(x)
    back = ntt.ntt_four_step(y, inverse=True)
    out = {"log_n": log_n, "mismatches": {
        "forward_vs_plain": gl_mismatch(y, ntt.ntt_four_step_plain(x))[0],
        "inverse_vs_plain": gl_mismatch(back, ntt.ntt_four_step_plain(y, inverse=True))[0],
        "roundtrip_vs_input": gl_mismatch(back, x)[0],
    }}
    ms = time_ms(lambda: ntt.ntt_four_step(x), iters)
    out.update(ntt_wall_s=ms / 1e3, butterflies_per_s=ntt.butterfly_count(log_n) / (ms / 1e3))
    return out


def config4(smi: str, profile: bool = False):
    """Config 4 on the card: cold and warm runs of the path, launches and
    peak memory of the warm one, the checks, then CUDA-event times; with
    `profile`, one more warm run under torch.profiler."""
    from blobstreamx_tpu_torch.golden import goldilocks as gold
    from blobstreamx_tpu_torch.golden.fri import FriConfig
    from blobstreamx_tpu_torch.ops import fri, ntt

    c = CONFIG4
    cfg, shift = FriConfig(), gold.COSET_SHIFT
    log_n = c["log_n"]
    n = 1 << log_n
    t0 = time.perf_counter()
    x, coeffs = config4_inputs(c["seed"], log_n, log_n - cfg.rate_bits)
    log(f"  inputs (numpy seed {c['seed']}, 2^{log_n} values, 2^{log_n - cfg.rate_bits} coefficients): "
        f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    cold = config4_path(x, coeffs, cfg, shift)
    cold_s = time.perf_counter() - t0
    log(f"  cold path (host tables built here): {cold_s:.3f} s, of which fri_prove {cold[4]:.3f} s")

    (y, back, cw, proof, fri_s), warm_s, launches, peak, resident = warm_run(
        lambda: config4_path(x, coeffs, cfg, shift))
    log(f"  warm path: {warm_s:.3f} s, of which fri_prove {fri_s:.3f} s")
    log(f"  kernel launches in the warm path: {json.dumps(launches)}")
    log(f"  peak device memory in the warm path: {peak} bytes ({resident} resident before it)")
    missing = [k for k in PATH_KERNELS["config4"] if launches[k] == 0]
    assert not missing, f"kernels of the config-4 path were not launched: {missing} ({launches})"
    assert proof == cold[3], "warm and cold FRI proofs differ"

    checks = config4_checks(x, coeffs, y, back, cw, proof, cfg, shift)
    log(f"  checks: {json.dumps(checks)}")
    assert not any(checks["mismatches"].values()), f"config-4 outputs disagree: {checks['mismatches']}"
    assert checks["fri_verify_accepts"], "fri_verify rejected the config-4 proof"
    assert checks["fri_verify_rejects_tampered"], "fri_verify accepted a proof with a changed query pair"
    odd = odd_log_four_step(c["seed"], log_n - 1, c["iters"])
    log(f"  four-step 2^{log_n - 1}: {json.dumps(odd)}")
    assert not any(odd["mismatches"].values()), f"the 2^{log_n - 1} four-step disagrees: {odd['mismatches']}"

    iters = c["iters"]
    ntt_ms = time_ms(lambda: ntt.ntt_four_step(x), iters)
    intt_ms = time_ms(lambda: ntt.ntt_four_step(y, inverse=True), iters)
    plain_ms = time_ms(lambda: ntt.ntt_four_step_plain(x), 3)
    xc = (x[0][:, None], x[1][:, None])
    col_ms = time_ms(lambda: ntt.ntt_cols(xc), iters)
    fold_ms = time_ms(lambda: fri.fold_codeword(cw, c["fold_beta"], shift), iters)
    bf = ntt.butterfly_count(log_n)
    # one read and one write of 32 B per element; multiplies: butterflies + twiddles
    b, by = bound(32 * n, (bf + n) * GL_MUL_OPS)
    col_b, _ = bound(32 * n + 8 * (n // 2), bf * GL_MUL_OPS)  # as check_ntt counts it
    rec = dict(
        log_n=log_n, seed=c["seed"], iters=iters,
        ntt_wall_s=ntt_ms / 1e3, butterflies_per_s=bf / (ntt_ms / 1e3),
        intt_wall_s=intt_ms / 1e3, intt_butterflies_per_s=bf / (intt_ms / 1e3),
        ntt_plain_wall_s=plain_ms / 1e3, ntt_cols_column_wall_s=col_ms / 1e3, ntt_cols_column_bound_ms=col_b,
        four_step_bound_ms=b, four_step_bound_by=by, butterflies_per_s_at_bound=bf / (b / 1e3),
        fri_fold_wall_s=fold_ms / 1e3, fri_fold_elems_per_s=(n // 2) / (fold_ms / 1e3),
        fri_prove_wall_s=fri_s, fri_prove_cold_s=cold[4], path_warm_s=warm_s, path_cold_s=cold_s,
        fri_verify_s=checks["fri_verify_s"], fri_config=dataclasses.asdict(cfg),
        launches=launches, peak_device_bytes=peak, resident_before_bytes=resident, card=smi,
        odd_log_four_step=odd,
    )
    log(f"  four-step 2^{log_n}: forward {ntt_ms:.4f} ms ({rec['butterflies_per_s']:.4e} butterflies/s), "
        f"inverse {intt_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by}); ntt_cols of the "
        f"(2^{log_n}, 1) column {col_ms:.4f} ms (bound {col_b:.6f} ms); fold {fold_ms:.4f} ms")
    log(json.dumps({"config4": rec}))
    if profile:
        profile_warm("config-4 warm path", lambda: config4_path(x, coeffs, cfg, shift))
    return launches


def cutover_fit(rng) -> dict:
    """stark.prove's peak device memory on Sha256Air traces of
    CUTOVER_FIT_ROWS rows (tuple-tree-shaped: 65-byte messages, two blocks
    each) against estimate_standard_bytes, a least-squares line through
    them, and the peak it predicts at stark_stream.AUTO_STREAM_BYTES."""
    import numpy as np
    import torch

    from blobstreamx_tpu_torch.prover import sha_air, stark, stark_stream
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    cfg = StarkConfig()
    points = []
    for rows in CUTOVER_FIT_ROWS:
        chain, blocks = sha_air.plan_blocks([rng.bytes(65) for _ in range(rows // 128)])
        trace, aux = sha_air.build_sha_trace(chain, blocks)
        air = sha_air.Sha256Air(chain)
        est = stark_stream.estimate_standard_bytes(rows, air.n_cols + air.n_stage2, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        stark.prove(air, trace, [], cfg, aux=aux, device="cuda")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        log(f"  stark.prove Sha256Air {rows} rows: estimate {est} bytes, peak {peak} bytes above "
            f"{base} resident, {time.perf_counter() - t0:.3f} s")
        points.append((est, peak))
        del trace, aux
    x = np.array([p[0] for p in points], np.float64)
    y = np.array([p[1] for p in points], np.float64)
    slope, intercept = np.polyfit(x, y, 1)
    at_cutover = slope * stark_stream.AUTO_STREAM_BYTES + intercept
    total = torch.cuda.get_device_properties(0).total_memory
    fit = dict(rows=list(CUTOVER_FIT_ROWS), points=points, slope=float(slope), intercept=float(intercept),
               cutover_bytes=stark_stream.AUTO_STREAM_BYTES, predicted_peak_at_cutover=float(at_cutover),
               card_memory_bytes=total)
    log(f"  fit: peak = {slope:.4f} x estimate + {intercept:.0f} bytes; at the cutover "
        f"({stark_stream.AUTO_STREAM_BYTES} bytes) {at_cutover:.0f} bytes of the card's {total}")
    assert at_cutover < CUTOVER_MEMORY_SHARE * total, "the standard path would not fit below the cutover"
    return fit


def sha_tamper(proof, how: str):
    """One of phase 8's three tampers of a SHA-tier proof."""
    if how == "strip_sha_stark":
        return dataclasses.replace(proof, sha_stark=None)
    if how == "digest_word":
        (w0, out0), *rest = proof.sha_stark.aux
        aux = [(w0, ((out0[0] + 1) & 0xFFFFFFFF,) + tuple(out0[1:]))] + rest
        return dataclasses.replace(proof, sha_stark=dataclasses.replace(proof.sha_stark, aux=aux))
    hashes = list(proof.claims.range_data_hashes)
    hashes[0] = bytes([hashes[0][0] ^ 1]) + hashes[0][1:]
    return dataclasses.replace(proof, claims=dataclasses.replace(proof.claims, range_data_hashes=hashes))


# phase 10's tampers of a full-coverage proof and the verifier's verdict on each: the first three
# change what the claim digest binds, the last two leave the binding intact, so only the claim walk
# (a range data hash off the header chain) or the first shard's own STARK check can reject them
FULL_TAMPERS = {
    "digest_word": "failed: claim digest not bound in transcript",
    "link_field": "failed: claim digest not bound in transcript",
    "strip_sha_stark": "failed: claim digest not bound in transcript",
    "range_data_hash": "failed: full claim walk rejected",
    "shard_stark": "failed: full claim walk rejected",
}
GOLDILOCKS_P = 0xFFFFFFFF00000001


def full_tamper(proof, how: str):
    """One of phase 10's tampers of a full-coverage proof (FULL_TAMPERS):
    one word of a claimed digest in aux changed, one link_fields part-set
    hash changed, the SHA proof stripped, one embedded range data hash
    changed, or the first shard's STARK opening a wrong quotient value at
    zeta."""
    sha = proof.sha_stark
    if how == "link_field":
        (total, psh), *rest = sha.link_fields
        link_fields = [(total, bytes([psh[0] ^ 1]) + psh[1:])] + rest
        return dataclasses.replace(proof, sha_stark=dataclasses.replace(sha, link_fields=link_fields))
    if how == "shard_stark":
        first, *rest = sha.starks
        (a, b), *qz = first.quotient_zeta
        bad = dataclasses.replace(first, quotient_zeta=[((a + 1) % GOLDILOCKS_P, b)] + qz)
        return dataclasses.replace(proof, sha_stark=dataclasses.replace(sha, starks=[bad] + rest))
    return sha_tamper(proof, how)


def config5_sha(w, smi: str, profile: bool):
    """Config 5 at the SHA-256 tier on the card (phase 8)."""
    import numpy as np
    import torch

    from blobstreamx_tpu_torch.prover import pipeline, sha_air, sha_claims, stark_stream
    from blobstreamx_tpu_torch.prover.config import StarkConfig
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes

    fit = cutover_fit(np.random.default_rng(5))

    def prove():
        return pipeline.prove_skip(w, device="cuda", with_sha_stark=True)

    t0 = time.perf_counter()
    cold = prove()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    log(f"  cold prove_skip(with_sha_stark=True): {cold_s:.3f} s")

    warm, warm_s, launches, peak, resident = warm_run(prove)
    total = torch.cuda.get_device_properties(0).total_memory
    sha = warm.sha_stark
    air = sha_air.Sha256Air(sha_claims._expected_chain(len(w.range_heights)))
    path = "streaming" if stark_stream.uses_streaming(air, sha.n_rows, StarkConfig()) else "standard"
    log(f"  warm prove_skip(with_sha_stark=True): {warm_s:.3f} s")
    log("  warm TimingTree:\n" + "\n".join("    " + line for line in warm.timing.splitlines()))
    log(f"  SHA STARK: {len(sha.aux)} blocks, {sha.n_rows} x {air.n_cols} trace, prover path {path}")
    log(f"  kernel launches in the warm prove: {json.dumps(launches)}")
    log(f"  peak device memory in the warm prove: {peak} bytes ({resident} resident before it; the card has {total})")
    assert path == "streaming", "prove_auto did not take the streaming path at config 5's SHA tier"
    missing = [k for k in PATH_KERNELS["config5_sha"] if launches[k] == 0]
    assert not missing, f"kernels of the SHA-tier path were not launched: {missing} ({launches})"
    assert peak < total, "peak device memory above the card's"
    blob = skip_proof_to_bytes(warm)
    digest = hashlib.sha256(blob).hexdigest()
    log(f"  warm proof: {len(blob)} bytes, SHA-256 {digest}")
    assert blob == skip_proof_to_bytes(cold), "warm and cold SHA-tier proofs differ"
    del cold, blob

    t0 = time.perf_counter()
    ok, detail = pipeline.verify_skip_proof_detailed(warm)
    verify_s = time.perf_counter() - t0
    log(f"  verify_skip_proof_detailed: {ok} {json.dumps(detail)} ({verify_s:.3f} s)")
    assert ok and detail["sha_stark"] == "ok: tuple tree", "the port's verifier rejected the SHA-tier proof"
    tampers = {}
    for how in ("digest_word", "strip_sha_stark", "range_data_hash"):
        t0 = time.perf_counter()
        ok_t, detail_t = pipeline.verify_skip_proof_detailed(sha_tamper(warm, how))
        tampers[how] = detail_t.get("sha_stark")
        log(f"  tamper {how}: accepted {ok_t}, {detail_t.get('sha_stark')} ({time.perf_counter() - t0:.3f} s)")
        assert not ok_t, f"a SHA-tier proof with tamper {how} was accepted"
    rec = dict(
        cold_s=cold_s, warm_s=warm_s, verify_s=verify_s, launches=launches, peak_device_bytes=peak,
        resident_before_bytes=resident, card_memory_bytes=total, prover_path=path, sha_blocks=len(sha.aux),
        sha_rows=sha.n_rows, sha_cols=air.n_cols, leaves=len(w.range_heights), tampers_rejected=tampers,
        proof_sha256=digest, cutover_fit=fit, card=smi,
    )
    log(json.dumps({"config5_sha": rec}))
    if profile:
        from blobstreamx_tpu_torch.ops import ntt

        proof = profile_warm("SHA-tier warm prove", prove, spans=[(ntt, "coset_scale")])
        log("  TimingTree:\n" + "\n".join("    " + line for line in proof.timing.splitlines()))
    return launches


def step_case(name: str, chain, prev_height: int) -> dict:
    """Phase 9 on one step witness: a cold and a warm prove_step on the
    card, the verifier (must accept), a tampered publics[0] and a new_height
    off by one (each must be rejected), the TimingTree, the warm prove's
    launches (each of PATH_KERNELS["step"] > 0) and peak device memory."""
    import torch

    from blobstreamx_tpu_torch.circuits import step
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.serialize import step_proof_to_bytes

    w = step.build_step_witness(chain, prev_height=prev_height)
    t0 = time.perf_counter()
    cold = pipeline.prove_step(w, device="cuda")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    warm, warm_s, launches, peak, resident = warm_run(lambda: pipeline.prove_step(w, device="cuda"))
    signers = int(w.signed.sum())
    log(f"  {name}: {len(w.new_set.pubkeys)} validators, {signers} signatures, step {prev_height} -> "
        f"{prev_height + 1}: cold {cold_s:.3f} s, warm {warm_s:.3f} s")
    log("  warm TimingTree:\n" + "\n".join("    " + line for line in warm.timing.splitlines()))
    log(f"  kernel launches in the warm prove: {json.dumps(launches)}")
    log(f"  peak device memory in the warm prove: {peak} bytes ({resident} resident before it)")
    missing = [k for k in PATH_KERNELS["step"] if launches[k] == 0]
    assert not missing, f"kernels of the step path were not launched: {missing} ({launches})"
    assert step_proof_to_bytes(warm) == step_proof_to_bytes(cold), "warm and cold step proofs differ"
    t0 = time.perf_counter()
    ok = pipeline.verify_step_proof(warm)
    verify_s = time.perf_counter() - t0
    pub = list(warm.publics)
    pub[0] -= 1  # still above 2/3 of the total: only the STARK can catch it
    tampered_signed = pipeline.verify_step_proof(dataclasses.replace(warm, publics=pub))
    pub = list(warm.publics)
    pub[19] += 1
    off = dataclasses.replace(warm.outputs, new_height=warm.outputs.new_height + 1)
    tampered_height = pipeline.verify_step_proof(dataclasses.replace(warm, publics=pub, outputs=off))
    log(f"  verify_step_proof: {ok} ({verify_s:.3f} s); tampered publics[0] accepted: {tampered_signed}; "
        f"new_height off by one accepted: {tampered_height}")
    assert ok, f"the port's verifier rejected the step proof ({name})"
    assert not tampered_signed and not tampered_height, f"a tampered step proof was accepted ({name})"
    return dict(validators=len(w.new_set.pubkeys), signatures=signers, prev_height=prev_height, cold_s=cold_s,
                warm_s=warm_s, verify_s=verify_s, launches=launches, peak_device_bytes=peak,
                resident_before_bytes=resident, timing=warm.timing.splitlines())


def step_phase(chain5, smi: str):
    """Phase 9: prove_step at config 5's shape (phase 5's chain, 1023 ->
    1024, 32 validators) and at config 3's signature count (a two-header
    chain of 256 validators, all signing, 1 -> 2). Returns the wide case's
    warm launches."""
    from blobstreamx_tpu_torch.circuits import fixtures as fx

    rec = {"config5_shape": step_case("config 5's chain", chain5, CONFIG5["target"] - 1)}
    c = STEP_WIDE
    t0 = time.perf_counter()
    chain = fx.generate_chain(seed=c["seed"], n_headers=c["n_headers"], n_validators=c["n_validators"],
                              sign_heights={c["prev_height"] + 1})
    chain_s = time.perf_counter() - t0
    log(f"  {c['n_validators']}-validator chain (host, golden Ed25519 keys and signatures): {chain_s:.3f} s")
    rec["wide"] = dict(step_case(f"{c['n_validators']}-validator chain", chain, c["prev_height"]),
                       chain_s=chain_s)
    log(json.dumps({"step": dict(rec, card=smi)}))
    return rec["wide"]["launches"]


def config5_full(smi: str):
    """Phase 10: config 5 at the full-coverage SHA-256 tier, cut in depth to
    192 headers (CONFIG5_FULL): one prove_skip(w, device="cuda",
    with_sha_stark="full"), its shards as the prover ran them (the proof's
    shard_log: blocks, prover path, time; the padded blocks must be
    CONFIG5_FULL's), the TimingTree, the launches (each of
    PATH_KERNELS["config5_full"] > 0), the peak device memory (under the
    card's) and what was resident before, the proof's SHA-256, a serializer
    round trip, the verifier (must accept with "ok: full coverage") and the
    FULL_TAMPERS (each must be rejected with its verdict)."""
    import torch

    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_from_bytes, skip_proof_to_bytes

    c = CONFIG5_FULL
    t0 = time.perf_counter()
    chain = fx.generate_chain(seed=c["seed"], n_headers=c["n_headers"], n_validators=c["n_validators"],
                              sign_heights={c["target"]})
    w = wit.build_skip_witness(chain, trusted_height=c["trusted"], target_height=c["target"])
    log(f"  witness (host): {time.perf_counter() - t0:.3f} s")

    proof, wall, launches, peak, resident = warm_run(
        lambda: pipeline.prove_skip(w, device="cuda", with_sha_stark="full"))
    total = torch.cuda.get_device_properties(0).total_memory
    shards = proof.sha_stark.shard_log
    log(f"  prove_skip(with_sha_stark=\"full\"): {wall:.3f} s; {sum(sh['messages'] for sh in shards)} "
        f"messages, {sum(sh['blocks'] for sh in shards)} blocks")
    for k, sh in enumerate(shards):
        log(f"  shard {k}: {json.dumps(sh)}")
    log("  TimingTree:\n" + "\n".join("    " + line for line in proof.timing.splitlines()))
    log(f"  kernel launches: {json.dumps(launches)}")
    log(f"  peak device memory: {peak} bytes ({resident} resident before it; the card has {total})")
    missing = [k for k in PATH_KERNELS["config5_full"] if launches[k] == 0]
    assert not missing, f"kernels of the full-tier path were not launched: {missing} ({launches})"
    assert peak < total, "peak device memory above the card's"
    padded = [sh["padded_blocks"] for sh in shards]
    assert padded == list(c["shard_blocks"]), f"shards of {padded} blocks, not {c['shard_blocks']}"
    assert len(proof.sha_stark.starks) == len(shards), "a STARK a shard"
    blob = skip_proof_to_bytes(proof)
    digest = hashlib.sha256(blob).hexdigest()
    round_trip = skip_proof_to_bytes(skip_proof_from_bytes(blob)) == blob
    log(f"  proof: {len(blob)} bytes, SHA-256 {digest}, serializer round trip equal: {round_trip}")
    assert round_trip, "the full-tier proof does not survive a serializer round trip"

    t0 = time.perf_counter()
    ok, detail = pipeline.verify_skip_proof_detailed(proof)
    verify_s = time.perf_counter() - t0
    log(f"  verify_skip_proof_detailed: {ok} {json.dumps(detail)} ({verify_s:.3f} s)")
    assert ok and detail["sha_stark"] == "ok: full coverage", "the port's verifier rejected the full-tier proof"
    tampers = {}
    for how, verdict in FULL_TAMPERS.items():
        t0 = time.perf_counter()
        ok_t, detail_t = pipeline.verify_skip_proof_detailed(full_tamper(proof, how))
        tampers[how] = detail_t.get("sha_stark")
        log(f"  tamper {how}: accepted {ok_t}, {detail_t.get('sha_stark')} ({time.perf_counter() - t0:.3f} s)")
        assert not ok_t, f"a full-tier proof with tamper {how} was accepted"
        assert tampers[how] == verdict, f"tamper {how} was rejected by another check than expected: {detail_t}"
    rec = dict(headers=c["n_headers"], validators=c["n_validators"], messages=sum(sh["messages"] for sh in shards),
               shards=shards,
               prove_s=wall, verify_s=verify_s, launches=launches, peak_device_bytes=peak,
               resident_before_bytes=resident, card_memory_bytes=total, proof_bytes=len(blob), proof_sha256=digest,
               tampers_rejected=tampers, timing=proof.timing.splitlines(), card=smi)
    log(json.dumps({"config5_full": rec}))
    return launches


# phase 12's tampers of an Ed25519-tier proof: the detail field each must fail in and its verdict. A
# changed claimed scalar or result point in aux, or the Ed STARK stripped, change what the claim digest
# binds (publics 38..45); a wrong quotient opening in the Ed STARK leaves the binding intact, so only the
# batch equation's own STARK check can reject it; an embedded claim bundle without the validator lists
# leaves the signers unbound to the public power sums, and the verifier fails closed
ED_TAMPERS = {
    "result_point": ("ed_stark", "failed: claim digest not bound in transcript"),
    "scalar": ("ed_stark", "failed: claim digest not bound in transcript"),
    "strip_ed_stark": ("ed_stark", "failed: claim digest not bound in transcript"),
    "ed_stark_opening": ("ed_stark", "failed: batch equation rejected"),
    "no_validator_lists": ("binding", "failed: embedded claims lack binding inputs (fail closed)"),
}
ED25519_Q = (1 << 255) - 19


def ed_tamper(proof, how: str):
    """One of phase 12's tampers of an Ed25519-tier proof (ED_TAMPERS)."""
    ed = proof.ed_stark
    if how == "strip_ed_stark":
        return dataclasses.replace(proof, ed_stark=None)
    if how == "no_validator_lists":
        return dataclasses.replace(proof, claims=dataclasses.replace(proof.claims, trusted_vals=None,
                                                                     target_vals=None))
    if how == "ed_stark_opening":
        (a, b), *qz = ed.stark.quotient_zeta
        bad = dataclasses.replace(ed.stark, quotient_zeta=[((a + 1) % GOLDILOCKS_P, b)] + qz)
        return dataclasses.replace(proof, ed_stark=dataclasses.replace(ed, stark=bad))
    (scalar, pt, out), *rest = ed.aux
    if how == "scalar":
        first = (scalar ^ 4, pt, out)
    else:
        first = (scalar, pt, ((out[0] + 1) % ED25519_Q,) + tuple(out[1:]))
    return dataclasses.replace(proof, ed_stark=dataclasses.replace(ed, aux=[first] + rest))


def config5_ed(w, smi: str, profile: bool):
    """Phase 12: config 5 at the Ed25519 STARK tier (phase 5's witness): a
    cold and a warm prove_skip(w, device="cuda", with_ed_stark=True), the
    Ed STARK's shape (ED_SEGMENTS segments of 512 rows) and the path
    prove_auto took (must be streaming), the TimingTree, the launches (each
    of PATH_KERNELS["config5_ed"] > 0), the peak device memory (under the
    card's) and what was resident before, the SHA-256 of the warm proof's
    bytes (== the cold proof's), a serializer round trip, the verifier (must
    accept with ed_stark "ok" and binding "ok") and the ED_TAMPERS, each
    rejected with its verdict; a changed scalar or result point is also
    rejected by the Ed STARK's own check (ed_claims.verify_batch_stark)
    without the digest binding. With --profile, one more warm Ed-tier prove
    under torch.profiler."""
    import torch

    from blobstreamx_tpu_torch.prover import ed_air, ed_claims, pipeline, stark_stream
    from blobstreamx_tpu_torch.prover.config import StarkConfig
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_from_bytes, skip_proof_to_bytes

    def prove():
        return pipeline.prove_skip(w, device="cuda", with_ed_stark=True)

    t0 = time.perf_counter()
    cold = prove()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    log(f"  cold prove_skip(with_ed_stark=True): {cold_s:.3f} s")

    warm, warm_s, launches, peak, resident = warm_run(prove)
    total = torch.cuda.get_device_properties(0).total_memory
    ed = warm.ed_stark
    air = ed_air.EdScalarMulAir(len(ed.aux))
    path = "streaming" if stark_stream.uses_streaming(air, ed.n_rows, StarkConfig()) else "standard"
    items = pipeline.signature_items(w)
    log(f"  warm prove_skip(with_ed_stark=True): {warm_s:.3f} s")
    log("  warm TimingTree:\n" + "\n".join("    " + line for line in warm.timing.splitlines()))
    log(f"  Ed STARK: {len(items)} signatures, {len(ed.aux)} segments, {ed.n_rows} x {air.n_cols} trace, "
        f"{air.n_stage2} stage-2 columns, prover path {path}")
    log(f"  kernel launches in the warm prove: {json.dumps(launches)}")
    log(f"  peak device memory in the warm prove: {peak} bytes ({resident} resident before it; the card has {total})")
    assert len(ed.aux) == ED_SEGMENTS and ed.n_rows == ED_SEGMENTS * ed_air.SEG, "not config 5's Ed STARK"
    assert path == "streaming", "prove_auto did not take the streaming path at config 5's Ed tier"
    missing = [k for k in PATH_KERNELS["config5_ed"] if launches[k] == 0]
    assert not missing, f"kernels of the Ed-tier path were not launched: {missing} ({launches})"
    assert peak < total, "peak device memory above the card's"
    blob = skip_proof_to_bytes(warm)
    digest = hashlib.sha256(blob).hexdigest()
    round_trip = skip_proof_to_bytes(skip_proof_from_bytes(blob)) == blob
    log(f"  warm proof: {len(blob)} bytes, SHA-256 {digest}, serializer round trip equal: {round_trip}")
    assert blob == skip_proof_to_bytes(cold), "warm and cold Ed-tier proofs differ"
    assert round_trip, "the Ed-tier proof does not survive a serializer round trip"
    del cold, blob

    t0 = time.perf_counter()
    ok, detail = pipeline.verify_skip_proof_detailed(warm)
    verify_s = time.perf_counter() - t0
    log(f"  verify_skip_proof_detailed: {ok} {json.dumps(detail)} ({verify_s:.3f} s)")
    assert ok and detail["ed_stark"] == "ok" and detail["binding"] == "ok", \
        "the port's verifier rejected the Ed-tier proof"
    tampers = {}
    for how, (field, verdict) in ED_TAMPERS.items():
        t0 = time.perf_counter()
        bad = ed_tamper(warm, how)
        ok_t, detail_t = pipeline.verify_skip_proof_detailed(bad)
        tampers[how] = detail_t.get(field)
        line = f"  tamper {how}: accepted {ok_t}, {field} {detail_t.get(field)}"
        if how in ("scalar", "result_point"):
            alone = ed_claims.verify_batch_stark(bad.ed_stark, items, config=StarkConfig())
            line += f"; the Ed STARK's own check accepts it: {alone}"
            assert not alone, f"the Ed STARK's check accepted tamper {how}"
        log(f"{line} ({time.perf_counter() - t0:.3f} s)")
        assert not ok_t, f"an Ed-tier proof with tamper {how} was accepted"
        assert tampers[how] == verdict, f"tamper {how} was rejected by another check than expected: {detail_t}"
    rec = dict(
        cold_s=cold_s, warm_s=warm_s, verify_s=verify_s, launches=launches, peak_device_bytes=peak,
        resident_before_bytes=resident, card_memory_bytes=total, prover_path=path, signatures=len(items),
        segments=len(ed.aux), rows=ed.n_rows, cols=air.n_cols, stage2_cols=air.n_stage2, proof_sha256=digest,
        tampers_rejected=tampers, timing=warm.timing.splitlines(), card=smi,
    )
    log(json.dumps({"config5_ed": rec}))
    if profile:
        from blobstreamx_tpu_torch.ops import ntt

        proof = profile_warm("Ed-tier warm prove", prove, spans=[(ntt, "coset_scale")])
        log("  TimingTree:\n" + "\n".join("    " + line for line in proof.timing.splitlines()))
    return launches, digest


def cli(*args: str) -> list[str]:
    """The command line of `python -m blobstreamx_tpu_torch` with `args`."""
    return [sys.executable, "-m", "blobstreamx_tpu_torch", *args]


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def kill_once_phases_saved(cmd: list[str], run_root: Path, phases: tuple[str, ...], log_path: Path) -> float:
    """Start `cmd` and SIGKILL it as soon as <run_root>/skip-*/ holds both
    files of every one of `phases`; fails if it ends first or runs 600 s.
    Returns the seconds it ran."""
    timeout_s = 600.0
    t0 = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        try:
            while time.perf_counter() - t0 < timeout_s:
                runs = list(run_root.glob("skip-*"))
                if len(runs) == 1 and all((runs[0] / f"{ph}.{ext}").exists()
                                          for ph in phases for ext in ("npz", "json")):
                    proc.kill()  # SIGKILL
                    break
                if proc.poll() is not None:
                    raise AssertionError(f"the CLI ended ({proc.returncode}) before saving {phases}: "
                                         f"{log_path.read_text()[-2000:]}")
                time.sleep(0.1)
            else:
                raise AssertionError(f"the CLI did not save {phases} within {timeout_s} s")
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    return time.perf_counter() - t0


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def timing_names(rendered: str) -> list[str]:
    """The node names of a rendered TimingTree (each line without its time and rate)."""
    return [line.split(" ms  ", 1)[1].split(" (")[0] for line in rendered.splitlines() if " ms  " in line]


def operator_phase(w, ed_sha256: str, smi: str):
    """Phase 13: the operator's surface on the card, on phase 5's config-5
    witness `w` (the chain the CLI builds from OPERATOR_CLI).

    (a) `python -m blobstreamx_tpu_torch prove-skip ... --ed-stark
        --checkpoint-dir D --metrics M --out P --claims-out C`, SIGKILLed
        once consensus and trace are saved (in the Ed STARK), then run
        again: exit 0, "consensus+trace resumed from checkpoint" in its
        TimingTree, the SHA-256 of P == phase 12's Ed-tier proof
        (`ed_sha256`), M's timing record; `verify-skip --proof P --claims
        C` says "ok": true.
    (b) in-process prove_skip(w, with_ed_stark=True, checkpoint_dir=D):
        every phase resumed, no kernel launched, P's bytes; then, with
        stark.{npz,json} deleted, run_with_retry over it with a fault
        injected into the first main STARK: the retry proves only the
        SkipAir STARK (no aux STARK), P's bytes, and the heartbeat file
        holds start, heartbeat and stop records.
    (c) prove_pipelined over three default-tier witnesses (PIPELINED: three
        targets of one config-5-width chain) with prefetch=1, then the same proves
        serially: the same bytes in the same order; both walls.
    (d) `prove-step --validators 32` through the CLI with --profile-dir T:
        a non-empty Chrome trace under T (verify-skip of (a) runs meanwhile,
        in its own process).

    The kernel counts of (b) and (c) (in-process) are returned for the path
    "operator"."""
    import torch

    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline, stark, stark_stream
    from blobstreamx_tpu_torch.prover.overlap import prove_pipelined
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes
    from blobstreamx_tpu_torch.utils import failure

    work = ROOT / "build" / "operator"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt, metrics_path, proof_path, claims_path = work / "ckpt", work / "metrics.jsonl", work / "proof.bin", \
        work / "claims.bin"
    torch.cuda.empty_cache()  # the CLI's processes share the card with this one
    prove_cmd = cli("--metrics", str(metrics_path), *OPERATOR_CLI, "--checkpoint-dir", str(ckpt),
                    "--out", str(proof_path), "--claims-out", str(claims_path))
    rec = {"card": smi}

    # (a) crash and resume of the CLI
    t_a = time.perf_counter()
    rec["killed_after_s"] = kill_once_phases_saved(prove_cmd, ckpt, ("consensus", "trace"), work / "killed.log")
    (run_dir,) = ckpt.glob("skip-*")
    saved = sorted(p.name for p in run_dir.iterdir())
    log(f"  (a) CLI killed after {rec['killed_after_s']:.3f} s with {saved} saved ({dir_bytes(ckpt)} bytes)")
    assert not (run_dir / "ed_stark.json").exists(), "the Ed STARK finished before the kill"
    t0 = time.perf_counter()
    resumed = subprocess.run(prove_cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
    rec["resumed_run_s"] = time.perf_counter() - t0
    assert resumed.returncode == 0, f"the resumed CLI run failed: {resumed.stderr[-3000:]}"
    log("  (a) resumed CLI run TimingTree:\n" + "\n".join("    " + line for line in resumed.stderr.splitlines()
                                                         if " ms  " in line))
    assert "consensus+trace resumed from checkpoint" in timing_names(resumed.stderr), \
        "the CLI did not resume consensus+trace"
    cli_out = last_json(resumed.stdout)
    blob = proof_path.read_bytes()
    digest = hashlib.sha256(blob).hexdigest()
    rec.update(checkpoint_bytes=dir_bytes(ckpt), checkpoint_files=sorted(p.name for p in run_dir.iterdir()),
               cli_wall_s=cli_out["wall_s"], proof_sha256=digest)
    log(f"  (a) resumed run: {rec['resumed_run_s']:.3f} s of process ({cli_out['wall_s']:.3f} s of prove); "
        f"proof SHA-256 {digest}; checkpoint directory {rec['checkpoint_bytes']} bytes "
        f"({rec['checkpoint_files']})")
    assert digest == ed_sha256, "the resumed CLI's proof differs from phase 12's Ed-tier proof"
    timing_recs = [r for r in map(json.loads, metrics_path.read_text().splitlines()) if r["event"] == "timing"]
    assert len(timing_recs) == 1, f"expected one timing record, got {len(timing_recs)}"
    m = timing_recs[0]
    rec["metrics"] = {k: m[k] for k in ("n_headers", "n_validators", "n_rows")}
    log(f"  (a) metrics timing record: {json.dumps(rec['metrics'])}, {len(m['phases'])} phases")
    assert (m["n_headers"], m["n_validators"]) == (len(w.range_heights), len(w.target_set.powers)), m
    rec["a_s"] = time.perf_counter() - t_a
    # (b) whole-proof resume from the CLI's directory, then a retry after a fault in the main STARK
    kernels.reset_counts()
    t0 = time.perf_counter()
    proof = pipeline.prove_skip(w, device="cuda", with_ed_stark=True, checkpoint_dir=str(ckpt))
    torch.cuda.synchronize()
    rec["full_resume_s"] = time.perf_counter() - t0
    launched = {k: v for k, v in kernels.launches.items() if v}
    log(f"  (b) full resume: {rec['full_resume_s']:.3f} s, kernels launched {launched}")
    for note in ("consensus+trace", "ed_stark", "stark"):
        assert f"{note} resumed from checkpoint" in timing_names(proof.timing), f"{note} was not resumed"
    assert not launched, f"the full resume launched kernels: {launched}"
    assert skip_proof_to_bytes(proof) == blob, "the resumed proof differs from the CLI's"
    for ext in ("npz", "json"):
        (run_dir / f"stark.{ext}").unlink()
    proves, auto = [], []
    orig_prove, orig_auto = stark.prove, stark_stream.prove_auto

    def faulty_prove(air, *a, **k):
        proves.append(type(air).__name__)
        if len(proves) == 1:
            raise RuntimeError("injected fault in the main STARK")
        return orig_prove(air, *a, **k)

    def counted_auto(air, *a, **k):
        auto.append(type(air).__name__)
        return orig_auto(air, *a, **k)

    heartbeat = work / "heartbeat.jsonl"
    stark.prove, stark_stream.prove_auto = faulty_prove, counted_auto
    try:
        t0 = time.perf_counter()
        proof = failure.run_with_retry(
            lambda: pipeline.prove_skip(w, device="cuda", with_ed_stark=True, checkpoint_dir=str(ckpt)),
            attempts=2, heartbeat_path=str(heartbeat), run_id="operator", interval=0.2,
            on_failure=lambda i, e: log(f"  (b) attempt {i} failed: {e}"))
        torch.cuda.synchronize()
        rec["retry_s"] = time.perf_counter() - t0
    finally:
        stark.prove, stark_stream.prove_auto = orig_prove, orig_auto
    events = [json.loads(line)["event"] for line in heartbeat.read_text().splitlines()]
    log(f"  (b) retry: {rec['retry_s']:.3f} s, main STARK proves {proves}, aux STARK proves {auto}, "
        f"heartbeat events {events.count('start')} start / {events.count('heartbeat')} heartbeat / "
        f"{events.count('stop')} stop")
    assert proves == ["SkipAir", "SkipAir"] and auto == [], "the retry proved more than the main STARK"
    names = timing_names(proof.timing)
    assert "stark resumed from checkpoint" not in names and "ed_stark resumed from checkpoint" in names, names
    assert skip_proof_to_bytes(proof) == blob, "the retried proof differs from the CLI's"
    assert events.count("start") == events.count("stop") == 2 and events.count("heartbeat") >= 1, events
    rec["heartbeats"] = events.count("heartbeat")
    del proof

    # (c) three default-tier proves pipelined, then serially
    c = PIPELINED
    t0 = time.perf_counter()
    chain = fx.generate_chain(seed=c["seed"], n_headers=c["n_headers"], n_validators=c["n_validators"],
                              sign_heights=set(c["targets"]))
    rec["pipelined_chain_s"] = time.perf_counter() - t0

    def builders():
        return ((lambda t=t: wit.build_skip_witness(chain, trusted_height=c["trusted"], target_height=t))
                for t in c["targets"])

    t0 = time.perf_counter()
    piped = [skip_proof_to_bytes(p) for p in prove_pipelined(builders(), prefetch=1, device="cuda")]
    torch.cuda.synchronize()
    rec["pipelined_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serial = [skip_proof_to_bytes(pipeline.prove_skip(b(), device="cuda")) for b in builders()]
    torch.cuda.synchronize()
    rec["serial_s"] = time.perf_counter() - t0
    launches = dict(kernels.launches)
    log(f"  (c) {len(c['targets'])} default-tier proves ({c['trusted']} -> {c['targets']}): pipelined "
        f"{rec['pipelined_s']:.3f} s, serial {rec['serial_s']:.3f} s (chain {rec['pipelined_chain_s']:.3f} s)")
    log(f"  kernel launches in (b) and (c): {json.dumps(launches)}")
    assert piped == serial, "the pipelined proofs differ from the serial ones"
    assert len(set(piped)) == len(c["targets"]), "two targets gave the same proof"
    missing = [k for k in PATH_KERNELS["operator"] if launches[k] == 0]
    assert not missing, f"kernels of the operator path were not launched: {missing} ({launches})"

    # (d) a profiled prove-step through the CLI, while verify-skip of (a) (host work) runs in its own process
    trace_dir = work / "trace"
    with open(work / "verify.log", "w") as verify_log:
        t_verify = time.perf_counter()
        verify = subprocess.Popen(cli("verify-skip", "--proof", str(proof_path), "--claims", str(claims_path)),
                                  cwd=ROOT, stdout=verify_log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            step_run = subprocess.run(cli("--profile-dir", str(trace_dir), "prove-step", "--validators", "32"),
                                      cwd=ROOT, capture_output=True, text=True, timeout=600)
            rec["profiled_step_s"] = time.perf_counter() - t0
            verify.wait(timeout=900)
            rec["verify_s"] = time.perf_counter() - t_verify
        finally:
            if verify.poll() is None:
                verify.kill()
                verify.wait()
    assert step_run.returncode == 0, f"the profiled prove-step failed: {step_run.stderr[-3000:]}"
    step_out = last_json(step_run.stdout)
    traces = list(trace_dir.glob("*.pt.trace.json"))
    rec["trace_bytes"] = sum(t.stat().st_size for t in traces)
    log(f"  (d) profiled prove-step: {rec['profiled_step_s']:.3f} s of process, prove {step_out['wall_s']:.3f} s, "
        f"ok {step_out['ok']}; {len(traces)} trace file(s), {rec['trace_bytes']} bytes")
    assert step_out["ok"] and len(traces) == 1 and rec["trace_bytes"] > 0, "no profile trace was written"
    shutil.rmtree(trace_dir)
    verdict = last_json((work / "verify.log").read_text())
    log(f"  (a) verify-skip --claims: rc {verify.returncode}, {json.dumps(verdict)} ({rec['verify_s']:.3f} s "
        f"of process)")
    assert verify.returncode == 0 and verdict["ok"] is True, "verify-skip rejected the resumed CLI's proof"
    rec.update(verify=verdict, launches=launches)
    log(json.dumps({"operator": rec}))
    return launches


def profile_warm(what: str, run, spans=()):
    """One more warm run of a path under torch.profiler (only with
    --profile): device time by kernel name, host time by operator, the
    number of kernel launches and the device's busy share of the wall; the
    long-column NTT's kernels and each of `spans` ((module, function name)
    pairs, the function run inside a profiler range for this run) with
    their calls and device time. Returns what `run` returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def in_range(name, fn):
        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped

    saved = [(mod, name, getattr(mod, name)) for mod, name in spans]
    for mod, name, fn in saved:
        setattr(mod, name, in_range(name, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            result = run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    ka = prof.key_averages()
    # device kernels only (operator rows would count each kernel twice)
    kernel_rows = [e for e in ka if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in kernel_rows)
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    log(f"  profiled {what}: wall {wall_s:.3f} s, device busy {device_us / 1e6:.3f} s "
        f"({100 * device_us / 1e6 / wall_s:.2f} % of the wall), {launches} kernel launches")
    ours = ("ntt_", "twiddle_transpose_kernel", "poseidon_kernel", "edwards_add_kernel", "pow22523_kernel",
            "sqn_kernel")
    for e in sorted(kernel_rows, key=dev_us, reverse=True):
        if any(e.key.startswith(o) for o in ours):
            log(f"  hand kernel {e.key}: {e.count} launches, {dev_us(e) / 1e3:.3f} ms device time")
    ed = [e for e in kernel_rows if e.key.startswith(("edwards_add_kernel", "pow22523_kernel", "sqn_kernel"))]
    log(f"  Ed25519 kernels (edwards add, power chain): {sum(e.count for e in ed)} launches, "
        f"{sum(dev_us(e) for e in ed) / 1e3:.4f} ms device time")
    long_ntt = [e for e in kernel_rows if e.key.startswith("ntt_long_")]
    log(f"  long-column NTT kernels: {sum(e.count for e in long_ntt)} launches, "
        f"{sum(dev_us(e) for e in long_ntt) / 1e3:.4f} ms device time")
    for _mod, name in spans:
        # the range as the device ran it (its span on the device's timeline); the host-side row of the
        # same name sums its operators' device time, nested operators twice
        rows = [e for e in ka if e.key == name and e.device_type == DeviceType.CUDA]
        log(f"  span {name}: {sum(e.count for e in rows)} calls, {sum(dev_us(e) for e in rows) / 1e3:.4f} ms "
            f"device time")
    sort_dev = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    log(ka.table(sort_by=sort_dev, row_limit=15, max_name_column_width=60))
    log(ka.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60))
    return result


@contextmanager
def phase(title: str):
    """Print a phase's title, run it, then print its wall time."""
    log(title)
    t0 = time.perf_counter()
    yield
    log(f"  phase wall: {time.perf_counter() - t0:.3f} s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    from blobstreamx_tpu_torch import kernels  # fails outside a checkout of the repository

    import numpy as np

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"[1] device: {name}")
    log(smi)
    torch.cuda.set_device(0)

    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    log(f"[2] kernel build: {build_s:.2f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}.cu: {line.strip()}")

    with phase("[3] kernel checks (kernel vs plain PyTorch on the card, exact)"):
        floor_ms = launch_floor_ms()
        log(f"  launch floor (one empty kernel through the ed25519 library): {floor_ms:.4f} ms")
        rng = np.random.default_rng(2024)
        rows = {}
        for k in KERNELS:
            rows[k["name"]] = k["check"](rng, "cuda")

    seen = set()
    with recorded_ntt_shapes(seen):
        with phase("[4] card vs CPU on the small chains"):
            small_chain_card_vs_cpu()

        with phase("[5] config 5 on the card"):
            launches5, cold_s, warm_s, w, chain5 = config5()
            log(json.dumps({"config5": {"cold_s": cold_s, "warm_s": warm_s, "launches": launches5, "card": smi}}))
        if "--profile" in sys.argv[1:]:
            from blobstreamx_tpu_torch.prover import pipeline

            with phase("[6] profiled warm prove"):
                proof = profile_warm("warm prove", lambda: pipeline.prove_skip(w, device="cuda"))
                log("  TimingTree:\n" + "\n".join("    " + line for line in proof.timing.splitlines()))

        with phase("[7] config 4 on the card"):
            by_path = {"config5": launches5, "config4": config4(smi, profile="--profile" in sys.argv[1:])}

        with phase("[8] config 5 at the SHA-256 tier on the card"):
            by_path["config5_sha"] = config5_sha(w, smi, profile="--profile" in sys.argv[1:])

        with phase("[9] prove_step on the card"):
            by_path["step"] = step_phase(chain5, smi)

        with phase("[10] config 5 at the full-coverage SHA-256 tier, 192 headers, on the card"):
            by_path["config5_full"] = config5_full(smi)

        with phase("[12] config 5 at the Ed25519 STARK tier on the card"):
            by_path["config5_ed"], ed_sha256 = config5_ed(w, smi, profile="--profile" in sys.argv[1:])

        with phase("[13] the operator's surface on the card"):
            log(f"  {smi}")
            by_path["operator"] = operator_phase(w, ed_sha256, smi)

    with phase("[11] the NTT kernels at every shape the main paths launched (vs plain PyTorch, exact)"):
        check_recorded_ntt(np.random.default_rng(11), seen, rows)

    out = []
    for k in KERNELS:
        main_row = next(r for r in rows[k["name"]] if r["shape"] == k["main_shape"])
        entry = dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"])
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        entry.update(launches=by_path[k["path"]][k["counter"]], path=k["path"],
                     launches_by_path={p: counts[k["counter"]] for p, counts in by_path.items()},
                     max_abs_err=max(r["max_abs_err"] for r in rows[k["name"]]))
        entry.update({key: main_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
        entry.update(library_ms=None, shape=main_row["shape"])
        if k["source"].endswith("ed25519.cu"):
            entry["launch_floor_ms"] = floor_ms
        entry["other_shapes"] = [r for r in rows[k["name"]] if r is not main_row]
        out.append(entry)
    log(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
