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
     polynomial's (8, 1); mismatches (must be 0), the kernel's and the
     plain version's time by CUDA events, and the
     kernel's bound from its counted bytes and operations (the
     twiddle-transpose also beside a bare transpose copy, and the sqn chain
     timed at k = 1, 5 and 50);
  4. card vs CPU: the small chain of tests/test_pipeline.py proven on cuda
     and on cpu gives identical proof bytes (the CPU path is held
     byte-equal to the JAX package by the CPU tests);
  5. config 5 (1024 headers, 32 validators, seed 7, trusted 1 -> target
     1024, default StarkConfig): witness, a cold and a warm prove_skip on
     cuda, the port's verifier (must accept), a tampered publics[0] (must
     be rejected), the TimingTree, each kernel's launches in the warm prove
     (each must be > 0) and the peak device memory;
  6. only with --profile: one more warm prove under torch.profiler (device
     time by kernel, host time by operator, kernel launches, the device's
     busy share of the wall), and the same for one more warm config-4 run
     at the end of phase 7;
  7. config 4 (benches/configs.py's config4: one 2^22 polynomial, numpy
     seed 0): a cold and a warm run of the path, the launches and peak
     device memory of the warm one (ntt, twiddle_transpose and poseidon must
     each launch) — the four-step NTT forward and inverse, a low-degree
     codeword (2^19 coefficients, coset_scale, four-step) and its FRI proof
     (default FriConfig) — then the checks: four-step == its plain version
     == ntt_cols of the (2^22, 1) column, inverse(forward) == identity, the
     codeword == lde_cols, fri_verify accepts the proof and rejects one
     changed query pair; then CUDA-event times of the four-step (16
     iterations each way, butterflies/s) and of its plain version, of the
     column path and of one
     fold of the codeword. One JSON line {"config4": {...}}.

Each path has its own list of kernels that must launch. Before the last
line come {"config5": ...}, {"config4": ...} and {"kernels": [...]}, where
each kernel's "launches" is from the warm run of its own path ("path") and
"launches_by_path" has both; the last line is
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
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
PROD64_OPS = 16  # one 64x64->128-bit product
GL_MUL_OPS = PROD64_OPS  # Goldilocks mulmod: one product, reduction by shifts/adds
FE_MUL_OPS = 20 * PROD64_OPS  # GF(2^255-19) mul: 16 schoolbook products + 4 by 38
POW22523_MULS = 262  # field multiplies of the pow22523 chain
EDWARDS_ADD_MULS = 9

CONFIG5 = dict(seed=7, n_headers=1024, n_validators=32, trusted=1, target=1024)
CONFIG4 = dict(seed=0, log_n=22, fold_beta=0x123456789ABCDEF, iters=16)
PATH_KERNELS = {
    "config5": ("ntt", "poseidon", "edwards_add", "pow_chain"),
    "config4": ("ntt", "twiddle_transpose", "poseidon"),
}


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
    with random projective scale, doublings (q = p), identity operands and
    coordinates stored non-canonically (value + p) where that stays < 2^256."""
    from blobstreamx_tpu_torch.golden import ed25519 as ged

    Q = ged.Q
    base = [ged.point_mul(int.from_bytes(rng.bytes(32), "little") % ged.L, ged.BASE) for _ in range(64)]

    def scaled(pt, lam):
        return tuple(c * lam % Q for c in pt)

    def lift(pt):
        return tuple(c + Q if c + Q < (1 << 256) and rng.integers(0, 2) else c for c in pt)

    ps, qs = [], []
    for j in range(n):
        p = scaled(base[j % 64], int(rng.integers(1, 1 << 62)))
        if j % 16 == 0:
            q = p
        elif j % 16 == 1:
            q = scaled(ged.IDENTITY, int(rng.integers(1, 1 << 62)))
        else:
            q = scaled(base[(7 * j + 3) % 64], int(rng.integers(1, 1 << 62)))
        ps.append(lift(p))
        qs.append(lift(q))
    return ps, qs


# ----------------------------------------------------------------------------
# phase 3: kernel checks
# ----------------------------------------------------------------------------


def check_ntt(rng, dev):
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt

    rows = []
    cases = [
        ((32, 8), True, "trace INTT"),
        ((256, 8), False, "trace LDE"),
        ((256, 2), True, "quotient coset INTT"),
        ((1 << 16, 8), False, "multi-launch path"),
        ((2048, 2048), False, "four-step pass at 2^22"),
        ((2048, 2048), True, "four-step inverse pass at 2^22"),
        ((8, 1), True, "FRI final-poly coset INTT"),
    ]
    for (n, c), inverse, what in cases:
        x = gf64.from_u64(gl_values(rng, (n, c)), dev)
        mism, err = gl_mismatch(ntt._ntt_cols_cuda(x, inverse), ntt.ntt_cols_plain(x, inverse))
        reps = 20 if n * c <= 1 << 16 else 5
        ms = time_ms(lambda: ntt._ntt_cols_cuda(x, inverse), reps)
        plain_ms = time_ms(lambda: ntt.ntt_cols_plain(x, inverse), 3)
        log_n = n.bit_length() - 1
        muls = (n // 2) * log_n * c + (n * c if inverse else 0)
        b, by = bound(32 * n * c + 8 * (n // 2), muls * GL_MUL_OPS)
        log(f"  ntt ({n}, {c}) {'inverse' if inverse else 'forward'} [{what}]: mismatches {mism}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by})")
        assert mism == 0, f"ntt kernel disagrees with the plain version at ({n}, {c})"
        rows.append(dict(shape=f"({n}, {c}) {'inverse' if inverse else 'forward'}", max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by))
    return rows


def check_poseidon(rng, dev):
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import poseidon as pos

    rows = []
    # config 5's grind batch; config 4's first FRI leaf hashes and its first compression
    for n in (16384, 1 << 21, 1 << 20):
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


def check_edwards_add(rng, dev):
    from blobstreamx_tpu_torch.ops import curve25519 as curve

    n = 4096
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
    assert mism == 0, "edwards-add kernel disagrees with the plain version"
    return [dict(shape=f"{n} lanes", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)]


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
    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.config import StarkConfig
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes

    cfg = StarkConfig(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=4, final_poly_len=4)
    chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4,
                              sign_fraction=0.75, sign_heights={10})
    w = wit.build_skip_witness(chain, trusted_height=2, target_height=10)
    t0 = time.perf_counter()
    on_card = skip_proof_to_bytes(pipeline.prove_skip(w, cfg, device="cuda"))
    t1 = time.perf_counter()
    on_cpu = skip_proof_to_bytes(pipeline.prove_skip(w, cfg, device="cpu"))
    t2 = time.perf_counter()
    same = on_card == on_cpu
    log(f"  small chain (seed 11, 12 headers, 4 validators, 2 -> 10): card {t1 - t0:.3f} s, "
        f"cpu {t2 - t1:.3f} s, {len(on_card)} proof bytes, card bytes == cpu bytes: {same}")
    assert same, "card proof bytes differ from the CPU proof bytes"


def config5():
    import torch

    from blobstreamx_tpu_torch import kernels
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

    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    warm = pipeline.prove_skip(w, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
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
    return launches, cold_s, warm_s, w


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


def config4(smi: str, profile: bool = False):
    """Config 4 on the card: cold and warm runs of the path, launches and
    peak memory of the warm one, the checks, then CUDA-event times; with
    `profile`, one more warm run under torch.profiler."""
    import torch

    from blobstreamx_tpu_torch import kernels
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

    kernels.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    y, back, cw, proof, fri_s = config4_path(x, coeffs, cfg, shift)
    warm_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
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
    )
    log(f"  four-step 2^{log_n}: forward {ntt_ms:.4f} ms ({rec['butterflies_per_s']:.4e} butterflies/s), "
        f"inverse {intt_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b:.6f} ms ({by}); ntt_cols of the "
        f"(2^{log_n}, 1) column {col_ms:.4f} ms (bound {col_b:.6f} ms); fold {fold_ms:.4f} ms")
    log(json.dumps({"config4": rec}))
    if profile:
        profile_warm("config-4 warm path", lambda: config4_path(x, coeffs, cfg, shift))
    return launches


def profile_warm(what: str, run):
    """One more warm run of a path under torch.profiler (only with
    --profile): device time by kernel name, host time by operator, the
    number of kernel launches and the device's busy share of the wall.
    Returns what `run` returned."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

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
    sort_dev = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    log(ka.table(sort_by=sort_dev, row_limit=15, max_name_column_width=60))
    log(ka.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60))
    return result


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

    log("[3] kernel checks (kernel vs plain PyTorch on the card, exact)")
    rng = np.random.default_rng(2024)
    rows = {}
    for k in KERNELS:
        rows[k["name"]] = k["check"](rng, "cuda")

    log("[4] card vs CPU on the small chain")
    small_chain_card_vs_cpu()

    log("[5] config 5 on the card")
    launches5, cold_s, warm_s, w = config5()
    log(json.dumps({"config5": {"cold_s": cold_s, "warm_s": warm_s, "launches": launches5, "card": smi}}))
    if "--profile" in sys.argv[1:]:
        from blobstreamx_tpu_torch.prover import pipeline

        log("[6] profiled warm prove")
        proof = profile_warm("warm prove", lambda: pipeline.prove_skip(w, device="cuda"))
        log("  TimingTree:\n" + "\n".join("    " + line for line in proof.timing.splitlines()))

    log("[7] config 4 on the card")
    by_path = {"config5": launches5, "config4": config4(smi, profile="--profile" in sys.argv[1:])}

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
        entry["other_shapes"] = [r for r in rows[k["name"]] if r is not main_row]
        out.append(entry)
    log(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
