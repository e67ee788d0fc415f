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
     on the same seeded inputs at the main path's shapes (values near p,
     near 2^32 and 2^256, random valid curve points), mismatches (must be
     0), the kernel's and the plain version's time by CUDA events, and the
     kernel's bound from its counted bytes and operations;
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
     busy share of the wall).

The line before the last is one JSON object {"kernels": [...]}; the last is
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


def log(*a):
    print(*a, flush=True)


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
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
    ]
    for (n, c), inverse, what in cases:
        x = gf64.from_u64(gl_values(rng, (n, c)), dev)
        k = ntt._ntt_cols_cuda(x, inverse)
        p = ntt.ntt_cols_plain(x, inverse)
        mism = int(((k[0] != p[0]) | (k[1] != p[1])).sum().item())
        err = max(max_abs(k[0], p[0]), max_abs(k[1], p[1]))
        reps = 20 if n <= 4096 else 5
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

    n = 16384
    s = gf64.from_u64(gl_values(rng, (12, n)), dev)
    k = pos._permute_cuda(s)
    p = pos.permute_plain(s)
    mism = int(((k[0] != p[0]) | (k[1] != p[1])).sum().item())
    err = max(max_abs(k[0], p[0]), max_abs(k[1], p[1]))
    ms = time_ms(lambda: pos._permute_cuda(s), 20)
    plain_ms = time_ms(lambda: pos.permute_plain(s), 3)
    muls = (8 * 12 + 22) * 4
    b, by = bound(2 * 12 * 16 * n, n * muls * GL_MUL_OPS)
    log(f"  poseidon (12, {n}): mismatches {mism}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b:.6f} ms ({by})")
    assert mism == 0, "poseidon kernel disagrees with the plain version"
    return [dict(shape=f"(12, {n})", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by)]


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
        log(f"  sqn k={k} (64 lanes): mismatches {mism}")
        assert mism == 0, f"sqn kernel disagrees with the plain version at k={k}"
    return rows


KERNELS = [
    dict(name="ntt", counter="ntt", source="blobstreamx_tpu_torch/csrc/ntt.cu",
         replaces="blobstreamx_tpu/ops/ntt.py:332", also_replaces="blobstreamx_tpu/ops/ntt.py:248",
         main_shape="(256, 8) forward", check=check_ntt),
    dict(name="poseidon", counter="poseidon", source="blobstreamx_tpu_torch/csrc/poseidon.cu",
         replaces="blobstreamx_tpu/ops/poseidon.py:188", main_shape="(12, 16384)", check=check_poseidon),
    dict(name="edwards_add", counter="edwards_add", source="blobstreamx_tpu_torch/csrc/ed25519.cu",
         replaces="blobstreamx_tpu/ops/curve25519.py:135", main_shape="4096 lanes", check=check_edwards_add),
    dict(name="pow_chain", counter="pow_chain", source="blobstreamx_tpu_torch/csrc/ed25519.cu",
         replaces="blobstreamx_tpu/fields/gf25519.py:333", also_replaces="blobstreamx_tpu/fields/gf25519.py:267",
         main_shape="pow22523, 64 lanes", check=check_pow_chain),
]


# ----------------------------------------------------------------------------
# phases 4 and 5: the main path
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
    t0 = time.perf_counter()
    warm = pipeline.prove_skip(w, device="cuda")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"  warm prove_skip: {warm_s:.3f} s")
    log("  warm TimingTree:\n" + "\n".join("    " + line for line in warm.timing.splitlines()))
    log(f"  kernel launches in the warm prove: {json.dumps(launches)}")
    log(f"  peak device memory in the warm prove: {peak} bytes")
    assert all(v > 0 for v in launches.values()), f"a kernel of the path was not launched: {launches}"
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


def profile_warm_prove(w):
    """One more warm config-5 prove under torch.profiler (only with
    --profile): device time by kernel name, host time by operator, the
    number of kernel launches and the device's busy share of the wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from blobstreamx_tpu_torch.prover import pipeline

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proof = pipeline.prove_skip(w, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    ka = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device kernels only (operator rows would count each kernel twice)
    kernel_rows = [e for e in ka if e.device_type == DeviceType.CUDA]
    device_us = sum(dev_us(e) for e in kernel_rows)
    launches = sum(e.count for e in ka if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    log(f"  profiled warm prove: wall {wall_s:.3f} s, device busy {device_us / 1e6:.3f} s "
        f"({100 * device_us / 1e6 / wall_s:.2f} % of the wall), {launches} kernel launches")
    log("  TimingTree:\n" + "\n".join("    " + line for line in proof.timing.splitlines()))
    ours = ("ntt_", "poseidon_kernel", "edwards_add_kernel", "pow22523_kernel", "sqn_kernel")
    for e in sorted(kernel_rows, key=dev_us, reverse=True):
        if any(e.key.startswith(o) for o in ours):
            log(f"  hand kernel {e.key}: {e.count} launches, {dev_us(e) / 1e3:.3f} ms device time")
    sort_dev = "self_device_time_total" if hasattr(ka[0], "self_device_time_total") else "self_cuda_time_total"
    log(ka.table(sort_by=sort_dev, row_limit=15, max_name_column_width=60))
    log(ka.table(sort_by="self_cpu_time_total", row_limit=15, max_name_column_width=60))


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
    launches, cold_s, warm_s, w = config5()
    if "--profile" in sys.argv[1:]:
        log("[6] profiled warm prove")
        profile_warm_prove(w)

    out = []
    for k in KERNELS:
        main_row = next(r for r in rows[k["name"]] if r["shape"] == k["main_shape"])
        entry = dict(name=k["name"], route="cuda", source=k["source"], replaces=k["replaces"])
        if "also_replaces" in k:
            entry["also_replaces"] = k["also_replaces"]
        entry.update(launches=launches[k["counter"]], max_abs_err=max(r["max_abs_err"] for r in rows[k["name"]]))
        entry.update({key: main_row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
        entry.update(library_ms=None, shape=main_row["shape"])
        entry["other_shapes"] = [r for r in rows[k["name"]] if r is not main_row]
        out.append(entry)
    log(json.dumps({"config5": {"cold_s": cold_s, "warm_s": warm_s, "card": smi}}))
    log(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
