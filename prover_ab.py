#!/usr/bin/env python3
"""Prover timings of the PyTorch port on one CUDA card, for A/B comparisons
of two trees in one call.

    python3 prover_ab.py default [--tree DIR] [--warm N]
    python3 prover_ab.py sha_provers [--tree DIR] [--warm N]
    python3 prover_ab.py sha_tier [--tree DIR] [--warm N] [--expect-sha256 HEX]
    python3 prover_ab.py full_tier [--tree DIR] [--warm N] [--expect-sha256 HEX]
    python3 prover_ab.py ed_tier [--tree DIR] [--warm N] [--expect-sha256 HEX]
    python3 prover_ab.py north_star [--tree DIR] [--warm N] [--expect-sha256 HEX]
    python3 prover_ab.py config4 [--tree DIR] [--warm N]

--tree imports blobstreamx_tpu_torch (and builds its kernels) from DIR,
e.g. a parent commit unpacked with `git archive` into an ignored directory;
the default is this checkout. Run parent, change, change, parent in one
call and compare only within it.

default:     config 5 at the default tier (chip_smoke.py phase 5's witness):
             one cold and N warm prove_skip(w, device="cuda") in a fresh
             process; each warm wall, its peak device memory and what was
             resident before it.
sha_provers: stark.prove against stark_stream.prove_streaming on Sha256Air
             traces of 2^12 to 2^15 rows (chip_smoke.py's cutover-fit
             traces, default StarkConfig): one cold and N warm proves each,
             walls and peak memory; the two proofs' bytes must be equal.
sha_tier:    config 5 at the SHA-256 tier (chip_smoke.py phase 8's
             prove_skip(w, device="cuda", with_sha_stark=True)): one cold and
             N warm proves, walls, peak memory and TimingTrees, and the SHA-256
             of the proof bytes (warm == cold); with --expect-sha256, the digest
             must equal the given one (another tree's, from the same call).
full_tier:   config 5 at the full-coverage SHA-256 tier at its full depth,
             1024 headers (chip_smoke.py phase 10 cuts it to 192):
             prove_skip(w, device="cuda", with_sha_stark="full"), six
             4096-block shards; one cold and N warm proves, each with its
             wall, peak memory and each shard as the prover ran it (the
             proof's shard_log: blocks, prove time from its TimingTree
             scope, the path prove_auto took); the verify wall of the last proof
             (must accept with "ok: full coverage"); the SHA-256 of the
             proof bytes (warm == cold; --expect-sha256 as for sha_tier).
ed_tier:     config 5 at the Ed25519 STARK tier (chip_smoke.py phase 12's
             prove_skip(w, device="cuda", with_ed_stark=True): 128 segments,
             a 65,536-row trace): as full_tier, with each run's kernel
             launches and TimingTree, the Ed STARK's shape and the path
             prove_auto took; the verifier must accept with ed_stark "ok"
             and binding "ok".
north_star:  config 5 at the strongest tier, every hash and every signature
             proven (prove_skip(w, device="cuda", with_sha_stark="full",
             with_ed_stark=True)): as ed_tier, the verifier must also say
             "ok: full coverage".
config4:     config 4 (chip_smoke.py phase 7's path: the 2^22 four-step
             forward and inverse, a low-degree codeword and its FRI proof):
             one cold and N warm runs, walls and peak memory.

Prints one JSON line per measurement and a last {"ok": true, ...} line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

SHA_ROWS = (1 << 12, 1 << 13, 1 << 14, 1 << 15)


def timed(fn):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(s=time.perf_counter() - t0, peak_bytes=torch.cuda.max_memory_allocated(),
                     resident_bytes=resident)


def default_tier(warm: int) -> list[dict]:
    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes

    chain = fx.generate_chain(seed=7, n_headers=1024, n_validators=32, sign_heights={1024})
    w = wit.build_skip_witness(chain, trusted_height=1, target_height=1024)
    cold, rec = timed(lambda: pipeline.prove_skip(w, device="cuda"))
    rows = [dict(run="cold", **rec)]
    for i in range(warm):
        proof, rec = timed(lambda: pipeline.prove_skip(w, device="cuda"))
        assert skip_proof_to_bytes(proof) == skip_proof_to_bytes(cold), "warm and cold proofs differ"
        rows.append(dict(run=f"warm{i}", **rec))
    assert pipeline.verify_skip_proof(proof), "the verifier rejected the config-5 proof"
    return rows


def sha_provers(warm: int) -> list[dict]:
    import numpy as np

    from blobstreamx_tpu_torch.prover import serialize, sha_air, stark, stark_stream
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    cfg = StarkConfig()
    rng = np.random.default_rng(5)
    rows = []
    for n in SHA_ROWS:
        chain, blocks = sha_air.plan_blocks([rng.bytes(65) for _ in range(n // 128)])
        trace, aux = sha_air.build_sha_trace(chain, blocks)
        air = sha_air.Sha256Air(chain)
        provers = {
            "standard": lambda: stark.prove(air, trace, [], cfg, aux=aux, device="cuda"),
            "streaming": lambda: stark_stream.prove_streaming(air, trace, [], cfg, aux=aux, device="cuda"),
        }
        blobs = {}
        for name, fn in provers.items():
            for i in range(warm + 1):
                proof, rec = timed(fn)
                rows.append(dict(rows=n, prover=name, run="cold" if i == 0 else f"warm{i - 1}", **rec))
                print(json.dumps(rows[-1]), flush=True)
            blobs[name] = serialize.stark_proof_to_bytes(proof)
            del proof
        assert blobs["standard"] == blobs["streaming"], f"the two provers differ at {n} rows"
    return rows


def sha_tier(warm: int, expect: str | None) -> list[dict]:
    import hashlib

    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes

    chain = fx.generate_chain(seed=7, n_headers=1024, n_validators=32, sign_heights={1024})
    w = wit.build_skip_witness(chain, trusted_height=1, target_height=1024)
    rows, digests = [], set()
    for i in range(warm + 1):
        proof, rec = timed(lambda: pipeline.prove_skip(w, device="cuda", with_sha_stark=True))
        digests.add(hashlib.sha256(skip_proof_to_bytes(proof)).hexdigest())
        rows.append(dict(run="cold" if i == 0 else f"warm{i - 1}", **rec))
        print(json.dumps(rows[-1]), flush=True)
        print(proof.timing, flush=True)
        del proof
    assert len(digests) == 1, "the SHA-tier proofs of one process differ"
    digest = digests.pop()
    rows.append(dict(proof_sha256=digest))
    assert expect is None or digest == expect, f"proof SHA-256 {digest} differs from the expected {expect}"
    return rows


# skip-proof tiers at config 5's full depth: prove_skip's tier arguments, and
# the verdicts the verifier's detail must give
TIERS = {
    "full_tier": (dict(with_sha_stark="full"), {"sha_stark": "ok: full coverage"}),
    "ed_tier": (dict(with_ed_stark=True), {"ed_stark": "ok", "binding": "ok"}),
    "north_star": (dict(with_sha_stark="full", with_ed_stark=True),
                   {"sha_stark": "ok: full coverage", "ed_stark": "ok", "binding": "ok"}),
}


def skip_tier(what: str, warm: int, expect: str | None) -> list[dict]:
    import hashlib

    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.serialize import skip_proof_to_bytes

    tier, want = TIERS[what]
    chain = fx.generate_chain(seed=7, n_headers=1024, n_validators=32, sign_heights={1024})
    w = wit.build_skip_witness(chain, trusted_height=1, target_height=1024)
    rows, digests = [], set()
    for i in range(warm + 1):
        kernels.reset_counts()
        proof, rec = timed(lambda: pipeline.prove_skip(w, device="cuda", **tier))
        digests.add(hashlib.sha256(skip_proof_to_bytes(proof)).hexdigest())
        rows.append(dict(run="cold" if i == 0 else f"warm{i - 1}", launches=dict(kernels.launches), **rec))
        if proof.sha_stark is not None:
            rows[-1]["shards"] = proof.sha_stark.shard_log
        if proof.ed_stark is not None:
            from blobstreamx_tpu_torch.prover import ed_air, stark_stream
            from blobstreamx_tpu_torch.prover.config import StarkConfig

            air = ed_air.EdScalarMulAir(len(proof.ed_stark.aux))
            rows[-1]["ed_stark"] = dict(
                segments=len(proof.ed_stark.aux), rows=proof.ed_stark.n_rows, cols=air.n_cols,
                stage2_cols=air.n_stage2,
                path="streaming" if stark_stream.uses_streaming(air, proof.ed_stark.n_rows, StarkConfig())
                else "standard")
        print(json.dumps(rows[-1]), flush=True)
        print(proof.timing, flush=True)
        if i < warm:
            del proof
    t0 = time.perf_counter()
    ok, detail = pipeline.verify_skip_proof_detailed(proof)
    rows.append(dict(verify_s=time.perf_counter() - t0, verified=ok, detail=detail))
    print(json.dumps(rows[-1]), flush=True)
    assert ok and all(detail[k] == v for k, v in want.items()), f"the verifier rejected the {what} proof: {detail}"
    assert len(digests) == 1, f"the {what} proofs of one process differ"
    digest = digests.pop()
    rows.append(dict(proof_sha256=digest))
    assert expect is None or digest == expect, f"proof SHA-256 {digest} differs from the expected {expect}"
    return rows


def config4(warm: int) -> list[dict]:
    from blobstreamx_tpu_torch.golden import goldilocks as gold
    from blobstreamx_tpu_torch.golden.fri import FriConfig

    import chip_smoke as cs

    cfg = FriConfig()
    x, coeffs = cs.config4_inputs(cs.CONFIG4["seed"], cs.CONFIG4["log_n"], cs.CONFIG4["log_n"] - cfg.rate_bits)
    rows = []
    for i in range(warm + 1):
        out, rec = timed(lambda: cs.config4_path(x, coeffs, cfg, gold.COSET_SHIFT))
        rows.append(dict(run="cold" if i == 0 else f"warm{i - 1}", fri_prove_s=out[4], **rec))
        del out
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("default", "sha_provers", "sha_tier", *TIERS, "config4"))
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--expect-sha256", default=None,
                    help="sha_tier, full_tier, ed_tier, north_star: the digest the proof bytes must have")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("prover_ab: no CUDA device", file=sys.stderr)
        return 2
    import blobstreamx_tpu_torch
    from blobstreamx_tpu_torch import kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kernels.build()
    rows = {"default": lambda: default_tier(args.warm), "sha_provers": lambda: sha_provers(args.warm),
            "sha_tier": lambda: sha_tier(args.warm, args.expect_sha256),
            **{t: lambda t=t: skip_tier(t, args.warm, args.expect_sha256) for t in TIERS},
            "config4": lambda: config4(args.warm)}[args.what]()
    print(json.dumps({args.what: rows, "tree": os.path.dirname(os.path.dirname(blobstreamx_tpu_torch.__file__)),
                      "card": smi}))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
