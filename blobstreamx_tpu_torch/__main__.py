"""Command-line entry point of the port: the prover-facing surface of a
relayer's operator (the on-chain relayer loop itself is out of scope).

    python -m blobstreamx_tpu_torch prove-skip  --headers 64 --validators 16 \
        --trusted 2 --target 64 --out proof.bin --sha-stark --ed-stark
    python -m blobstreamx_tpu_torch verify-skip --proof proof.bin
    python -m blobstreamx_tpu_torch prove-step  --validators 16
    python -m blobstreamx_tpu_torch selftest

The subcommands, arguments, output (one JSON line on stdout, the
TimingTree on stderr) and exit codes are the JAX package's CLI's, without
its `bench` subcommand and its distributed arguments. Options before the
subcommand: --metrics (JSONL path), --profile-dir (torch.profiler trace
directory) and --device (default cuda: without a card the proving
subcommands exit non-zero before any work; --device cpu runs the plain
PyTorch path). Prover parameters: --rate-bits/--cap-height/--queries/
--pow-bits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_stark_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--rate-bits", type=int, default=None, help="log2 LDE blowup")
    p.add_argument("--cap-height", type=int, default=None, help="Merkle cap height")
    p.add_argument("--queries", type=int, default=None, help="FRI query rounds")
    p.add_argument("--pow-bits", type=int, default=None, help="FRI grinding bits")


def _stark_config(args):
    import dataclasses

    from blobstreamx_tpu_torch.prover.config import StarkConfig

    base = StarkConfig()
    kw = {}
    if args.rate_bits is not None:
        kw["rate_bits"] = args.rate_bits
    if args.cap_height is not None:
        kw["cap_height"] = args.cap_height
    if args.queries is not None:
        kw["num_query_rounds"] = args.queries
    if args.pow_bits is not None:
        kw["proof_of_work_bits"] = args.pow_bits
    return dataclasses.replace(base, **kw) if kw else base


def _device(args):
    """The device a proving subcommand runs on; exits non-zero (nothing
    proven) when it names the card and none is available."""
    from blobstreamx_tpu_torch.device import resolve

    try:
        return resolve(args.device)
    except RuntimeError as e:
        sys.exit(f"blobstreamx_tpu_torch: {e}")


def _maybe_profile(args):
    from blobstreamx_tpu_torch.utils.profiling import maybe_trace

    return maybe_trace(args.profile_dir)


def cmd_prove_skip(args) -> int:
    from blobstreamx_tpu_torch.models import skip
    from blobstreamx_tpu_torch.prover import serialize
    from blobstreamx_tpu_torch.prover.pipeline import claim_data_from_witness
    from blobstreamx_tpu_torch.utils.metrics import MetricsWriter

    device = _device(args)
    config = _stark_config(args)
    metrics = MetricsWriter(args.metrics)
    trusted = args.trusted if args.trusted is not None else 1
    target = args.target if args.target is not None else args.headers
    chain = skip.generate_chain(
        seed=args.seed,
        n_headers=args.headers,
        n_validators=args.validators,
        # Ed25519 signing is the slow host part of fixture generation; the
        # skip relation only consumes the commit at the target height
        sign_heights={target},
    )
    w = skip.build_witness(chain, trusted_height=trusted, target_height=target)
    sha_mode = "full" if args.sha_stark_full else bool(args.sha_stark)
    t0 = time.perf_counter()
    with _maybe_profile(args):
        proof = skip.prove(
            w,
            config=config,
            device=device,
            metrics=metrics,
            checkpoint_dir=args.checkpoint_dir,
            with_sha_stark=sha_mode,
            with_ed_stark=args.ed_stark,
        )
    wall = time.perf_counter() - t0
    blob = skip.to_bytes(proof)
    if args.out:
        with open(args.out, "wb") as f:
            f.write(blob)
    if args.claims_out:
        with open(args.claims_out, "wb") as f:
            f.write(serialize.claim_data_to_bytes(claim_data_from_witness(w)))
    print(proof.timing, file=sys.stderr)
    print(
        json.dumps(
            {
                "workload": "skip",
                "headers": args.headers,
                "validators": args.validators,
                "sha_stark": "full" if sha_mode == "full" else ("tree" if sha_mode else "off"),
                "ed_stark": bool(args.ed_stark),
                "wall_s": wall,
                "data_commitment": proof.outputs.data_commitment.hex(),
                "target_root": proof.outputs.target_root.hex(),
                "proof_bytes": len(blob) if not args.out else None,
                "out": args.out,
                "claims_out": args.claims_out,
            }
        )
    )
    return 0


def cmd_verify_skip(args) -> int:
    from blobstreamx_tpu_torch.models import skip
    from blobstreamx_tpu_torch.prover import serialize
    from blobstreamx_tpu_torch.prover.pipeline import verify_skip_proof_detailed

    try:
        with open(args.proof, "rb") as f:
            proof = skip.from_bytes(f.read())
        claims = None
        if args.claims:
            with open(args.claims, "rb") as f:
                claims = serialize.claim_data_from_bytes(f.read())
    except serialize.ProofDecodeError as e:
        print(json.dumps({"ok": False, "reason": f"malformed proof: {e}"}))
        return 1
    config = _stark_config(args)
    t0 = time.perf_counter()
    # detail says per sub-proof what was verified and what was skipped (a
    # proof carrying aux STARKs verifies them only when --claims supplies
    # the claimed witness data or the proof embeds it)
    ok, detail = verify_skip_proof_detailed(proof, config, claims)
    print(json.dumps({"ok": bool(ok), "verify_s": time.perf_counter() - t0, **detail}))
    return 0 if ok else 1


def cmd_prove_step(args) -> int:
    from blobstreamx_tpu_torch.models import step

    device = _device(args)
    config = _stark_config(args)
    chain = step.generate_chain(seed=args.seed, n_headers=3, n_validators=args.validators)
    w = step.build_witness(chain, prev_height=1)
    t0 = time.perf_counter()
    with _maybe_profile(args):
        proof = step.prove(w, config=config, device=device)
    wall = time.perf_counter() - t0
    ok = step.verify(proof, config=config)
    print(proof.timing, file=sys.stderr)
    print(json.dumps({"workload": "step", "ok": bool(ok), "wall_s": wall}))
    return 0 if ok else 1


def cmd_selftest(args) -> int:
    """Fast end-to-end smoke: a tiny skip proof, proven and verified."""
    from blobstreamx_tpu_torch.models import skip
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    device = _device(args)
    chain = skip.generate_chain(seed=3, n_headers=8, n_validators=4)
    w = skip.build_witness(chain, trusted_height=1, target_height=8)
    proof = skip.prove(w, config=StarkConfig(), device=device)
    ok = skip.verify(proof)
    rt = skip.from_bytes(skip.to_bytes(proof))
    ok2 = skip.verify(rt)
    print(json.dumps({"ok": bool(ok and ok2)}))
    return 0 if (ok and ok2) else 1


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="blobstreamx_tpu_torch")
    parser.add_argument("--metrics", default=None, help="JSONL metrics path")
    parser.add_argument("--profile-dir", default=None, help="torch.profiler trace dir")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain PyTorch path)")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove-skip", help="prove a skip (h1 -> h2) relation")
    p.add_argument("--headers", type=int, default=64)
    p.add_argument("--validators", type=int, default=16)
    p.add_argument("--trusted", type=int, default=None)
    p.add_argument("--target", type=int, default=None)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--out", default=None)
    p.add_argument("--claims-out", default=None, help="write the claim-data bundle (for verify-skip --claims)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--sha-stark", action="store_true", help="prove the data-commitment tuple tree in the batched SHA-256 STARK")
    p.add_argument("--sha-stark-full", action="store_true", help="prove EVERY SHA-256 of the skip relation in the batched STARK")
    p.add_argument("--ed-stark", action="store_true")
    _add_stark_config_args(p)
    p.set_defaults(fn=cmd_prove_skip)

    p = sub.add_parser("verify-skip", help="verify a serialized skip proof")
    p.add_argument("--proof", required=True)
    p.add_argument("--claims", default=None, help="claim-data bundle enabling aux STARK verification")
    _add_stark_config_args(p)
    p.set_defaults(fn=cmd_verify_skip)

    p = sub.add_parser("prove-step", help="prove a step (h -> h+1) relation")
    p.add_argument("--validators", type=int, default=16)
    p.add_argument("--seed", type=int, default=7)
    _add_stark_config_args(p)
    p.set_defaults(fn=cmd_prove_step)

    p = sub.add_parser("selftest", help="tiny end-to-end prove+verify smoke")
    p.set_defaults(fn=cmd_selftest)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
