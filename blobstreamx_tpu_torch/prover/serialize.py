"""Canonical proof (de)serialization — JSON-based, integers only, so the
encoding is lossless and platform-independent (bit-exactness is the
invariant; there are no floats anywhere in a proof). Covers StarkProof and
the default-tier skip proof, in the JAX package's schema: the bytes of a
port proof equal the JAX package's for the same proof, so either package's
verifier reads the other's blobs.
"""

from __future__ import annotations

import json

from blobstreamx_tpu_torch.prover import stark
from blobstreamx_tpu_torch.prover.fri_ext import FriExtLayerProof, FriExtProof, FriExtQueryRound

# SCHEMA history:
#   1  round 3 layout
#   2  round 5: Ed25519 stage-2 paired-ext wells + 67 challenges (the round-4
#      format change that shipped without a bump, ADVICE r4), full-coverage
#      SHA proofs sharded (starks list + max_blocks replaces stark)
# Pre-upgrade blobs now fail at DECODE time with a clear message instead of
# deep in verification.
SCHEMA = 2


class ProofDecodeError(ValueError):
    """A proof/claims blob failed to parse or failed schema validation.

    Raised (never assert, which `python -O` strips) so untrusted bytes map to
    a clean typed rejection instead of an arbitrary crash (ADVICE r3)."""


def _require(cond: bool, why: str) -> None:
    if not cond:
        raise ProofDecodeError(why)


def _decode(parse, b: bytes):
    """Run an untrusted-bytes parser, mapping every malformed-input failure
    mode (bad JSON, missing keys, bad hex, wrong types/arity) to
    ProofDecodeError."""
    try:
        return parse(json.loads(b))
    except ProofDecodeError:
        raise
    except (ValueError, KeyError, TypeError, IndexError, AttributeError) as e:
        raise ProofDecodeError(f"malformed proof blob: {type(e).__name__}: {e}") from e


def _ext(v) -> list[int]:
    return [int(v[0]), int(v[1])]


def _row(r: stark.RowOpening) -> dict:
    return {"row": [int(x) for x in r.row], "path": [[int(x) for x in d] for d in r.path]}


def _unrow(d: dict) -> stark.RowOpening:
    return stark.RowOpening(row=list(d["row"]), path=[list(p) for p in d["path"]])


def stark_proof_to_dict(p: stark.StarkProof) -> dict:
    return {
        "schema": SCHEMA,
        "trace_cap": [[int(x) for x in d] for d in p.trace_cap],
        "quotient_cap": [[int(x) for x in d] for d in p.quotient_cap],
        "stage2_cap": [[int(x) for x in d] for d in p.stage2_cap],
        "trace_zeta": [_ext(v) for v in p.trace_zeta],
        "trace_gzeta": [_ext(v) for v in p.trace_gzeta],
        "stage2_zeta": [_ext(v) for v in p.stage2_zeta],
        "stage2_gzeta": [_ext(v) for v in p.stage2_gzeta],
        "quotient_zeta": [_ext(v) for v in p.quotient_zeta],
        "fri": {
            "caps": [[[int(x) for x in d] for d in cap] for cap in p.fri.caps],
            "final_poly": [_ext(v) for v in p.fri.final_poly],
            "pow_nonce": int(p.fri.pow_nonce),
            "query_rounds": [
                [
                    {"pair": [_ext(l.pair[0]), _ext(l.pair[1])], "path": [[int(x) for x in d] for d in l.path]}
                    for l in qr.layers
                ]
                for qr in p.fri.query_rounds
            ],
        },
        "openings": [
            {
                "trace": [_row(q.trace[0]), _row(q.trace[1])],
                "quotient": [_row(q.quotient[0]), _row(q.quotient[1])],
                "stage2": None
                if q.stage2 is None
                else [_row(q.stage2[0]), _row(q.stage2[1])],
            }
            for q in p.openings
        ],
    }


def stark_proof_from_dict(d: dict) -> stark.StarkProof:
    _require(d.get("schema") == SCHEMA, f"unknown proof schema {d.get('schema')}")
    fri = FriExtProof(
        caps=[[list(x) for x in cap] for cap in d["fri"]["caps"]],
        final_poly=[tuple(v) for v in d["fri"]["final_poly"]],
        pow_nonce=int(d["fri"]["pow_nonce"]),
        query_rounds=[
            FriExtQueryRound(
                layers=[
                    FriExtLayerProof(
                        pair=(tuple(l["pair"][0]), tuple(l["pair"][1])),
                        path=[list(p) for p in l["path"]],
                    )
                    for l in qr
                ]
            )
            for qr in d["fri"]["query_rounds"]
        ],
    )
    openings = [
        stark.QueryOpenings(
            trace=(_unrow(q["trace"][0]), _unrow(q["trace"][1])),
            quotient=(_unrow(q["quotient"][0]), _unrow(q["quotient"][1])),
            stage2=None
            if q.get("stage2") is None
            else (_unrow(q["stage2"][0]), _unrow(q["stage2"][1])),
        )
        for q in d["openings"]
    ]
    return stark.StarkProof(
        trace_cap=[list(x) for x in d["trace_cap"]],
        quotient_cap=[list(x) for x in d["quotient_cap"]],
        trace_zeta=[tuple(v) for v in d["trace_zeta"]],
        trace_gzeta=[tuple(v) for v in d["trace_gzeta"]],
        quotient_zeta=[tuple(v) for v in d["quotient_zeta"]],
        fri=fri,
        openings=openings,
        stage2_cap=[list(x) for x in d["stage2_cap"]],
        stage2_zeta=[tuple(v) for v in d["stage2_zeta"]],
        stage2_gzeta=[tuple(v) for v in d["stage2_gzeta"]],
    )


def stark_proof_to_bytes(p: stark.StarkProof) -> bytes:
    return json.dumps(stark_proof_to_dict(p), separators=(",", ":")).encode()


def stark_proof_from_bytes(b: bytes) -> stark.StarkProof:
    return _decode(stark_proof_from_dict, b)


def skip_proof_to_bytes(p) -> bytes:
    """Serialize a default-tier pipeline.SkipProof (no aux STARKs)."""
    d = {
        "schema": SCHEMA,
        "kind": "skip",
        "outputs": {
            "trusted_height": p.outputs.trusted_height,
            "trusted_root": p.outputs.trusted_root.hex(),
            "target_height": p.outputs.target_height,
            "target_root": p.outputs.target_root.hex(),
            "data_commitment": p.outputs.data_commitment.hex(),
        },
        "publics": [int(x) for x in p.publics],
        "n_rows": int(p.n_rows),
        "stark": stark_proof_to_dict(p.stark),
    }
    return json.dumps(d, separators=(",", ":")).encode()


def skip_proof_from_bytes(b: bytes):
    return _decode(_skip_proof_from_dict, b)


def _skip_proof_from_dict(d: dict):
    from blobstreamx_tpu_torch.circuits.skip import SkipPublicOutputs
    from blobstreamx_tpu_torch.prover import pipeline

    _require(d.get("schema") == SCHEMA and d.get("kind") == "skip", "not a skip proof blob")
    out = SkipPublicOutputs(
        trusted_height=d["outputs"]["trusted_height"],
        trusted_root=bytes.fromhex(d["outputs"]["trusted_root"]),
        target_height=d["outputs"]["target_height"],
        target_root=bytes.fromhex(d["outputs"]["target_root"]),
        data_commitment=bytes.fromhex(d["outputs"]["data_commitment"]),
    )
    _require(
        not any(k in d for k in ("sha_stark", "ed_stark", "claims")),
        "aux STARKs and claim bundles are not part of the default tier",
    )
    return pipeline.SkipProof(
        outputs=out,
        publics=list(d["publics"]),
        n_rows=int(d["n_rows"]),
        stark=stark_proof_from_dict(d["stark"]),
        timing="",
    )
