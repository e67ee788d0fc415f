"""Binding the Ed25519 scalar-mul auxiliary STARK (prover.ed_air) to the
batch-verification equation.

Statement proven: the random-linear-combination batch equation the
pipeline's device MSM evaluates (ops/ed25519.py,
golden.ed25519.batch_verify_equation):

    sum_i [z_i] R_i + sum_i [z_i h_i mod L] A_i + [(-sum_i z_i s_i) mod L] B
        == identity

Split of labor (the same claim-walking pattern as prover/sha_claims.py):
the STARK proves every variable-base scalar multiplication (2n+1 of them,
one 512-row segment each — the ~253-doubling chains, 99.9% of the work);
the HOST verifier re-derives the public scalars (z_i from the batch
transcript, h_i = SHA-512(R‖A‖M) mod L, the folded B coefficient),
decompresses the R_i/A_i points itself, checks each STARK claim names
exactly the expected (scalar, point), and sums the 2n+1 CLAIMED result
points (tiny: one complete addition each) — the total must be the identity.
The verifier never performs a scalar multiplication."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from blobstreamx_tpu_torch.device import resolve_with_mesh
from blobstreamx_tpu_torch.golden import ed25519 as ged
from blobstreamx_tpu_torch.prover import ed_air, stark, stark_stream
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.utils.timing import maybe_scope

L = ged.L
Q = ged.Q


def _affine(p) -> tuple[int, int]:
    zi = pow(p[2], Q - 2, Q)
    return (p[0] * zi % Q, p[1] * zi % Q)


BASE_AFFINE = (ged.BASE[0], ged.BASE[1])


def batch_msm_pairs(
    items: list[tuple[bytes, bytes, bytes]], zs: list[int] | None = None
):
    """The (scalar, affine point) pairs of the batch equation, in segment
    order: [(z_i, R_i)]*n ++ [(z_i h_i, A_i)]*n ++ [(-sum z_i s_i, B)], padded
    with (0, B) dummies to a power of two. Derivation mirrors
    ops/ed25519.prepare_batch (host scalar math). Returns None if any input
    is malformed, fails to decompress, or s >= L."""
    assert len(items) > 0
    if zs is None:
        from blobstreamx_tpu_torch.ops.ed25519 import derive_z

        zs = derive_z(items)
    r_pairs, a_pairs = [], []
    s_sum = 0
    for (pk, msg, sig), z in zip(items, zs):
        if len(sig) != 64 or len(pk) != 32:
            return None
        s = int.from_bytes(sig[32:], "little")
        if s >= L:
            return None
        h = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
        R = ged.point_decompress(sig[:32])
        A = ged.point_decompress(pk)
        if R is None or A is None:
            return None
        r_pairs.append((z % L, _affine(R)))
        a_pairs.append((z * h % L, _affine(A)))
        s_sum = (s_sum + z * s) % L
    pairs = r_pairs + a_pairs + [((L - s_sum) % L, BASE_AFFINE)]
    n_seg = 1 << (len(pairs) - 1).bit_length()
    pairs += [(0, BASE_AFFINE)] * (n_seg - len(pairs))
    return pairs


@dataclass
class EdStarkProof:
    """The scalar-mul STARK plus its claims; every expected (scalar, point)
    is recomputed by the verifier, so neither is attacker-controlled."""

    stark: stark.StarkProof
    aux: list  # per segment: (scalar, (px, py), (X, Y, Z, T))
    n_rows: int


def prove_batch_stark(
    items: list[tuple[bytes, bytes, bytes]],
    zs: list[int] | None = None,
    config: StarkConfig | None = None,
    device=None,
    timing=None,
    mesh=None,
) -> EdStarkProof:
    """Prove every scalar multiplication of the batch equation in one STARK
    on `device` (default: the card; raises when CUDA is missing unless
    device="cpu" is passed), through stark_stream.prove_auto (the streaming
    prover when the standard one would not fit the device; the proof is the
    same either way). items: [(pubkey32, message, signature64)]. timing: a
    TimingTree that the host trace build and the streaming prover's phases
    are added to. mesh: the STARK runs over its ranks (stark.prove(mesh=)).
    Raises ValueError on malformed input (fail-stop)."""
    device = resolve_with_mesh(device, mesh)
    config = config or StarkConfig(rate_bits=2)
    pairs = batch_msm_pairs(items, zs)
    if pairs is None:
        raise ValueError("malformed batch input (encoding or s >= L)")
    with maybe_scope(timing, "host trace", items=len(pairs), unit="segments"):
        trace, aux = ed_air.build_ed_trace(pairs)
    air = ed_air.EdScalarMulAir(len(pairs))
    proof = stark_stream.prove_auto(air, trace, [], config, aux=aux, device=device, timing=timing, mesh=mesh)
    return EdStarkProof(stark=proof, aux=aux, n_rows=trace.shape[0])


def verify_batch_stark(
    proof: EdStarkProof,
    items: list[tuple[bytes, bytes, bytes]],
    zs: list[int] | None = None,
    config: StarkConfig | None = None,
) -> bool:
    """Host verifier: (a) the STARK holds for the claimed (scalar, point,
    result) triples; (b) each claim names the expected scalar and point of
    the batch equation (re-derived from public data); (c) the claimed
    results sum to the identity."""
    config = config or StarkConfig(rate_bits=2)
    pairs = batch_msm_pairs(items, zs)
    if pairs is None:
        return False
    n_seg = len(pairs)
    if len(proof.aux) != n_seg or proof.n_rows != ed_air.SEG * n_seg:
        return False
    air = ed_air.EdScalarMulAir(n_seg)
    if not stark.verify(air, proof.stark, [], config, proof.n_rows, aux=proof.aux):
        return False
    total = ged.IDENTITY
    for (want_s, want_p), (got_s, got_p, out) in zip(pairs, proof.aux):
        if got_s != want_s or tuple(got_p) != tuple(want_p):
            return False
        total = ged.point_add(total, out)
    return ged.point_equal(total, ged.IDENTITY)
