"""The port's bounded-memory streaming prover (prover.stark_stream) against
its standard prover (prover.stark): byte-identical proofs on SkipAir and on
a toy AIR that needs three column chunks (one ragged), a fixed column, a
stage-2 column, an aux claim observed before the challenge and class row
ranges; the JAX verifier accepts the port's streamed SkipAir proof, and the
JAX package's own prover gives the toy AIR's bytes;
prove_auto's choice on the estimate alone; and _combine_alpha_device keeps a
width-1 (n, 1) constraint from broadcasting against an (n,) one. CPU, small
sizes, exact equality."""

import numpy as np
import pytest
import torch

from blobstreamx_tpu.prover import air as jax_air, pipeline as jax_pipeline, serialize as jax_serialize, stark as jax_stark
from blobstreamx_tpu.prover.config import StarkConfig as JaxStarkConfig
from blobstreamx_tpu_torch.circuits.skip import SkipCheckResult
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.golden import goldilocks as gold
from blobstreamx_tpu_torch.prover import serialize, sha_air, stark, stark_stream
from blobstreamx_tpu_torch.prover.air import Air, DeviceAlgebra, HostExtAlgebra, frame_block
from blobstreamx_tpu_torch.prover.config import StarkConfig
from blobstreamx_tpu_torch.prover.pipeline import SkipAir, build_skip_trace
from blobstreamx_tpu_torch.utils.timing import TimingTree

torch.set_num_threads(1)
P = gold.P
CFG = dict(rate_bits=2, num_query_rounds=4, proof_of_work_bits=2)


def _skip_case():
    """tests/test_stark_stream.py's SkipAir case."""
    rng = np.random.default_rng(7)
    powers = rng.integers(1, 1000, 8).astype(np.uint64)
    signed = np.ones(8, bool)
    total = int(powers.sum())
    res = SkipCheckResult(
        ok=True, reasons=[], outputs=None, target_powers=powers, target_signed=signed,
        trusted_powers=powers, trusted_signed=signed, signed_target_power=total,
        total_target_power=total, signed_trusted_power=total, total_trusted_power=total,
    )
    return build_skip_trace(res), [total] * 4 + [0] * 42


def test_stream_matches_standard_skip_air_and_jax_accepts():
    trace, publics = _skip_case()
    cfg = StarkConfig(**CFG)
    p_std = stark.prove(SkipAir(), trace, publics, cfg, device="cpu")
    p_str = stark_stream.prove_streaming(SkipAir(), trace, publics, cfg, col_chunk=8, device="cpu")
    blob = serialize.stark_proof_to_bytes(p_str)
    assert blob == serialize.stark_proof_to_bytes(p_std)
    assert stark.verify(SkipAir(), p_str, publics, cfg, trace.shape[0])
    j_proof = jax_serialize.stark_proof_from_bytes(blob)
    assert jax_stark.verify(jax_pipeline.SkipAir(), j_proof, publics, JaxStarkConfig(**CFG), trace.shape[0])


class _ToyBody:
    """19 committed columns: c0 with c0' = c0 + f (f the fixed column,
    row mod 3) and 18 bit columns; a stage-2 accumulator acc' = acc*r + c0'
    whose challenge r is sampled after the aux claim is observed; c0's last
    value is public. Two constraint groups (one matrix constraint, then the
    rest). The same definition is the port's ToyAir and the JAX package's
    JaxToyAir."""

    n_cols = 19
    n_fixed = 1
    n_stage2 = 1
    n_challenges = 1
    max_degree = 2
    n_constraint_groups = 2

    def fixed_columns(self, n):
        return (np.arange(n, dtype=np.uint64) % 3).reshape(n, 1)

    def observe_aux(self, challenger, aux):
        challenger.observe_many(aux)

    def sample_challenges(self, challenger, aux):
        return [challenger.sample()]

    def build_stage2(self, trace, challenges, aux):
        out, cur = [], 0
        for v in trace[:, 0]:
            cur = (cur * challenges[0] + int(v)) % P
            out.append(cur)
        return np.array(out, np.uint64).reshape(-1, 1)

    def eval_constraint_group(self, g, local, nxt, publics, alg, fixed=None, fixed_next=None,
                              challenges=None, stage2=None, stage2_next=None):
        if g == 0:
            bits = frame_block(alg, local, 1, 19)
            return [(alg.mul(bits, alg.sub(bits, alg.const_row([1] * 18))), "all")]
        return [
            (alg.sub(nxt[0], alg.add(local[0], fixed[0])), "transition"),
            (alg.sub(stage2_next[0], alg.add(alg.mul(stage2[0], challenges[0]), nxt[0])), "transition"),
            (alg.sub(stage2[0], local[0]), "first"),
            (alg.sub(local[0], publics[0]), "last"),
        ]

    def eval_constraints(self, local, nxt, publics, alg, **frame):
        return [c for g in range(2) for c in self.eval_constraint_group(g, local, nxt, publics, alg, **frame)]


class ToyAir(_ToyBody, Air):
    pass


class JaxToyAir(_ToyBody, jax_air.Air):
    pass


def _toy_case(n=16):
    rng = np.random.default_rng(3)
    trace = np.zeros((n, 19), np.uint64)
    trace[:, 1:] = rng.integers(0, 2, (n, 18))
    c0 = int(rng.integers(0, P, dtype=np.uint64))
    for i in range(n):
        trace[i, 0] = c0
        c0 = (c0 + i % 3) % P
    return trace, [int(trace[-1, 0])], [5, 6, 7]


def test_stream_matches_standard_toy_air(monkeypatch):
    """col_chunk 8 over 19 columns: chunks of 8, 8 and 3; EVAL_BYTES cut so
    each of the 4 classes evaluates in 4 row ranges; with and without the
    coefficient cache. Both provers time the same phases, by name."""
    trace, publics, aux = _toy_case()
    cfg = StarkConfig(**CFG)
    air = ToyAir()
    assert stark_stream._chunk_bounds(19, 8) == [(0, 8), (8, 16), (16, 19)]
    monkeypatch.setattr(stark_stream, "EVAL_BYTES", 4 * 8 * (19 + 1 + 1))
    assert stark_stream._eval_rows(16, 21) == 4
    trees = {name: TimingTree(name) for name in ("standard", "streaming")}
    p_std = stark.prove(air, trace, publics, cfg, aux=aux, device="cpu", timing=trees["standard"])
    assert stark.verify(air, p_std, publics, cfg, trace.shape[0], aux=aux)
    want = serialize.stark_proof_to_bytes(p_std)
    p_str = stark_stream.prove_streaming(air, trace, publics, cfg, aux=aux, col_chunk=8, device="cpu",
                                         timing=trees["streaming"])
    assert serialize.stark_proof_to_bytes(p_str) == want
    # both provers time the same phases under the same names, stage 2 included
    phases = {name: [c.name for c in t.root.children] for name, t in trees.items()}
    assert phases["standard"] == phases["streaming"] == [
        "commit", "aux + stage 2", "quotient", "openings", "deep", "fri", "queries"]
    monkeypatch.setattr(stark_stream, "COEFF_CACHE_BYTES", 0)
    p_str = stark_stream.prove_streaming(air, trace, publics, cfg, aux=aux, col_chunk=8, device="cpu")
    assert serialize.stark_proof_to_bytes(p_str) == want
    assert not stark.verify(air, p_std, publics, cfg, trace.shape[0], aux=[5, 6, 8])


@pytest.mark.slow
def test_toy_air_matches_jax_prover():
    """(slow: about 210 s of XLA compiles of the JAX prover on the CPU.)
    The JAX package's stark.prove on the same toy AIR (fixed column,
    stage-2 column, aux observed before the challenge, two constraint
    groups) gives the bytes of the port's stark.prove and prove_streaming
    (three column chunks), and each verifier accepts the other's proof."""
    trace, publics, aux = _toy_case()
    cfg = StarkConfig(**CFG)
    j_cfg = JaxStarkConfig(**CFG)
    j_blob = jax_serialize.stark_proof_to_bytes(jax_stark.prove(JaxToyAir(), trace, publics, j_cfg, aux=aux))
    p_std = stark.prove(ToyAir(), trace, publics, cfg, aux=aux, device="cpu")
    p_str = stark_stream.prove_streaming(ToyAir(), trace, publics, cfg, aux=aux, col_chunk=8, device="cpu")
    assert serialize.stark_proof_to_bytes(p_std) == j_blob
    assert serialize.stark_proof_to_bytes(p_str) == j_blob
    assert stark.verify(ToyAir(), serialize.stark_proof_from_bytes(j_blob), publics, cfg, trace.shape[0], aux=aux)
    j_proof = jax_serialize.stark_proof_from_bytes(serialize.stark_proof_to_bytes(p_str))
    assert jax_stark.verify(JaxToyAir(), j_proof, publics, j_cfg, trace.shape[0], aux=aux)


def test_prove_auto_choice_by_estimate_alone():
    """Config 5's SHA tier (4096 blocks, 2^18 rows, the default rate_bits 3)
    streams, and so does Sha256Air from 2^14 rows, where prove_streaming is
    the faster on the card; the SkipAir STARK and the tests' small SHA
    proofs do not."""
    sha = sha_air.Sha256Air((False,) * 4096)
    assert stark_stream.estimate_standard_bytes(1 << 18, 1301, StarkConfig()) == 3 * (1 << 21) * 1301 * 16
    assert stark_stream.uses_streaming(sha, 1 << 18, StarkConfig())
    assert not stark_stream.uses_streaming(SkipAir(), 32, StarkConfig())
    assert not stark_stream.uses_streaming(sha, 128, StarkConfig(rate_bits=2))
    # the measured speed crossover: standard up to 2^13 rows, streaming from 2^14
    assert not stark_stream.uses_streaming(sha, 1 << 13, StarkConfig())
    assert stark_stream.uses_streaming(sha, 1 << 14, StarkConfig())
    # the cutover sits between the two: the largest standard SHA prove
    rows = max(n for n in (1 << k for k in range(6, 19)) if not stark_stream.uses_streaming(sha, n, StarkConfig()))
    assert stark_stream.estimate_standard_bytes(rows, 1301, StarkConfig()) <= stark_stream.AUTO_STREAM_BYTES
    assert stark_stream._auto_chunk(1 << 21) == 32


def test_combine_alpha_keeps_width_one_matrices_one_dimensional():
    """An (n, 1) constraint and an (n,) one of the same kind must add to an
    (n,) accumulator, not broadcast to (n, n); n = 5 differs from every other
    dimension (widths 1 and 3, alpha table lengths)."""
    n = 5
    rng = np.random.default_rng(4)

    def rand(*shape):
        return gf64.from_u64(rng.integers(0, P, shape, dtype=np.uint64))

    col, vec, wide = rand(n, 1), rand(n), rand(n, 3)
    alpha = (0x1234567, 0x89ABCDEF)
    cons = [(col, "transition"), (vec, "transition"), (wide, "all"), (vec, "first")]
    pows = stark._PowerTable(stark._ext_to_device(alpha, "cpu"))
    acc = stark._combine_alpha_device(cons, pows, DeviceAlgebra((n,), "cpu"), offset=2)
    assert set(acc) == {"transition", "all", "first"}
    for kind, v in acc.items():
        assert all(c[0].shape == (n,) for c in v), (kind, v[0][0].shape)
    host = HostExtAlgebra()
    for i in range(n):
        row = []
        for m, k in cons:
            vals = gf64.to_u64(m)[i]
            row.append(([(int(x), 0) for x in vals] if vals.ndim else (int(vals), 0), k))
        want = stark._combine_alpha_host([((0, 0), "all"), ((0, 0), "all")] + row, alpha, host)
        for kind, v in acc.items():
            got = (int(gf64.to_u64(v[0])[i]), int(gf64.to_u64(v[1])[i]))
            assert got == want[kind], (kind, i)
