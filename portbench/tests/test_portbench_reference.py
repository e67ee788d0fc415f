"""The plain reference against hashlib, RFC 8032, a naive O(n^2) NTT and
the definitions it copies; the frozen STARK verifier on a proof the port
makes on the CPU."""

from __future__ import annotations

import hashlib
import random

import numpy as np
import pytest

from portbench.reference import consensus, ed25519, ntt, poseidon, stark_verify, tendermint as tm
from portbench.reference.goldilocks import P


def test_rfc6962_tree_against_hashlib():
    def h(b):
        return hashlib.sha256(b).digest()

    leaves = [bytes([i]) * (i + 1) for i in range(5)]
    l0, l1, l2, l3, l4 = (h(b"\x00" + x) for x in leaves)
    n01, n23 = h(b"\x01" + l0 + l1), h(b"\x01" + l2 + l3)
    assert tm.simple_hash(leaves) == h(b"\x01" + h(b"\x01" + n01 + n23) + l4)
    assert tm.simple_hash(leaves[:1]) == l0
    assert tm.simple_hash([]) == h(b"")
    heights, datas = [7, 8, 9], [h(bytes([i])) for i in range(3)]
    tuples = [x.to_bytes(32, "big") + d for x, d in zip(heights, datas)]
    assert tm.data_commitment(heights, datas) == tm.simple_hash(tuples)


def test_rfc8032_vector_and_roundtrip():
    secret = bytes.fromhex("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60")
    expanded = ed25519.expand_secret(secret)
    assert expanded[2].hex() == "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
    sig = ed25519.sign(expanded, b"")
    assert sig.hex() == (
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065"
        "224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
    )
    assert ed25519.verify(expanded[2], b"", sig)
    assert not ed25519.verify(expanded[2], b"x", sig)
    bad = bytearray(sig)
    bad[40] ^= 1
    assert not ed25519.verify(expanded[2], b"", bytes(bad))


@pytest.mark.parametrize("log_n", [0, 1, 2, 3, 4, 6])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_against_naive(log_n, inverse):
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, P, size=1 << log_n, dtype=np.uint64)
    x[0] = P - 1
    got = [int(v) for v in ntt.ntt(x, inverse)]
    assert got == ntt.naive([int(v) for v in x], inverse)
    if log_n:
        assert [int(v) for v in ntt.ntt(ntt.ntt(x), True)] == [int(v) for v in x]


def test_field_ops_at_edges():
    vals = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63), P - 2, P - 1]
    a = np.array([x for x in vals for _ in vals], dtype=np.uint64)
    b = np.array([y for _ in vals for y in vals], dtype=np.uint64)
    assert [int(v) for v in ntt.mul(a, b)] == [int(x) * int(y) % P for x, y in zip(a, b)]
    assert [int(v) for v in ntt.add(a, b)] == [(int(x) + int(y)) % P for x, y in zip(a, b)]
    assert [int(v) for v in ntt.sub(a, b)] == [(int(x) - int(y)) % P for x, y in zip(a, b)]


def test_poseidon_layers_and_the_port_golden_model():
    from blobstreamx_tpu_torch.golden import poseidon as golden

    rng = random.Random(3)
    for _ in range(8):
        s = [rng.randrange(P) for _ in range(12)]
        assert poseidon._mds(s) == poseidon.mds_table(s)
        assert poseidon.permute(s) == golden.permute(s)
    assert poseidon.round_constants() == golden.round_constants()


@pytest.fixture(scope="module")
def tiny_step():
    """A step proof the port makes on the CPU over a 4-validator chain."""
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    from portbench.harness.chain import Chain

    chain = Chain(5, 4, "celestia")
    chain.extend(3, {3})
    from blobstreamx_tpu_torch.circuits.step import build_step_witness

    proof = pipeline.prove_step(build_step_witness(chain, 2), StarkConfig(), device="cpu")
    return chain, proof


def test_verifier_and_consensus_on_a_port_proof(tiny_step):
    chain, proof = tiny_step
    exp = consensus.step_expected(chain, 2)
    assert exp["accept"] and [int(v) for v in proof.publics] == exp["publics"] and proof.n_rows == exp["n_rows"]
    prm = stark_verify.StarkParams(rate_bits=3, cap_height=1, num_query_rounds=28, proof_of_work_bits=8,
                                   final_poly_len=8)
    assert stark_verify.verify(stark_verify.StepAir, proof.stark, exp["publics"], prm, exp["n_rows"])
    bad = list(exp["publics"])
    bad[0] += 1
    assert not stark_verify.verify(stark_verify.StepAir, proof.stark, bad, prm, exp["n_rows"])
    assert not stark_verify.verify(stark_verify.SkipAir, proof.stark, exp["publics"], prm, exp["n_rows"])
    proof.stark.trace_zeta[0] = ((proof.stark.trace_zeta[0][0] + 1) % P, proof.stark.trace_zeta[0][1])
    assert not stark_verify.verify(stark_verify.StepAir, proof.stark, exp["publics"], prm, exp["n_rows"])


def test_consensus_reads_signatures():
    from portbench.harness.chain import Chain

    chain = Chain(9, 4, "celestia")
    chain.extend(2, {2})
    exp = consensus.step_expected(chain, 1)
    assert exp["publics"][0] == exp["publics"][1]
    sh = chain.header_at(2)
    sigs = list(sh.signatures)
    sigs[0] = sigs[0][:40] + bytes([sigs[0][40] ^ 1]) + sigs[0][41:]
    chain.headers[1] = type(sh)(sh.header, sh.header_hash, sh.signed, tuple(sigs))
    bad = consensus.step_expected(chain, 1)
    assert bad["publics"][0] == exp["publics"][0] - chain.val_set.validators[0].power
    assert consensus.step_expected(chain, 1, check_signatures=False)["publics"] == exp["publics"]
