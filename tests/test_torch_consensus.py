"""Port consensus layer (SHA-256 ops, circuits, witness) vs hashlib, the
golden models and the JAX package, on the CPU, with exact equality."""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from blobstreamx_tpu.circuits import fixtures as jfx, witness as jwit
from blobstreamx_tpu.ops import sha256 as jsha
from blobstreamx_tpu.prover import pipeline as jpipe
from blobstreamx_tpu_torch.circuits import fixtures as tfx, headers as thdr, skip as tskip, validators as tvals
from blobstreamx_tpu_torch.circuits import witness as twit
from blobstreamx_tpu_torch.circuits.data_commitment import data_commitment_device
from blobstreamx_tpu_torch.golden import merkle as gmerkle
from blobstreamx_tpu_torch.ops import sha256 as tsha
from blobstreamx_tpu_torch.prover import pipeline as tpipe

torch.set_num_threads(1)
CHAIN = dict(seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75, sign_heights={10})


@pytest.fixture(scope="module")
def chains():
    return tfx.generate_chain(**CHAIN), jfx.generate_chain(**CHAIN)


def dev(arr):
    return tsha.to_device(arr, "cpu")


@pytest.mark.parametrize("lengths", [(0, 3, 55, 56, 64), (119, 120, 200, 1000)])
def test_sha256_packed_matches_hashlib(lengths):
    rng = np.random.default_rng(sum(lengths))
    msgs = [rng.bytes(n) for n in lengths]
    blocks, n_blocks = tsha.pack_messages_host(msgs)
    got = tsha.digests_to_bytes(tsha.sha256_packed(dev(blocks), dev(n_blocks)))
    assert got == [hashlib.sha256(m).digest() for m in msgs]


def test_packing_matches_jax():
    msgs = [b"", b"abc", bytes(range(130))]
    tb, tn = tsha.pack_messages_host(msgs)
    jb, jn = jsha.pack_messages_host(msgs)
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tn, jn)


def test_inner_and_leaf_hashes_match_hashlib():
    rng = np.random.default_rng(1)
    a, b = [rng.bytes(32) for _ in range(5)], [rng.bytes(32) for _ in range(5)]
    got = tsha.inner_hash_pairs(dev(tsha.bytes32_to_words(a)), dev(tsha.bytes32_to_words(b)))
    assert tsha.digests_to_bytes(got) == [hashlib.sha256(b"\x01" + x + y).digest() for x, y in zip(a, b)]
    leaf = thdr.leaf_hash_32(dev(tsha.bytes32_to_words(a)))
    assert tsha.digests_to_bytes(leaf) == [hashlib.sha256(b"\x00" + x).digest() for x in a]


def test_config1_tuple_root_bit_exact():
    """Config 1: the data-commitment tuple tree over 64 leaves."""
    rng = np.random.default_rng(2)
    heights = list(range(1000, 1064))
    hashes = [rng.bytes(32) for _ in heights]
    want = gmerkle.data_commitment(heights, hashes)
    hlo = np.asarray(heights, np.uint32)
    root = tsha.tuple_tree_root(dev(hlo), dev(np.zeros_like(hlo)), dev(tsha.bytes32_to_words(hashes)))
    assert tsha.digests_to_bytes(root)[0] == want
    assert data_commitment_device(heights, hashes, "cpu") == want


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 12])
def test_data_commitment_any_leaf_count(n):
    rng = np.random.default_rng(n)
    heights = list(range(5, 5 + n))
    hashes = [rng.bytes(32) for _ in heights]
    assert data_commitment_device(heights, hashes, "cpu") == gmerkle.data_commitment(heights, hashes)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_validators_root_matches_golden(n):
    vset = tfx.make_validator_set(b"\x07" * 32, list(range(n)), [10 + i for i in range(n)])
    blocks, n_blocks = tvals.pack_validator_leaves([(v.pubkey, v.power) for v in vset.validators])
    root = tvals.leaf_and_root(dev(blocks), dev(n_blocks))
    assert tsha.digests_to_bytes(root)[0] == vset.hash()


def test_fixture_and_witness_fingerprint_match_jax(chains):
    tchain, jchain = chains
    tw = twit.build_skip_witness(tchain, 2, 10)
    jw = jwit.build_skip_witness(jchain, 2, 10)
    assert tpipe.witness_fingerprint(tw) == jpipe.witness_fingerprint(jw)
    imported = twit.witness_from_reference(dataclasses.asdict(jw))
    assert tpipe.witness_fingerprint(imported) == jpipe.witness_fingerprint(jw)


def test_verify_skip_outputs_and_power_sums(chains):
    tchain, _ = chains
    w = twit.build_skip_witness(tchain, 2, 10)
    res = tskip.verify_skip(w, device="cpu")
    assert res.ok, res.reasons
    assert res.outputs.data_commitment == gmerkle.data_commitment(
        [int(h) for h in w.range_heights], w.range_data_hashes
    )
    assert res.signed_target_power == int(sum(p for p, s in zip(w.target_set.powers, w.target_signed) if s))
    assert res.total_target_power == int(sum(w.target_set.powers))
    assert res.signed_trusted_power == int(sum(p for p, s in zip(w.trusted_set.powers, w.trusted_signed) if s))
    trace = tpipe.build_skip_trace(res)
    assert int(trace[-1, 2]) == res.signed_target_power
    assert int(trace[-1, 7]) == res.total_trusted_power


@pytest.mark.parametrize("tamper", ["data_hash", "chain_link", "signature_mask", "power"])
def test_verify_skip_rejects_tampering(chains, tamper):
    tchain, _ = chains
    w = twit.build_skip_witness(tchain, 2, 10)
    if tamper == "data_hash":
        w.range_data_hashes = [bytes(32)] + list(w.range_data_hashes[1:])
    elif tamper == "chain_link":
        w.chain_links.blocks = w.chain_links.blocks.copy()
        w.chain_links.blocks[0, 1, 3] ^= 1
    elif tamper == "signature_mask":
        w.trusted_signed = ~w.trusted_signed
    else:
        w.target_signed = np.zeros_like(w.target_signed)
        w.target_signed[0] = True
    assert not tskip.verify_skip(w, device="cpu").ok
