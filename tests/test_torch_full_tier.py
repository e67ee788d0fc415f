"""The port's full-coverage SHA-256 tier, prove_skip(with_sha_stark="full"),
against the JAX package on the CPU.

Tier-1 (host code, in-process): the message enumeration, message lengths,
shard plans, shard chains, audit-path directions and BlockID leaf parsing
equal the JAX package's; the claim walk of verify_skip_sha_stark gives the
JAX package's verdict on a real claim stream of several shards (each
package's stark.verify patched to accept, so only the walk decides) and on
seven tampers of it; the sharded serializer gives the JAX package's bytes and
each decoder reads the other's; the pipeline's verifier walks a full proof,
rejects a changed range data hash in its walk and fails closed without
claim data, as the JAX package's does.

The slow test proves the 3-header, 1-validator chain at the full tier on the
CPU (41 blocks in one 64-block shard, a 4096-row SHA STARK), holds the
proof's SHA-256 to a constant (chip_smoke.py phase 4 proves the same chain
on the card and asserts the same constant), has the JAX package's
verifier accept it, and has both packages' verifiers reject each of
chip_smoke.py's FULL_TAMPERS with the verdict named there: three that break
the claim digest binding, one range data hash that only the claim walk can
catch, and a wrong quotient opening in the shard STARK that only its own
check can catch."""

import dataclasses
import hashlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from blobstreamx_tpu.circuits import fixtures as jfx, witness as jwit
from blobstreamx_tpu.prover import pipeline as jax_pipeline, serialize as jax_serialize
from blobstreamx_tpu.prover import skip_claims as jsc, stark as jax_stark
from blobstreamx_tpu.prover.config import StarkConfig as JaxStarkConfig
from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
from blobstreamx_tpu_torch.golden import encoding as enc, merkle as gmerkle, sha256 as gsha
from blobstreamx_tpu_torch.prover import pipeline, serialize, sha_air, skip_claims as sc, stark
from blobstreamx_tpu_torch.prover.config import StarkConfig
from chip_smoke import FULL_TAMPERS, TINY_CFG, TINY_CHAIN, TINY_FULL_PROOF_SHA256, full_tamper

torch.set_num_threads(1)
CFG = StarkConfig(**TINY_CFG)  # tests/test_torch_sha_tier.py's config
JAX_CFG = JaxStarkConfig(**TINY_CFG)
# (generate_chain arguments, trusted, target): test_pipeline's chain over
# 2 -> 10 (119 messages, 220 blocks), and the 3-header, 1-validator chain
CHAINS = {
    "small": (dict(seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75,
                   sign_heights={10}), 2, 10),
    "tiny": (TINY_CHAIN, 1, 2),
}
WALK_MAX_BLOCKS = 64  # several shards and padding ranges on the small chain


@pytest.fixture(scope="module")
def witnesses():
    out = {}
    for name, (gen, trusted, target) in CHAINS.items():
        port = wit.build_skip_witness(fx.generate_chain(**gen), trusted_height=trusted, target_height=target)
        ref = jwit.build_skip_witness(jfx.generate_chain(**gen), trusted_height=trusted, target_height=target)
        out[name] = (port, ref)
    return out


def _vals(vs):
    return [(pk, int(p)) for pk, p in zip(vs.pubkeys, vs.powers)]


@pytest.mark.parametrize("chain", CHAINS)
def test_messages_and_lengths_match_jax(witnesses, chain):
    w, jw = witnesses[chain]
    msgs, link_fields = sc.skip_sha_messages(w)
    assert (msgs, link_fields) == jsc.skip_sha_messages(jw)
    lengths = sc.skip_message_lengths(_vals(w.trusted_set), _vals(w.target_set), link_fields)
    assert lengths == jsc.skip_message_lengths(_vals(jw.trusted_set), _vals(jw.target_set), link_fields)
    assert lengths == [len(m) for m in msgs]
    assert sc._chain_from_lengths(lengths) == jsc._chain_from_lengths(lengths)
    if chain == "small":
        assert len(msgs) == 119 and sum(sc._n_blocks(L) for L in lengths) == 220


@pytest.mark.parametrize("chain", CHAINS)
def test_shard_plans_match_jax(witnesses, chain):
    msgs, _ = sc.skip_sha_messages(witnesses[chain][0])
    lengths = [len(m) for m in msgs]
    for max_blocks in (4096, 64, 16):
        plan = sc.plan_shards(lengths, max_blocks)
        assert plan == jsc.plan_shards(lengths, max_blocks), max_blocks
        for lo, hi, padded in plan:
            assert sc._shard_chain(lengths, lo, hi, padded) == jsc._shard_chain(lengths, lo, hi, padded)


def test_path_dirs_and_leaf_parse_match_jax(witnesses):
    for index in (enc.VALIDATORS_HASH_INDEX, enc.LAST_BLOCK_ID_INDEX, enc.DATA_HASH_INDEX):
        assert sc.path_dirs(enc.HEADER_NUM_FIELDS, index) == jsc.path_dirs(enc.HEADER_NUM_FIELDS, index)
    for total in (1, 300, 1 << 40):
        leaf = wit.block_id_leaf_bytes(bytes(range(32)), total, bytes(range(32, 64)))
        assert sc.parse_block_id_leaf(leaf) == jsc.parse_block_id_leaf(leaf) == (
            bytes(range(32)), total, bytes(range(32, 64)))


def _claim_stream(w, max_blocks):
    """The real aux stream of a full-coverage proof of `w`: per block the
    message words and the compression output (the digest at a message's
    last block), shard pads included; and the shard count."""
    msgs, link_fields = sc.skip_sha_messages(w)
    shards = sc.plan_shards([len(m) for m in msgs], max_blocks)
    aux = []
    for lo, hi, padded in shards:
        chain, blocks = sha_air.plan_blocks(msgs[lo:hi])
        assert len(chain) == padded
        state = None
        for cont, block in zip(chain, blocks):
            state = gsha.compress(state if cont else gsha.h_constants(), block)
            words = tuple(int.from_bytes(block[4 * j : 4 * j + 4], "big") for j in range(16))
            aux.append((words, tuple(state)))
    return aux, link_fields, len(shards)


def _first_pad_block(w, max_blocks) -> int:
    """The index in the claim stream of the first shard-padding block."""
    msgs, _ = sc.skip_sha_messages(w)
    lengths = [len(m) for m in msgs]
    base = 0
    for lo, hi, padded in sc.plan_shards(lengths, max_blocks):
        real = sum(sc._n_blocks(L) for L in lengths[lo:hi])
        if real < padded:
            return base + real
        base += padded
    raise AssertionError("no shard padding")


WALK_TAMPERS = ["none", "aux_digest_word", "link_field", "data_commitment", "dropped_shard", "aux_cut_short",
                "pad_block_words"]


@pytest.mark.parametrize("tamper", WALK_TAMPERS)
def test_claim_walk_matches_jax(witnesses, monkeypatch, tamper):
    w, _ = witnesses["small"]
    aux, link_fields, n_shards = _claim_stream(w, WALK_MAX_BLOCKS)
    assert n_shards >= 4
    commitment = gmerkle.data_commitment([int(h) for h in w.range_heights], w.range_data_hashes)
    starks = [None] * n_shards
    if tamper == "aux_digest_word":
        # the digest of the first validator leaf, which the trusted tree's parent hashes
        (words, out), *rest = aux
        aux = [(words, ((out[0] + 1) & 0xFFFFFFFF,) + out[1:])] + rest
    elif tamper == "link_field":
        (total, psh), *rest = link_fields
        link_fields = [(total, bytes([psh[0] ^ 1]) + psh[1:])] + rest
    elif tamper == "data_commitment":
        commitment = bytes([commitment[0] ^ 1]) + commitment[1:]
    elif tamper == "dropped_shard":
        starks = starks[:-1]
    elif tamper == "aux_cut_short":
        aux = aux[:-1]
    elif tamper == "pad_block_words":  # a shard pad that is not the canonical empty-message block
        k = _first_pad_block(w, WALK_MAX_BLOCKS)
        words, out = aux[k]
        aux = aux[:k] + [((words[0] ^ 1,) + words[1:], out)] + aux[k + 1 :]
    kw = dict(trusted_root=w.trusted_root, target_root=w.target_root, trusted_vals=_vals(w.trusted_set),
              target_vals=_vals(w.target_set), range_heights=[int(h) for h in w.range_heights],
              range_data_hashes=list(w.range_data_hashes), data_commitment=commitment)
    fields = dict(starks=starks, aux=aux, n_rows=64 * len(aux), link_fields=link_fields,
                  max_blocks=WALK_MAX_BLOCKS)
    monkeypatch.setattr(stark, "verify", lambda *a, **k: True)
    monkeypatch.setattr(jax_stark, "verify", lambda *a, **k: True)
    got = sc.verify_skip_sha_stark(sc.SkipShaProof(**fields), config=CFG, **kw)
    want = jsc.verify_skip_sha_stark(jsc.SkipShaProof(**fields), config=JAX_CFG, **kw)
    assert got == want
    assert got is (tamper == "none")


@pytest.fixture(scope="module")
def small_full_proof(witnesses):
    """A full-tier SkipProof of the small chain around the real claim stream
    (every shard entry and the main STARK are one real, small StarkProof),
    with publics that bind its claim digest; each package's STARK check is
    patched in the tests that verify it."""
    w, _ = witnesses["small"]
    aux, link_fields, n_shards = _claim_stream(w, WALK_MAX_BLOCKS)
    trace = pipeline.build_step_trace(SimpleNamespace(powers=np.array([5, 6, 7], np.uint64),
                                                      signed=np.array([1, 1, 0], bool)))
    sp = stark.prove(pipeline.StepAir(), trace, [11, 18] + [0] * 18, CFG, device="cpu")
    sha = sc.SkipShaProof(starks=[sp] * n_shards, aux=aux, n_rows=64 * len(aux), link_fields=link_fields,
                          max_blocks=WALK_MAX_BLOCKS)
    heights = [int(h) for h in w.range_heights]
    outputs = pipeline.SkipPublicOutputs(
        trusted_height=int(w.trusted_height), trusted_root=w.trusted_root, target_height=int(w.target_height),
        target_root=w.target_root, data_commitment=gmerkle.data_commitment(heights, w.range_data_hashes))

    def sums(vs, mask):
        powers = [int(p) for p in vs.powers]
        return sum(p for p, s in zip(powers, mask) if s), sum(powers)

    (st, tt), (sr, tr) = sums(w.target_set, w.target_signed), sums(w.trusted_set, w.trusted_signed)
    res = SimpleNamespace(signed_target_power=st, total_target_power=tt, signed_trusted_power=sr,
                          total_trusted_power=tr)
    publics = pipeline.skip_publics(outputs, res, pipeline.sha_claim_digest(sha))
    return pipeline.SkipProof(outputs=outputs, publics=publics, n_rows=trace.shape[0], stark=sp, timing="",
                              sha_stark=sha, claims=pipeline.claim_data_from_witness(w))


def test_serializer_bytes_equal_jax(witnesses, small_full_proof):
    """The sharded SHA proof's dict and the skip blob that holds it: equal
    bytes from both serializers, and each decoder reads the other's."""
    proof = small_full_proof
    _, jw = witnesses["small"]
    j_starks = [jax_serialize.stark_proof_from_dict(serialize.stark_proof_to_dict(s)) for s in proof.sha_stark.starks]
    j_sha = jsc.SkipShaProof(starks=j_starks, aux=proof.sha_stark.aux, n_rows=proof.sha_stark.n_rows,
                             link_fields=proof.sha_stark.link_fields, max_blocks=proof.sha_stark.max_blocks)
    d = serialize.sha_claims_to_dict(proof.sha_stark)
    assert json.dumps(d) == json.dumps(jax_serialize.sha_claims_to_dict(j_sha))
    assert set(d) == {"aux", "n_rows", "starks", "max_blocks", "link_fields"}
    back = serialize.sha_claims_from_dict(jax_serialize.sha_claims_to_dict(j_sha))
    assert isinstance(back, sc.SkipShaProof) and serialize.sha_claims_to_dict(back) == d
    assert isinstance(jax_serialize.sha_claims_from_dict(d), jsc.SkipShaProof)

    blob = serialize.skip_proof_to_bytes(proof)
    j_proof = jax_pipeline.SkipProof(
        outputs=jax_serialize.skip_proof_from_bytes(blob).outputs, publics=list(proof.publics), n_rows=proof.n_rows,
        stark=jax_serialize.stark_proof_from_dict(serialize.stark_proof_to_dict(proof.stark)), timing="",
        sha_stark=j_sha, claims=jax_pipeline.claim_data_from_witness(jw))
    assert jax_serialize.skip_proof_to_bytes(j_proof) == blob
    assert jax_serialize.skip_proof_to_bytes(jax_serialize.skip_proof_from_bytes(blob)) == blob
    assert serialize.skip_proof_to_bytes(serialize.skip_proof_from_bytes(blob)) == blob


@pytest.mark.parametrize("claims", ["embedded", "none", "no_validator_lists", "range_data_hash"])
def test_pipeline_walk_and_fail_closed_match_jax(small_full_proof, monkeypatch, claims):
    """verify_skip_proof_detailed walks a full proof ("ok: full coverage"),
    rejects one whose embedded range data hash was changed (the claim digest
    still bound, so only the walk can), and fails closed without claim data
    or without the validator lists, as the JAX package's does (its STARK
    checks patched to accept)."""
    proof = small_full_proof
    if claims == "none":
        proof = dataclasses.replace(proof, claims=None)
    elif claims == "no_validator_lists":
        proof = dataclasses.replace(proof, claims=dataclasses.replace(proof.claims, trusted_vals=None))
    elif claims == "range_data_hash":
        proof = full_tamper(proof, claims)
    monkeypatch.setattr(stark, "verify", lambda *a, **k: True)
    monkeypatch.setattr(jax_stark, "verify", lambda *a, **k: True)
    ok, detail = pipeline.verify_skip_proof_detailed(proof, CFG)
    j_ok, j_detail = jax_pipeline.verify_skip_proof_detailed(
        jax_serialize.skip_proof_from_bytes(serialize.skip_proof_to_bytes(proof)), JAX_CFG)
    assert (ok, detail) == (j_ok, j_detail)
    if claims == "embedded":
        assert ok and detail["sha_stark"] == "ok: full coverage" and detail["binding"] == "ok", detail
    elif claims == "range_data_hash":
        assert not ok and detail["sha_stark"] == FULL_TAMPERS[claims], detail
    else:
        assert not ok and detail["sha_stark"] == "failed: claim data unavailable (fail closed)", detail


@pytest.mark.slow
def test_full_tier_end_to_end_tiny_chain(witnesses):
    w, _ = witnesses["tiny"]
    proof = pipeline.prove_skip(w, CFG, device="cpu", with_sha_stark="full")
    assert len(proof.sha_stark.starks) == 1 and proof.sha_stark.n_rows == 64 * 64
    blob = serialize.skip_proof_to_bytes(proof)
    assert hashlib.sha256(blob).hexdigest() == TINY_FULL_PROOF_SHA256
    ok, detail = pipeline.verify_skip_proof_detailed(proof, CFG)
    assert ok and detail["sha_stark"] == "ok: full coverage" and detail["binding"] == "ok", detail

    j_proof = jax_serialize.skip_proof_from_bytes(blob)
    assert jax_serialize.skip_proof_to_bytes(j_proof) == blob
    ok, detail = jax_pipeline.verify_skip_proof_detailed(j_proof, JAX_CFG)
    assert ok and detail["sha_stark"] == "ok: full coverage", detail
    for how, verdict in FULL_TAMPERS.items():
        for verify, p, cfg in ((pipeline.verify_skip_proof_detailed, proof, CFG),
                               (jax_pipeline.verify_skip_proof_detailed, j_proof, JAX_CFG)):
            ok, detail = verify(full_tamper(p, how), cfg)
            assert not ok and detail["sha_stark"] == verdict, (how, detail)
