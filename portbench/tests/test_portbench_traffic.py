"""The traffic generators are deterministic in the seed, give every seed the
same sizes, and the chain is the port's fixture chain."""

from __future__ import annotations

import torch

from portbench.harness import manifest
from portbench.harness.chain import Chain


def _chain(seed, n=4, to=6):
    c = Chain(seed, n, "celestia")
    c.extend(to, {to})
    return c


def test_chain_deterministic_in_the_seed():
    big = 2**31 + 12345  # seeds beyond 32 signed bits
    a, b, c = _chain(big), _chain(big), _chain(big + 1)
    assert [h.header_hash for h in a.headers] == [h.header_hash for h in b.headers]
    assert a.header_at(6).signatures == b.header_at(6).signatures
    assert a.header_at(6).header_hash != c.header_at(6).header_hash
    assert len(a.headers) == len(c.headers) and len(a.header_at(6).signatures) == len(c.header_at(6).signatures)
    assert a.header_at(5).signatures == (b"",) * 4  # unsigned heights carry empty commits


def test_chain_is_the_port_fixture_chain():
    from blobstreamx_tpu_torch.circuits import fixtures

    ours = Chain(11, 4, fixtures.CHAIN_ID)
    ours.extend(12, {10, 12})
    theirs = fixtures.generate_chain(seed=11, n_headers=12, n_validators=4, sign_heights={10, 12})
    for h in range(1, 13):
        assert ours.header_at(h).header_hash == theirs.header_at(h).header_hash
        assert ours.header_at(h).signatures == theirs.header_at(h).signatures
        assert ours.header_at(h).sign_bytes() == theirs.header_at(h).sign_bytes()
        assert ours.val_set_at(h).hash() == theirs.val_set_at(h).hash()


def test_chain_grows_a_range_at_a_time_as_in_one_go():
    whole = _chain(3, to=9)
    parts = Chain(3, 4, "celestia")
    parts.extend(5, set())
    parts.extend(9, {9})
    assert [h.header_hash for h in whole.headers] == [h.header_hash for h in parts.headers]


def test_skip_and_step_requests_are_fixed_by_their_index():
    skip = manifest.load_op("skip")
    cell = manifest.resolve("celestia.skip1000")
    op = skip.Op(cell, 1, torch.device("cpu"))
    assert [op.range_of(i) for i in range(3)] == [(1, 1001), (1001, 2001), (2001, 3001)]


def test_ntt_inputs_deterministic_in_the_seed():
    ntt = manifest.load_op("ntt")
    cell = manifest.resolve("gl2e22.ntt")
    cell.config["log_n"] = 8

    def inputs(seed):
        op = ntt.Op(cell, seed, torch.device("cpu"))
        gen = torch.Generator(device="cpu")
        gen.manual_seed(seed % (1 << 63))
        return op._poly(gen), op._poly(gen)

    (x1, z1), (x2, z2), (x3, _) = inputs(2**31 + 5), inputs(2**31 + 5), inputs(2**31 + 6)
    assert all(torch.equal(a, b) for a, b in zip(x1 + z1, x2 + z2))
    assert not torch.equal(x1[0], x3[0])
    for lo, hi in (x1, z1):
        assert int(lo.max()) < 2**32 and int(hi.max()) < 2**32
        assert not bool(((hi == 2**32 - 1) & (lo > 0)).any())  # canonical: below p


def test_forged_chains_break_what_they_say():
    """Each forgery is fixed by the seed, and the reference reads it as its
    docstring says: a bad signature or absent signers leave power out (the
    request still carries 2/3), a broken link or a lying set is refused."""
    from portbench.harness import forge
    from portbench.reference import consensus

    chain = Chain(2**31 + 7, 8, "celestia")
    chain.extend(9, {9})
    heights = {"signed": 9, "links": (1, 8), "sets": (1, 9)}
    honest = consensus.skip_expected(chain, 1, 9)
    assert honest["accept"]
    for kind in forge.FORGERIES:
        a = forge.forge(kind, chain, 5, heights)
        b = forge.forge(kind, chain, 5, heights)
        assert [a.header_at(h).header_hash for h in range(1, 10)] == [b.header_at(h).header_hash for h in range(1, 10)]
        assert [a.header_at(h).signatures for h in range(1, 10)] == [b.header_at(h).signatures for h in range(1, 10)]
        exp = consensus.skip_expected(a, 1, 9)
        if kind in ("bad_signature", "absent_signers"):
            assert exp["accept"] and exp["publics"][0] < honest["publics"][0], (kind, exp["reasons"])
            assert exp["publics"][1] == honest["publics"][1]
        else:
            assert not exp["accept"] and exp["reasons"], kind
    assert chain.header_at(9).signatures == forge.ChainView(chain).header_at(9).signatures
