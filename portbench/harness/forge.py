"""Forged requests: a request of the cell's own size whose chain a relayer
should not be able to prove as it is, or may prove only with the faulty
part left out.

After the window the proof cells send a few such requests through the
program's prove function, each over the heights of the window's last
request, with one change to the raw chain made from the seed:

- ``bad_signature``: one signature of the signed commit has a bit flipped;
  the proof must be refused, or leave that validator's power out;
- ``absent_signers``: a few validators' signatures are missing (still more
  than 2/3 of the power signed): an honest request, which must be proved
  with exactly the signed power that is there;
- ``broken_link``: one header's app_hash is changed, so the next header's
  last_block_id no longer names it; the proof must be refused;
- ``wrong_valset``: one validator of a set the request reads reports more
  power while the set claims its old digest; the proof must be refused.

The reference judges each from the changed chain alone (every signature
verified, every hash recomputed), so a program that skips the signature
batch, the header links or the validator-set hashing reads as not correct.
"""

from __future__ import annotations

import dataclasses
import random

from portbench.harness.chain import SignedHeader, Validator, ValidatorSet

# kinds whose proof may be refused even where the reference would accept
# the request with the faulty part left out
MAY_REFUSE = {"bad_signature"}


class ChainView:
    """A chain read through ``header_at`` and ``val_set_at``, with some
    heights' headers or validator sets replaced."""

    def __init__(self, chain, headers: dict | None = None, sets: dict | None = None):
        self.chain = chain
        self.headers = headers or {}
        self.sets = sets or {}

    def header_at(self, height: int):
        return self.headers.get(height) or self.chain.header_at(height)

    def val_set_at(self, height: int):
        return self.sets.get(height) or self.chain.val_set_at(height)


def bad_signature(chain, rng: random.Random, heights: dict) -> ChainView:
    h = heights["signed"]
    sh = chain.header_at(h)
    k = rng.choice([i for i, s in enumerate(sh.signed) if s])
    sig = bytearray(sh.signatures[k])
    sig[rng.randrange(32)] ^= 1 << rng.randrange(8)  # a bit of R
    sigs = sh.signatures[:k] + (bytes(sig),) + sh.signatures[k + 1:]
    return ChainView(chain, headers={h: dataclasses.replace(sh, signatures=sigs)})


def absent_signers(chain, rng: random.Random, heights: dict) -> ChainView:
    h = heights["signed"]
    sh = chain.header_at(h)
    powers = [v.power for v in chain.val_set_at(h).validators]
    total = sum(powers)
    signed = list(sh.signed)
    sigs = list(sh.signatures)
    left = sum(p for p, s in zip(powers, signed) if s)
    want = rng.randint(1, max(1, len(powers) // 4))
    for k in rng.sample(range(len(powers)), len(powers)):
        if want == 0:
            break
        if signed[k] and 3 * (left - powers[k]) > 2 * total:
            signed[k], sigs[k] = False, b""
            left -= powers[k]
            want -= 1
    return ChainView(chain, headers={h: dataclasses.replace(sh, signed=tuple(signed), signatures=tuple(sigs))})


def broken_link(chain, rng: random.Random, heights: dict) -> ChainView:
    lo, hi = heights["links"]
    h = rng.randint(lo, hi)
    sh = chain.header_at(h)
    header = dataclasses.replace(sh.header, app_hash=rng.randbytes(32))
    return ChainView(chain, headers={h: SignedHeader(header, header.hash(), sh.signed, sh.signatures)})


def wrong_valset(chain, rng: random.Random, heights: dict) -> ChainView:
    h = rng.choice(heights["sets"])
    vset = chain.val_set_at(h)
    k = rng.randrange(len(vset.validators))
    vals = list(vset.validators)
    vals[k] = Validator(vals[k].pubkey, vals[k].power + rng.randint(1, 1000))
    return ChainView(chain, sets={h: ValidatorSet(tuple(vals), vset.digest)})


FORGERIES = {f.__name__: f for f in (bad_signature, absent_signers, broken_link, wrong_valset)}


def forge(kind: str, chain, seed: int, heights: dict) -> ChainView:
    """The chain with the change `kind`, drawn from the seed."""
    rng = random.Random(f"{seed}/{kind}")
    return FORGERIES[kind](chain, rng, heights)
