"""The proof cells' input: a Tendermint header chain made from the seed.

Each header's validators_hash, next_validators_hash and last_block_id link
are real (RFC 6962 trees over protobuf encodings), and the commits of the
heights a request needs carry real Ed25519 signatures over the canonical
precommit sign-bytes. The derivation of every field, key and power from the
seed is the port's fixture generator's (``circuits/fixtures.py``); this
copy belongs to the benchmark, so that a change to the program cannot
change the traffic, and it grows the chain a range at a time, hashing the
validator set once and signing with a fixed-base table.

The program reads a chain through ``header_at(h)`` (``header``,
``header_hash``, ``signed``, ``signatures``, ``sign_bytes()``) and
``val_set_at(h)`` (``validators`` with ``pubkey`` and ``power``, ``hash()``),
the accessors its witness builders take.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from portbench.reference import ed25519, tendermint as tm

GENESIS_TIME_NANOS = 1_700_000_000_000_000_000


def _rng_bytes(seed: bytes, label: str, n: int = 32) -> bytes:
    out = b""
    counter = 0
    while len(out) < n:
        out += hashlib.sha256(seed + label.encode() + counter.to_bytes(4, "little")).digest()
        counter += 1
    return out[:n]


@dataclass(frozen=True)
class Validator:
    pubkey: bytes
    power: int


@dataclass(frozen=True)
class ValidatorSet:
    validators: tuple[Validator, ...]
    digest: bytes

    def hash(self) -> bytes:
        return self.digest


@dataclass(frozen=True)
class SignedHeader:
    header: tm.Header
    header_hash: bytes
    signed: tuple[bool, ...]
    signatures: tuple[bytes, ...]

    def sign_bytes(self) -> bytes:
        return tm.canonical_vote(
            self.header.height, self.header_hash, 1, tm.sha256(self.header_hash), self.header.chain_id
        )


class Chain:
    """A chain from height 1 that grows on demand. Headers are made in
    height order; the commit of a height is signed when `extend` is asked
    to sign it, and is empty otherwise."""

    first_height = 1

    def __init__(self, seed: int, n_validators: int, chain_id: str, sign_fraction: float = 1.0):
        self.seed = hashlib.sha256(b"blobstreamx-fixture" + (seed % (1 << 64)).to_bytes(8, "little")).digest()
        self.chain_id = chain_id
        self.expanded = [ed25519.expand_secret(_rng_bytes(self.seed, f"val-secret-{i}")) for i in range(n_validators)]
        powers = [10 + ((i * 7919) % 17) for i in range(n_validators)]
        vals = tuple(Validator(pubkey=e[2], power=p) for e, p in zip(self.expanded, powers))
        self.val_set = ValidatorSet(vals, tm.validators_hash([(v.pubkey, v.power) for v in vals]))
        n_sign = max(1, int(round(sign_fraction * n_validators)))
        self.signed = tuple(i < n_sign for i in range(n_validators))
        self.headers: list[SignedHeader] = []

    @property
    def head(self) -> int:
        return self.first_height + len(self.headers) - 1

    def header_at(self, height: int) -> SignedHeader:
        return self.headers[height - self.first_height]

    def val_set_at(self, height: int) -> ValidatorSet:
        if not self.first_height <= height <= self.head:
            raise IndexError(height)
        return self.val_set

    def extend(self, to_height: int, sign: set[int]) -> None:
        """Add headers up to `to_height`, signing the commits of `sign`."""
        s = self.seed
        for height in range(self.head + 1, to_height + 1):
            prev = self.headers[-1].header_hash if self.headers else b"\x00" * 32
            header = tm.Header(
                chain_id=self.chain_id,
                height=height,
                time_unix_nanos=GENESIS_TIME_NANOS + height * 10**9,
                last_block_id_hash=prev,
                last_part_set_total=1,
                last_part_set_hash=tm.sha256(prev) if self.headers else b"\x00" * 32,
                last_commit_hash=_rng_bytes(s, f"lch-{height}"),
                data_hash=_rng_bytes(s, f"data-{height}"),
                validators_hash=self.val_set.digest,
                next_validators_hash=self.val_set.digest,
                consensus_hash=_rng_bytes(s, "consensus"),
                app_hash=_rng_bytes(s, f"app-{height}"),
                last_results_hash=_rng_bytes(s, f"res-{height}"),
                evidence_hash=tm.EMPTY_HASH,
                proposer_address=_rng_bytes(s, f"prop-{height}", 20),
            )
            sh = SignedHeader(header, header.hash(), self.signed, tuple(b"" for _ in self.signed))
            if height in sign:
                msg = sh.sign_bytes()
                sigs = tuple(ed25519.sign(e, msg) if on else b"" for e, on in zip(self.expanded, self.signed))
                sh = SignedHeader(header, sh.header_hash, self.signed, sigs)
            self.headers.append(sh)
