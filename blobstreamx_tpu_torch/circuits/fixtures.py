"""Deterministic Tendermint chain fixtures (component C9's data source,
SURVEY.md §2.2: "RPC fetches replaced by fixture loaders"; §7.2 item 5:
"fixture-driven header/validator generation that is itself deterministic and
spec-faithful").

The upstream witness generators fetched headers/validators/commits from a
Tendermint RPC node at prove time (SURVEY.md §3.3 [R]). The reference snapshot
ships no recorded data (SURVEY.md §0), so this module *generates* a
spec-faithful chain from a seed: every header's validators_hash /
next_validators_hash / last_block_id chain links are real (golden
encoding + SHA-256 Merkle), and commits carry real Ed25519 signatures over
canonical sign-bytes (golden RFC 8032). Everything downstream — witness
packing, device kernels, STARK — consumes only this structure, so a future
live-RPC loader can replace this module without touching the circuits.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

from blobstreamx_tpu_torch.golden import ed25519 as ed
from blobstreamx_tpu_torch.golden import encoding as enc

CHAIN_ID = "blobstreamx-tpu-fixture"


@dataclass(frozen=True)
class Validator:
    secret: bytes  # 32-byte Ed25519 seed (fixtures only; real loaders omit it)
    pubkey: bytes  # 32-byte compressed Ed25519 public key
    power: int  # voting power

    def simple_bytes(self) -> bytes:
        return enc.encode_simple_validator(self.pubkey, self.power)


@dataclass(frozen=True)
class ValidatorSet:
    validators: tuple[Validator, ...]

    @property
    def total_power(self) -> int:
        return sum(v.power for v in self.validators)

    def hash(self) -> bytes:
        return enc.validators_hash([(v.pubkey, v.power) for v in self.validators])


@dataclass(frozen=True)
class SignedHeader:
    """A header plus the commit for it (signatures by the *previous* header's
    next-validators = this header's validators, as in Tendermint)."""

    header: enc.Header
    header_hash: bytes
    # commit: per-validator (signed?, signature) aligned with the signing set
    signed: tuple[bool, ...]
    signatures: tuple[bytes, ...]  # empty bytes where signed is False

    def sign_bytes(self) -> bytes:
        return enc.encode_canonical_vote(
            height=self.header.height,
            round_=0,
            block_hash=self.header_hash,
            part_set_total=1,
            part_set_hash=hashlib.sha256(self.header_hash).digest(),
            chain_id=self.header.chain_id,
        )


@dataclass
class ChainFixture:
    """headers[i] has height = first_height + i; val_sets[i] is the set that
    SIGNS headers[i] (i.e. headers[i].validators_hash == val_sets[i].hash())."""

    first_height: int
    headers: list[SignedHeader]
    val_sets: list[ValidatorSet]

    def header_at(self, height: int) -> SignedHeader:
        return self.headers[height - self.first_height]

    def val_set_at(self, height: int) -> ValidatorSet:
        return self.val_sets[height - self.first_height]


def _rng_bytes(seed: bytes, label: str, n: int = 32) -> bytes:
    out = b""
    counter = 0
    while len(out) < n:
        out += hashlib.sha256(seed + label.encode() + counter.to_bytes(4, "little")).digest()
        counter += 1
    return out[:n]


@lru_cache(maxsize=None)
def _keypair(seed: bytes, idx: int) -> tuple[bytes, bytes]:
    secret = _rng_bytes(seed, f"val-secret-{idx}")
    return secret, ed.public_key(secret)


def make_validator_set(seed: bytes, ids: list[int], powers: list[int]) -> ValidatorSet:
    vals = []
    for i, p in zip(ids, powers):
        secret, pub = _keypair(seed, i)
        vals.append(Validator(secret=secret, pubkey=pub, power=p))
    return ValidatorSet(validators=tuple(vals))


def generate_chain(
    seed: int = 0,
    n_headers: int = 64,
    n_validators: int = 4,
    first_height: int = 1,
    rotate_every: int = 0,
    sign_fraction: float = 1.0,
    sign_heights: set[int] | None = None,
) -> ChainFixture:
    """Generate a spec-faithful header chain.

    rotate_every: if > 0, swap one validator in/out every that many heights
    (exercises the skip circuit's trusted-set vs target-commit intersection).
    sign_fraction: fraction of validators (by index prefix) that sign each
    commit where signatures are produced.
    sign_heights: if given, Ed25519 signatures are only *computed* for these
    heights (others get empty commits) — signing is the slow host part and
    skip/step only need the commit at their target height.
    """
    s = hashlib.sha256(b"blobstreamx-fixture" + seed.to_bytes(8, "little")).digest()
    powers = [10 + ((i * 7919) % 17) for i in range(n_validators + n_headers)]

    headers: list[SignedHeader] = []
    val_sets: list[ValidatorSet] = []
    last_block_id_hash = b"\x00" * 32
    last_part_set_hash = b"\x00" * 32

    ids = list(range(n_validators))
    cur_set = make_validator_set(s, ids, [powers[i] for i in ids])

    for k in range(n_headers):
        height = first_height + k
        if rotate_every and k and k % rotate_every == 0:
            # rotate: drop the oldest member, add a fresh one
            ids = ids[1:] + [max(ids) + 1]
            next_set = make_validator_set(s, ids, [powers[i] for i in ids])
        else:
            next_set = cur_set

        header = enc.Header(
            chain_id=CHAIN_ID,
            height=height,
            time_unix_nanos=1_700_000_000_000_000_000 + height * 10**9,
            last_block_id_hash=last_block_id_hash,
            last_part_set_total=1,
            last_part_set_hash=last_part_set_hash,
            last_commit_hash=_rng_bytes(s, f"lch-{height}"),
            data_hash=_rng_bytes(s, f"data-{height}"),
            validators_hash=cur_set.hash(),
            next_validators_hash=next_set.hash(),
            consensus_hash=_rng_bytes(s, "consensus"),
            app_hash=_rng_bytes(s, f"app-{height}"),
            last_results_hash=_rng_bytes(s, f"res-{height}"),
            evidence_hash=hashlib.sha256(b"").digest(),
            proposer_address=_rng_bytes(s, f"prop-{height}", 20),
        )
        header_hash = header.hash()

        n_sign = max(1, int(round(sign_fraction * len(cur_set.validators))))
        signed = tuple(i < n_sign for i in range(len(cur_set.validators)))
        if sign_heights is None or height in sign_heights:
            sh = SignedHeader(header, header_hash, signed, ())
            msg = sh.sign_bytes()
            sigs = tuple(
                ed.sign(v.secret, msg) if signed[i] else b""
                for i, v in enumerate(cur_set.validators)
            )
            sh = SignedHeader(header, header_hash, signed, sigs)
        else:
            sh = SignedHeader(header, header_hash, signed, tuple(b"" for _ in cur_set.validators))

        headers.append(sh)
        val_sets.append(cur_set)
        last_block_id_hash = header_hash
        last_part_set_hash = hashlib.sha256(header_hash).digest()
        cur_set = next_set

    return ChainFixture(first_height=first_height, headers=headers, val_sets=val_sets)
