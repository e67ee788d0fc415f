"""Tendermint encodings and trees, as Celestia's headers and Blobstream X's
data commitment use them: protobuf varints and fields, SimpleValidator
records, CanonicalVote sign-bytes, the 14-field header tree, RFC 6962
SHA-256 trees and the DataRootTuple commitment. hashlib SHA-256 throughout.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


EMPTY_HASH = sha256(b"")


def encode_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def encode_bytes_field(field_number: int, data: bytes) -> bytes:
    return _tag(field_number, 2) + encode_varint(len(data)) + data


def encode_varint_field(field_number: int, value: int) -> bytes:
    return b"" if value == 0 else _tag(field_number, 0) + encode_varint(value)


def encode_sfixed64_field(field_number: int, value: int) -> bytes:
    return _tag(field_number, 1) + (value & (1 << 64) - 1).to_bytes(8, "little")


def encode_simple_validator(pubkey: bytes, voting_power: int) -> bytes:
    """tendermint.types.SimpleValidator{pub_key: PublicKey{ed25519}, voting_power}."""
    return encode_bytes_field(1, encode_bytes_field(1, pubkey)) + encode_varint_field(2, voting_power)


def split_point(n: int) -> int:
    """The largest power of two strictly below n (RFC 6962, section 2.1)."""
    k = 1
    while k * 2 < n:
        k *= 2
    return k


def simple_hash(leaves: list[bytes]) -> bytes:
    """RFC 6962 root: leaves hashed under 0x00, inner nodes under 0x01."""
    n = len(leaves)
    if n == 0:
        return EMPTY_HASH
    if n == 1:
        return sha256(b"\x00" + leaves[0])
    k = split_point(n)
    return sha256(b"\x01" + simple_hash(leaves[:k]) + simple_hash(leaves[k:]))


def validators_hash(validators: list[tuple[bytes, int]]) -> bytes:
    return simple_hash([encode_simple_validator(pk, vp) for pk, vp in validators])


def data_commitment(heights: list[int], data_hashes: list[bytes]) -> bytes:
    """Blobstream's commitment over a header range: the RFC 6962 root of the
    64-byte DataRootTuple leaves, uint256 big-endian height then data hash."""
    return simple_hash([h.to_bytes(32, "big") + d for h, d in zip(heights, data_hashes)])


def canonical_vote(height: int, block_hash: bytes, part_set_total: int, part_set_hash: bytes,
                   chain_id: str, round_: int = 0) -> bytes:
    """Length-prefixed CanonicalVote sign-bytes of a precommit (type 2)."""
    parts = encode_varint_field(1, part_set_total) + encode_bytes_field(2, part_set_hash)
    block_id = encode_bytes_field(1, block_hash) + encode_bytes_field(2, parts)
    body = (
        encode_varint_field(1, 2)
        + encode_sfixed64_field(2, height)
        + encode_sfixed64_field(3, round_)
        + encode_bytes_field(4, block_id)
        + encode_bytes_field(6, chain_id.encode())
    )
    return encode_varint(len(body)) + body


@dataclass(frozen=True)
class Header:
    """The 14 hashed fields of a Tendermint header, in the spec's order."""

    chain_id: str
    height: int
    time_unix_nanos: int
    last_block_id_hash: bytes
    last_part_set_total: int
    last_part_set_hash: bytes
    last_commit_hash: bytes
    data_hash: bytes
    validators_hash: bytes
    next_validators_hash: bytes
    consensus_hash: bytes
    app_hash: bytes
    last_results_hash: bytes
    evidence_hash: bytes
    proposer_address: bytes
    version_block: int = 11

    def field_leaves(self) -> list[bytes]:
        version = encode_varint_field(1, self.version_block)
        time_pb = encode_varint_field(1, self.time_unix_nanos // 10**9) + encode_varint_field(
            2, self.time_unix_nanos % 10**9
        )
        block_id = encode_bytes_field(1, self.last_block_id_hash) + encode_bytes_field(
            2, encode_varint_field(1, self.last_part_set_total) + encode_bytes_field(2, self.last_part_set_hash)
        )
        return [
            version,
            self.chain_id.encode(),
            encode_varint(self.height),
            time_pb,
            block_id,
            self.last_commit_hash,
            self.data_hash,
            self.validators_hash,
            self.next_validators_hash,
            self.consensus_hash,
            self.app_hash,
            self.last_results_hash,
            self.evidence_hash,
            self.proposer_address,
        ]

    def hash(self) -> bytes:
        return simple_hash(self.field_leaves())
