"""Tendermint byte encodings (golden model, host side).

Spec-derived encodings of the structures the skip/step circuits hash
(SURVEY.md §2.2 C15/C16): protobuf varints, SimpleValidator records,
CanonicalVote sign-bytes, and the 14-field header Merkle root. The reference
snapshot has no code (SURVEY.md §0); these follow the published Tendermint
0.34 canonical encodings, and all consumers (fixtures, witness packing, device
byte tables) go through this single module so the whole stack is internally
bit-consistent.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .merkle import simple_hash_from_byte_slices


def encode_varint(value: int) -> bytes:
    """Protobuf unsigned varint (LEB128)."""
    assert value >= 0
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def encode_tag(field_number: int, wire_type: int) -> bytes:
    return encode_varint((field_number << 3) | wire_type)


def encode_bytes_field(field_number: int, data: bytes) -> bytes:
    return encode_tag(field_number, 2) + encode_varint(len(data)) + data


def encode_varint_field(field_number: int, value: int) -> bytes:
    if value == 0:
        return b""  # proto3 default omitted
    return encode_tag(field_number, 0) + encode_varint(value)


def encode_sfixed64_field(field_number: int, value: int) -> bytes:
    return encode_tag(field_number, 1) + (value & (1 << 64) - 1).to_bytes(8, "little")


def encode_ed25519_pubkey(key: bytes) -> bytes:
    """tendermint.crypto.PublicKey{ed25519=key}."""
    assert len(key) == 32
    return encode_bytes_field(1, key)


def encode_simple_validator(pubkey: bytes, voting_power: int) -> bytes:
    """tendermint.types.SimpleValidator: pub_key (1), voting_power (2)."""
    return encode_bytes_field(1, encode_ed25519_pubkey(pubkey)) + encode_varint_field(
        2, voting_power
    )


def validators_hash(validators: list[tuple[bytes, int]]) -> bytes:
    """Merkle root over protobuf-encoded SimpleValidator leaves (C15)."""
    leaves = [encode_simple_validator(pk, vp) for pk, vp in validators]
    return simple_hash_from_byte_slices(leaves)


# --- CanonicalVote sign-bytes -------------------------------------------------

PRECOMMIT_TYPE = 2


def encode_canonical_block_id(block_hash: bytes, part_set_total: int, part_set_hash: bytes) -> bytes:
    parts = encode_varint_field(1, part_set_total) + encode_bytes_field(2, part_set_hash)
    return encode_bytes_field(1, block_hash) + encode_bytes_field(2, parts)


def encode_canonical_vote(
    height: int,
    round_: int,
    block_hash: bytes,
    part_set_total: int,
    part_set_hash: bytes,
    chain_id: str,
) -> bytes:
    """CanonicalVote sign-bytes, length-prefixed (what validators actually sign):
    type (1, varint), height (2, sfixed64), round (3, sfixed64),
    block_id (4), chain_id (6). Timestamp omitted (canonical zero)."""
    body = (
        encode_varint_field(1, PRECOMMIT_TYPE)
        + encode_sfixed64_field(2, height)
        + encode_sfixed64_field(3, round_)
        + encode_bytes_field(4, encode_canonical_block_id(block_hash, part_set_total, part_set_hash))
        + encode_bytes_field(6, chain_id.encode())
    )
    return encode_varint(len(body)) + body


def parse_canonical_vote(sign_bytes: bytes):
    """Strict inverse of encode_canonical_vote. Returns the dataclass-free
    tuple (height, round, block_hash, part_set_total, part_set_hash,
    chain_id) or None if sign_bytes is not EXACTLY a canonically encoded
    precommit vote (the re-encode check rejects any non-canonical variant, so
    a verifier consuming claimed sign-bytes cannot be fed a malleated
    encoding that hashes differently but parses the same)."""

    def read_varint(b: bytes, i: int):
        v = 0
        shift = 0
        while True:
            if i >= len(b) or shift > 63:
                return None
            c = b[i]
            v |= (c & 0x7F) << shift
            i += 1
            if not c & 0x80:
                return v, i
        return None

    try:
        r = read_varint(sign_bytes, 0)
        if r is None:
            return None
        body_len, i = r
        body = sign_bytes[i:]
        if len(body) != body_len:
            return None
        i = 0
        # field 1 varint: type (precommit)
        if body[i] != (1 << 3):
            return None
        r = read_varint(body, i + 1)
        if r is None or r[0] != PRECOMMIT_TYPE:
            return None
        i = r[1]
        # field 2 sfixed64 height, field 3 sfixed64 round
        if body[i] != (2 << 3 | 1):
            return None
        height = int.from_bytes(body[i + 1 : i + 9], "little")
        i += 9
        if body[i] != (3 << 3 | 1):
            return None
        round_ = int.from_bytes(body[i + 1 : i + 9], "little")
        i += 9
        # field 4 bytes: block_id
        if body[i] != (4 << 3 | 2):
            return None
        r = read_varint(body, i + 1)
        if r is None:
            return None
        blen, i = r
        bid = body[i : i + blen]
        i += blen
        j = 0
        if bid[j] != (1 << 3 | 2) or bid[j + 1] != 32:
            return None
        block_hash = bid[j + 2 : j + 34]
        j += 34
        if bid[j] != (2 << 3 | 2):
            return None
        r = read_varint(bid, j + 1)
        if r is None:
            return None
        plen, j = r
        parts = bid[j : j + plen]
        if j + plen != len(bid):
            return None
        k = 0
        part_set_total = 0
        if parts and parts[0] == (1 << 3):
            r = read_varint(parts, 1)
            if r is None:
                return None
            part_set_total, k = r
        if parts[k] != (2 << 3 | 2) or parts[k + 1] != 32:
            return None
        part_set_hash = parts[k + 2 : k + 34]
        if k + 34 != len(parts):
            return None
        # field 6 bytes: chain_id (rest of body)
        if body[i] != (6 << 3 | 2):
            return None
        r = read_varint(body, i + 1)
        if r is None:
            return None
        clen, i = r
        chain_id = body[i : i + clen].decode()
        if i + clen != len(body):
            return None
    except (IndexError, UnicodeDecodeError):
        return None
    if (
        encode_canonical_vote(
            height, round_, block_hash, part_set_total, part_set_hash, chain_id
        )
        != sign_bytes
    ):
        return None
    return height, round_, block_hash, part_set_total, part_set_hash, chain_id


# --- Header -------------------------------------------------------------------


@dataclass(frozen=True)
class Header:
    """The 14 hashed fields of a Tendermint header, pre-encoded as protobuf
    byte blobs where structured. Field order fixed by the spec."""

    version_block: int = 11
    chain_id: str = "celestia"
    height: int = 1
    time_unix_nanos: int = 0
    last_block_id_hash: bytes = b"\x00" * 32
    last_part_set_total: int = 1
    last_part_set_hash: bytes = b"\x00" * 32
    last_commit_hash: bytes = b"\x00" * 32
    data_hash: bytes = b"\x00" * 32
    validators_hash: bytes = b"\x00" * 32
    next_validators_hash: bytes = b"\x00" * 32
    consensus_hash: bytes = b"\x00" * 32
    app_hash: bytes = b"\x00" * 32
    last_results_hash: bytes = b"\x00" * 32
    evidence_hash: bytes = b"\x00" * 32
    proposer_address: bytes = b"\x00" * 20

    def field_leaves(self) -> list[bytes]:
        version = encode_varint_field(1, self.version_block)
        time_pb = encode_varint_field(1, self.time_unix_nanos // 10**9) + encode_varint_field(
            2, self.time_unix_nanos % 10**9
        )
        block_id = (
            encode_bytes_field(1, self.last_block_id_hash)
            + encode_bytes_field(
                2,
                encode_varint_field(1, self.last_part_set_total)
                + encode_bytes_field(2, self.last_part_set_hash),
            )
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
        return simple_hash_from_byte_slices(self.field_leaves())


# Field indices in the 14-leaf header tree (for header-field inclusion proofs, C16).
DATA_HASH_INDEX = 6
VALIDATORS_HASH_INDEX = 7
NEXT_VALIDATORS_HASH_INDEX = 8
LAST_BLOCK_ID_INDEX = 4
HEADER_NUM_FIELDS = 14
