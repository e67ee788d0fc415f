"""What a skip or a step proof must say, worked out from the raw chain.

The chain is read through plain attributes: ``header_at(h)`` gives an
object with ``header`` (the 14 fields, a ``tendermint.Header``) and
``signatures`` (one per member of the signing set, b"" where absent);
``val_set_at(h).validators`` gives objects with ``pubkey`` and ``power``.
Every hash is recomputed here from the fields; no hash the chain carries is
taken on trust, and a validator set is the (pubkey, power) pairs it lists,
whatever digest it claims. A chain that breaks the relation (a header that
does not link to the one before it, a set that does not hash to its
header's validators_hash, too little signed power) gives ``accept`` false
and its ``reasons``.
"""

from __future__ import annotations

from . import ed25519, tendermint as tm


def words(b: bytes) -> list[int]:
    """32 bytes as 8 big-endian u32 words, as the proofs' publics hold them."""
    return [int.from_bytes(b[i : i + 4], "big") for i in range(0, 32, 4)]


def trace_rows(n_validators: int) -> int:
    """Rows of the consensus STARK: one a validator, padded to a power of
    two, at least 2."""
    n = max(n_validators, 2)
    return 1 << (n - 1).bit_length()


def _valid_signers(chain, height: int, root: bytes, check_signatures: bool) -> set[bytes]:
    """Public keys of the signing set whose precommit over `root` verifies
    (with check_signatures False: whose signature is present)."""
    sh = chain.header_at(height)
    msg = tm.canonical_vote(height, root, 1, tm.sha256(root), sh.header.chain_id)
    out = set()
    for v, sig in zip(chain.val_set_at(height).validators, sh.signatures):
        if sig and (not check_signatures or ed25519.verify(v.pubkey, msg, sig)):
            out.add(v.pubkey)
    return out


def _checked_set(chain, height: int, header: tm.Header, reasons: list[str]) -> list[tuple[bytes, int]]:
    vals = [(v.pubkey, v.power) for v in chain.val_set_at(height).validators]
    if tm.validators_hash(vals) != header.validators_hash:
        reasons.append(f"validator set at {height} does not hash to its header's validators_hash")
    return vals


def skip_expected(chain, trusted: int, target: int, check_signatures: bool = True) -> dict:
    """The publics (46 values) and outputs of the skip proof trusted -> target."""
    trusted_h = chain.header_at(trusted).header
    target_h = chain.header_at(target).header
    trusted_root = trusted_h.hash()
    target_root = target_h.hash()
    prev = trusted_root
    heights, data_hashes, reasons = [], [], []
    for h in range(trusted + 1, target + 1):
        hdr = chain.header_at(h).header
        if hdr.last_block_id_hash != prev:
            reasons.append(f"header {h} does not link to {h - 1}")
        prev = hdr.hash()
        heights.append(h)
        data_hashes.append(hdr.data_hash)
    target_set = _checked_set(chain, target, target_h, reasons)
    trusted_set = _checked_set(chain, trusted, trusted_h, reasons)
    signers = _valid_signers(chain, target, target_root, check_signatures)
    sums = [
        sum(p for pk, p in target_set if pk in signers),
        sum(p for _, p in target_set),
        sum(p for pk, p in trusted_set if pk in signers),
        sum(p for _, p in trusted_set),
    ]
    if not 3 * sums[0] > 2 * sums[1]:
        reasons.append("target commit power <= 2/3")
    if not 3 * sums[2] > sums[3]:
        reasons.append("trusted members' power in the commit <= 1/3")
    commitment = tm.data_commitment(heights, data_hashes)
    publics = sums + words(trusted_root) + words(target_root) + words(commitment) + [trusted, target]
    publics += [0] * 16  # no SHA-256 or Ed25519 aux STARK at the default tier
    return {
        "publics": publics,
        "n_rows": trace_rows(max(len(target_set), len(trusted_set))),
        "outputs": {
            "trusted_height": trusted,
            "trusted_root": trusted_root,
            "target_height": target,
            "target_root": target_root,
            "data_commitment": commitment,
        },
        "accept": not reasons,
        "reasons": reasons,
    }


def step_expected(chain, prev_height: int, check_signatures: bool = True) -> dict:
    """The publics (20 values) and outputs of the step proof h -> h + 1."""
    new_height = prev_height + 1
    prev_h = chain.header_at(prev_height).header
    new_h = chain.header_at(new_height).header
    prev_root = prev_h.hash()
    new_root = new_h.hash()
    reasons = []
    if new_h.last_block_id_hash != prev_root:
        reasons.append(f"header {new_height} does not link to {prev_height}")
    new_set = _checked_set(chain, new_height, new_h, reasons)
    if prev_h.next_validators_hash != new_h.validators_hash:
        reasons.append(f"next_validators_hash of {prev_height} is not {new_height}'s validators_hash")
    signers = _valid_signers(chain, new_height, new_root, check_signatures)
    sums = [sum(p for pk, p in new_set if pk in signers), sum(p for _, p in new_set)]
    if not 3 * sums[0] > 2 * sums[1]:
        reasons.append("commit power <= 2/3")
    return {
        "publics": sums + words(prev_root) + words(new_root) + [prev_height, new_height],
        "n_rows": trace_rows(len(new_set)),
        "outputs": {
            "prev_height": prev_height,
            "prev_root": prev_root,
            "new_height": new_height,
            "new_root": new_root,
        },
        "accept": not reasons,
        "reasons": reasons,
    }
