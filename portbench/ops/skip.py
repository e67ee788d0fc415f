"""Skip requests: a relayer catching up over consecutive header ranges.

Request i proves trusted -> target over the chain's i-th range (trusted =
1 + i * range, target = trusted + range), the target's commit signed,
through the program's ``prove_skip``.

Faults (``--fault``, never in a measured run) break the timed path
underneath, for the control and the harness's own tests:

- ``control``: the data commitment leaves out the range's last header;
- ``stale``: each request gets the previous request's proof back;
- ``half``: the data commitment covers the first half of the range;
- ``altered``: one word of the target root in each proof's publics flipped;
- ``nosig``: the signature batch reads as valid, unverified;
- ``nolinks``: every header link reads as sound, unchecked;
- ``novalset``: each validator set is taken to hash to the digest it claims.
"""

from __future__ import annotations

from portbench.harness import proofs
from portbench.reference import consensus, stark_verify

CIRCUIT = "blobstreamx_tpu_torch.circuits.skip"


class Op(proofs.ProofStream):
    air = stark_verify.SkipAir

    def program_prove(self):
        from blobstreamx_tpu_torch.prover import pipeline

        return lambda w, **kw: pipeline.prove_skip(w, **kw)

    def range_of(self, i: int) -> tuple[int, int]:
        span = int(self.traffic["range"])
        trusted = 1 + i * span
        return trusted, trusted + span

    def build(self, i: int):
        _, target = self.range_of(i)
        self.chain.extend(target, {target})
        return self.witness(self.chain, i)

    def witness(self, chain, i: int):
        from blobstreamx_tpu_torch.circuits.witness import build_skip_witness

        return build_skip_witness(chain, *self.range_of(i))

    def heights(self, i: int) -> dict:
        trusted, target = self.range_of(i)
        return {"signed": target, "links": (trusted, target - 1), "sets": (trusted, target)}

    def expected(self, i: int, full: bool, chain=None) -> dict:
        trusted, target = self.range_of(i)
        return consensus.skip_expected(chain or self.chain, trusted, target, check_signatures=full)


def _patch_commitment(keep):
    """The program's data commitment over keep(range) of each range."""
    def make(original):
        def patched(heights, data_hashes, device, mesh=None):
            n = keep(len(data_hashes))
            return original(heights[:n], data_hashes[:n], device, mesh=mesh)

        return patched

    return proofs.program_patch(CIRCUIT, "data_commitment_device", make)


FAULTS = {
    "control": lambda op: _patch_commitment(lambda n: n - 1),
    "stale": proofs.stale_fault,
    "half": lambda op: _patch_commitment(lambda n: n // 2),
    "altered": lambda op: proofs.altered_fault(op, 12),  # a word of the target root
    "nosig": proofs.skip_signatures_fault,
    "nolinks": lambda op: proofs.skip_links_fault(op, CIRCUIT),
    "novalset": lambda op: proofs.skip_valset_fault(op, CIRCUIT),
}
