"""Step requests: a relayer following the head, one header at a time.

Request i proves h -> h + 1 with h = 1 + i, the new header's commit signed,
through the program's ``prove_step``.

Faults (``--fault``, never in a measured run), underneath the timed path:

- ``control``: the last validator's vote is dropped from the signed power;
- ``stale``: each request gets the previous request's proof back;
- ``half``: the power sums cover the first half of the validator set;
- ``altered``: one word of the new root in each proof's publics flipped;
- ``nosig``: the signature batch reads as valid, unverified;
- ``nolinks``: the header link reads as sound, unchecked;
- ``novalset``: the validator set is taken to hash to the digest it claims.
"""

from __future__ import annotations

from portbench.harness import proofs
from portbench.reference import consensus, stark_verify

CIRCUIT = "blobstreamx_tpu_torch.circuits.step"


class Op(proofs.ProofStream):
    air = stark_verify.StepAir

    def program_prove(self):
        from blobstreamx_tpu_torch.prover import pipeline

        return lambda w, **kw: pipeline.prove_step(w, **kw)

    def build(self, i: int):
        self.chain.extend(i + 2, {i + 2})
        return self.witness(self.chain, i)

    def witness(self, chain, i: int):
        from blobstreamx_tpu_torch.circuits.step import build_step_witness

        return build_step_witness(chain, 1 + i)

    def heights(self, i: int) -> dict:
        return {"signed": i + 2, "links": (i + 1, i + 1), "sets": (i + 2,)}

    def expected(self, i: int, full: bool, chain=None) -> dict:
        return consensus.step_expected(chain or self.chain, 1 + i, check_signatures=full)


def _patch_result(change):
    """The program's step relation with its result changed by change(res)."""
    def make(original):
        def patched(witness, device=None):
            res = original(witness, device=device)
            change(res)
            return res

        return patched

    return proofs.program_patch("blobstreamx_tpu_torch.prover.pipeline", "verify_step", make)


def _drop_last_vote(res):
    res.signed = res.signed.copy()
    res.signed[-1] = False
    res.signed_power -= int(res.powers[-1])


def _half_set(res):
    half = len(res.powers) // 2
    res.powers, res.signed = res.powers[:half], res.signed[:half]
    res.total_power = int(sum(int(p) for p in res.powers))
    res.signed_power = int(sum(int(p) for p, s in zip(res.powers, res.signed) if s))


FAULTS = {
    "control": lambda op: _patch_result(_drop_last_vote),
    "stale": proofs.stale_fault,
    "half": lambda op: _patch_result(_half_set),
    "altered": lambda op: proofs.altered_fault(op, 10),  # a word of the new root
    "nosig": proofs.skip_signatures_fault,
    "nolinks": lambda op: proofs.skip_links_fault(op, CIRCUIT),
    "novalset": lambda op: proofs.skip_valset_fault(op, CIRCUIT),
}
