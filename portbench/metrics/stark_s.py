"""stark_s (s, program_span; moves proof_s; layer STARK): the program's
TimingTree node "stark" (the DEEP-ALI STARK over the consensus trace, FRI included), which ends on a synchronised card; the
mean a proof over the window's untraced proofs."""

from portbench.harness import timing


def read(run):
    reqs = [r for r in run.get("requests") or [] if not r["traced"]]
    if run.get("family") != "proof" or not reqs:
        return None
    values = [timing.phase(r["timing"], "stark") for r in reqs]
    if any(v is None for v in values):
        return None
    return sum(values) / len(values)
