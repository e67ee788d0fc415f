"""stark.quotient_s (s, program_span; moves proof_s; layer STARK): the program's
TimingTree node "stark/quotient" (the constraint quotient over the extended domain and its commitment), which ends on a synchronised card; the mean a proof over the
window's untraced proofs. None where the program has no such span."""

from portbench.harness import spans


def read(run):
    return spans.mean_child(run, "stark", "quotient")
