"""consensus.valsets_s (s, program_span; moves proof_s; layer Consensus): the program's
TimingTree node "consensus/valsets" (the validator-set roots (SHA-256 of every validator's leaf, folded to the root) and their inclusion under the header roots: skip the trusted and target sets, step the new set), which ends on a synchronised card; the mean a proof over the
window's untraced proofs. None where the program has no such span."""

from portbench.harness import spans


def read(run):
    return spans.mean_child(run, "consensus", "valsets")
