"""consensus.data_s (s, program_span; moves proof_s; layer Consensus): the program's
TimingTree node "consensus/data" (the skip proof's data-hash inclusions under each header root and the data commitment's tuple tree), which ends on a synchronised card; the mean a proof over the
window's untraced proofs. None where the program has no such span."""

from portbench.harness import spans


def read(run):
    return spans.mean_child(run, "consensus", "data")
