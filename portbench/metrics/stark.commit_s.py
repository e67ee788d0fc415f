"""stark.commit_s (s, program_span; moves proof_s; layer STARK): the program's
TimingTree node "stark/commit" (the trace's commitment: the trace to the device, its LDE and Poseidon Merkle tree, the cap observed), which ends on a synchronised card; the mean a proof over the
window's untraced proofs. None where the program has no such span."""

from portbench.harness import spans


def read(run):
    return spans.mean_child(run, "stark", "commit")
