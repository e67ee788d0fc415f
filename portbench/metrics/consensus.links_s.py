"""consensus.links_s (s, program_span; moves proof_s; layer Consensus): the program's
TimingTree node "consensus/links" (the header chain links: SHA-256 of each BlockID leaf, its Merkle fold to the header root, the embedded previous root, and the last-root check), which ends on a synchronised card; the mean a proof over the
window's untraced proofs. None where the program has no such span."""

from portbench.harness import spans


def read(run):
    return spans.mean_child(run, "consensus", "links")
