"""consensus.signatures_s (s, program_span; moves proof_s; layer Consensus): the program's
TimingTree node "consensus/signatures" (the Ed25519 batch: building the batch items and ops.ed25519.batch_verify (host scalar math, the device MSM, the host window combine)), which ends on a synchronised card; the mean a proof over the
window's untraced proofs. None where the program has no such span."""

from portbench.harness import spans


def read(run):
    return spans.mean_child(run, "consensus", "signatures")
