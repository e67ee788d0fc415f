"""witness_wait_s (s, program_span; moves proof_s; layer Pipeline): the
harness's own span from asking prove_pipelined for the next proof to the
program's prove being entered, that is the wait for the witness the worker
thread prefetched; the mean a proof over the window's untraced proofs."""


def read(run):
    reqs = [r for r in run.get("requests") or [] if not r["traced"]]
    if run.get("family") != "proof" or not reqs:
        return None
    return sum(r["wait_s"] for r in reqs) / len(reqs)
