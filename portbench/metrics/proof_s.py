"""proof_s (s/proof, host clock; moves itself): the measured window's wall
over the proofs completed in it. The window ends with a proof, each proof
ends on a synchronised card, and the witness builds run ahead on the
pipeline's worker thread, so the window holds proving and whatever waits
it causes. Read in the proof cells."""


def read(run):
    reqs = [r for r in run.get("requests") or [] if not r["traced"]]
    if run.get("family") != "proof" or not reqs:
        return None
    return run["window_s"] / len(reqs)
