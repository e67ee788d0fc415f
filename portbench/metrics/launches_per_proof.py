"""launches_per_proof (launches/proof, device_trace; moves proof_s; layer
Device): CUDA kernels in the profiler's trace of the traced proofs (whole
proofs, warm), over those proofs. Every kernel counts, the program's own
CUDA kernels and PyTorch's alike."""


def read(run):
    t = run.get("traced")
    if run.get("family") != "proof" or not t or not t["requests"] or not t["kernels"]:
        return None
    return t["kernels"] / t["requests"]
