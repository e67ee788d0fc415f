"""ntt_butterflies_per_s (butterflies/s, host clock; moves itself): radix-2
butterflies of the NTT calls completed in the window over the window, which
ends on torch.cuda.synchronize(). A length-2^k transform counts 2^(k-1) * k
butterflies whatever kernels compute it (bench.py's
goldilocks_ntt_butterflies_per_s_per_chip, counted the same way)."""


def butterflies(log_n: int) -> int:
    return (1 << (log_n - 1)) * log_n


def read(run):
    if run.get("family") != "ntt" or not run.get("window_calls"):
        return None
    return run["window_calls"] * butterflies(run["log_n"]) / run["window_s"]
