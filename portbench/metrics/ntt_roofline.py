"""ntt_roofline (%, device_trace; moves ntt_butterflies_per_s; layer
Kernels): the least time the card could take for one ntt_four_step call
over the device time of all kernels the traced calls launched, a call. The
work is counted from the function's shape, not from the kernels that
implement it: each element read once and written once as its (lo, hi)
int64 pair, 32 bytes an element, and one 64 x 64-bit product a butterfly at
16 integer operations; the bound is the larger of bytes over peak bytes/s
and operations over peak operations/s (peaks from the card's row of
portbench/harness/peaks.json; an unknown card reads nothing). At 2^22 on
an H100 the bytes bound it: 134,217,728 B over 3.35 TB/s, 0.040065 ms."""

from portbench.harness import peaks


def work(log_n: int) -> tuple[int, int]:
    """(bytes, integer operations) of one length-2^log_n transform."""
    n = 1 << log_n
    return 32 * n, 16 * (n // 2) * log_n


def read(run):
    t = run.get("traced")
    if run.get("family") != "ntt" or not t or not t["requests"] or t["kernel_s"] <= 0:
        return None
    row = peaks.of(run["device"]["kind"])
    if row is None:
        return None
    bound_s, _ = peaks.bound_s(*work(run["log_n"]), row)
    return 100.0 * bound_s / (t["kernel_s"] / t["requests"])
