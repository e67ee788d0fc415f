"""device_idle.proof (%, device_trace; moves proof_s; layer Device): the share
of an untraced proof in which no operation ran on the card: 100 times one
less the device's busy time a traced proof (the union of the device
operations' intervals in the profiler's trace, over the traced proofs) over
the window's wall a proof (as proof_s reads it, untraced). The profiler's
host-operator recording slows the traced proofs' host side by half or more,
so their own wall would read the profiler's overhead as idle time; the
device's busy time is the card's work and does not grow with it. The
traced stretch's own idle gaps by host activity go to the breakdown only."""


def read(run):
    t = run.get("traced")
    untraced = [r for r in run.get("requests") or [] if not r["traced"]]
    if run.get("family") != "proof" or not t or not t["requests"] or t["busy_s"] <= 0 or not untraced:
        return None
    return 100.0 * (1.0 - (t["busy_s"] / t["requests"]) / (run["window_s"] / len(untraced)))
