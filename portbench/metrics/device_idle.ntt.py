"""device_idle.ntt (%, device_trace; moves ntt_butterflies_per_s; layer Device): the share
of the traced stretch in which no operation ran on the card: 100 times one
less the union of the device operations' intervals over the stretch's
length (host clock, the card synchronised at both ends)."""


def read(run):
    t = run.get("traced")
    if run.get("family") != "ntt" or not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
