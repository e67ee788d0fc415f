"""The program's spans inside a phase: the TimingTree nodes one level below
``consensus`` and ``stark`` (``prove_skip/consensus/links``), each ending on
a synchronised card, read from each proof's rendered tree."""

from __future__ import annotations

from portbench.harness import timing


def mean_child(run, parent: str, name: str) -> float | None:
    """Seconds of the node <root>/<parent>/<name>, the mean a proof over the
    window's untraced proofs; None when a proof lacks it (a program without
    the span, or a prove function that does not run that step)."""
    reqs = [r for r in run.get("requests") or [] if not r["traced"]]
    if run.get("family") != "proof" or not reqs:
        return None
    values = []
    for r in reqs:
        found = [s for path, s in timing.parse(r["timing"]).items()
                 if path.count("/") == 2 and path.split("/", 1)[1] == f"{parent}/{name}"]
        if not found:
            return None
        values.append(found[0])
    return sum(values) / len(values)
