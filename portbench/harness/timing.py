"""The program's phase times, read from a proof's rendered TimingTree.

``prove_skip`` and ``prove_step`` return ``timing``, the tree rendered one
node a line: two spaces a level, the node's milliseconds right-aligned in
nine characters, " ms  ", its name, and a rate in brackets for nodes that
count items. Each scope of the tree synchronises the card at its end, so a
node's time includes the device work it launched.
"""

from __future__ import annotations

import re

_LINE = re.compile(r"^(?P<lead>\s*)(?P<ms>\d+\.\d+) ms  (?P<name>.*?)(?: \([^()]*/s\))?$")


def parse(rendered: str) -> dict[str, float]:
    """Seconds by node path ("prove_skip/consensus")."""
    out: dict[str, float] = {}
    stack: list[str] = []
    for line in rendered.splitlines():
        m = _LINE.match(line)
        if not m:
            continue
        ms = m.group("ms")
        depth = (len(m.group("lead")) - max(0, 9 - len(ms))) // 2
        del stack[depth:]
        stack.append(m.group("name"))
        path = "/".join(stack)
        out[path] = out.get(path, 0.0) + float(ms) / 1e3
    return out


def phase(rendered: str, name: str) -> float | None:
    """Seconds of the root's child `name`, or None when the tree lacks it."""
    for path, s in parse(rendered).items():
        if path.count("/") == 1 and path.split("/", 1)[1] == name:
            return s
    return None
