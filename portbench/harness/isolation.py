"""Which modules the benchmark may load, by whole top-level name.

The port's package is ``blobstreamx_tpu_torch``; the JAX package it was
ported from is ``blobstreamx_tpu``. A prefix match would let one pass for
the other, so every comparison here is of the top-level name (the part
before the first dot), whole.

- ``forbidden_loaded()``: what of JAX or the JAX package this process has
  loaded; the harness runs it once the window has closed and refuses to
  print a result when it is not empty.
- ``imports_of(path)``: the top-level names a source file imports (its
  ``import`` and ``from`` statements, at any depth), for the static check
  in ``portbench/tests``.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

JAX_SIDE = frozenset({"jax", "jaxlib", "flax", "blobstreamx_tpu"})
PROGRAM = "blobstreamx_tpu_torch"


def top_level(module: str) -> str:
    return module.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if top_level(m) in JAX_SIDE})


def imports_of(path: Path) -> set[str]:
    """Top-level names imported by the file (relative imports are left out:
    they stay inside the benchmark)."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(top_level(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top_level(node.module))
    return out
