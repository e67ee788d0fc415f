"""Phase-granular checkpoint/resume: a killed prove resumes at the last
completed phase.

Format: one .npz per phase under <dir>/<run_id>/, holding named uint64/uint32
arrays, plus a JSON sidecar for scalars. Integers only: proofs are
bit-exact, so there is nothing lossy to round-trip. The layout is the JAX
package's, so either package resumes a directory the other wrote.

The .npz is written to a temporary file and renamed into place; the .json
is written after it, so a phase counts as saved only when both exist (a
process killed between the two writes leaves a phase that is proven again).
"""

from __future__ import annotations

import json
import os

import numpy as np


class PhaseCheckpointer:
    """read_only: load only, save nothing (the ranks of a mesh but rank 0,
    which alone writes)."""

    def __init__(self, root: str | None, run_id: str, read_only: bool = False):
        self.dir = os.path.join(root, run_id) if root else None
        self.read_only = read_only
        if self.dir:
            os.makedirs(self.dir, exist_ok=True)

    def _paths(self, phase: str):
        return os.path.join(self.dir, f"{phase}.npz"), os.path.join(self.dir, f"{phase}.json")

    def save(self, phase: str, arrays: dict[str, np.ndarray] | None = None, scalars: dict | None = None):
        if not self.dir or self.read_only:
            return
        npz, js = self._paths(phase)
        tmp = npz + ".tmp"
        with open(tmp, "wb") as f:  # a file handle: savez would append .npz to a name
            np.savez(f, **{k: np.asarray(v) for k, v in (arrays or {}).items()})
        os.replace(tmp, npz)
        with open(js, "w") as f:
            json.dump(scalars or {}, f)

    def load(self, phase: str):
        """Returns (arrays, scalars), or None unless both files of the phase exist."""
        if not self.dir:
            return None
        npz, js = self._paths(phase)
        if not (os.path.exists(npz) and os.path.exists(js)):
            return None
        with np.load(npz) as data:
            arrays = {k: data[k] for k in data.files}
        with open(js) as f:
            scalars = json.load(f)
        return arrays, scalars

    def last_phase(self, order: list[str]) -> str | None:
        """The last phase of `order` whose .npz exists with every phase before it."""
        done = None
        for p in order:
            if self.dir and os.path.exists(self._paths(p)[0]):
                done = p
            else:
                break
        return done
