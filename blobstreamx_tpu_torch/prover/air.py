"""AIR (algebraic intermediate representation) interface for the STARK prover.

There is no circuit DSL. An AIR is a plain Python class whose
``eval_constraints`` writes each constraint as a closed-form polynomial in
the trace frame, using a tiny *algebra* object so the SAME definition runs
in two worlds:

  - on the device, over the whole extended domain at once (elements are
    base-field Gl tensors of shape (n_ext,) — or (n_ext, k) for vectorized
    "matrix" constraints);
  - on the host verifier, at the single out-of-domain point zeta (elements
    are GF(p^2) pairs of python ints; matrix elements are python lists of
    pairs).

Each constraint carries a divisor kind saying where it must vanish:
  'transition' — every row except the last   (Z_H(x) / (x - g^{n-1}))
  'first'      — the first row only          (x - 1)
  'last'       — the last row only           (x - g^{n-1})
  'all'        — every row                   (Z_H(x))

A constraint whose value is a WIDTH-k matrix consumes k consecutive alpha
powers (column j gets alpha^{base+j}); prover and verifier agree because they
run the same eval_constraints code, in order.

Extensions for auxiliary AIRs:
  - fixed_columns(n): preprocessed per-row constants, never committed: both
    sides know the polynomials; the verifier evaluates them at zeta.
  - observe_aux / sample_challenges: post-trace-commit Fiat-Shamir values.
    Claims in ``aux`` are observed BEFORE sampling.
"""

from __future__ import annotations

import numpy as np
import torch

from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.golden import goldilocks as gold

KINDS = ("transition", "first", "last", "all")


def frame_block(alg, frame, a: int, b: int):
    """Columns [a, b) of a trace frame as a width-(b-a) matrix.

    On the device prover the frame is a lazy matrix view exposing .block
    (one slice instead of (b-a) column slices re-concatenated); on the host
    verifier the frame is a plain list and this is alg.stack of the slice.
    Values are identical either way."""
    if hasattr(frame, "block"):
        return frame.block(a, b)
    return alg.stack(frame[a:b])


class DeviceAlgebra:
    """Base-field arithmetic on (n_ext,)-shaped Gl tensors (and (n_ext, k)
    matrices for vectorized constraints), on the device of ``device``."""

    def __init__(self, shape, device=None):
        self.shape = shape
        self.device = device

    def const(self, v: int):
        return gf64.full(self.shape, v % gold.P, self.device)

    def add(self, a, b):
        return gf64.gl_add(a, b)

    def sub(self, a, b):
        return gf64.gl_sub(a, b)

    def mul(self, a, b):
        return gf64.gl_mul(a, b)

    # --- matrix extension ---------------------------------------------------

    def stack(self, cols):
        """[(n,), ...] k columns -> (n, k) matrix."""
        return (
            torch.stack([c[0] for c in cols], dim=1),
            torch.stack([c[1] for c in cols], dim=1),
        )

    def width(self, m) -> int:
        return int(m[0].shape[1]) if m[0].dim() == 2 else 1

    def colv(self, v):
        """Lift an (n,) per-row scalar to an (n, 1) column that broadcasts
        against (n, k) matrices."""
        return (v[0][:, None], v[1][:, None])

    def rotr_bits(self, m, r: int):
        """Value-level rotr by r of a 32-bit word whose bit i (LSB-first) is
        column i: result bit i = input bit (i+r) mod 32."""
        return tuple(torch.roll(c, -r, dims=1) for c in m)

    def shr_bits(self, m, r: int):
        """Value-level logical >> r: result bit i = input bit i+r (0 beyond)."""
        return tuple(torch.nn.functional.pad(c[:, r:], (0, r)) for c in m)

    def _row_consts(self, values: list[int]):
        lo, hi = gf64.from_u64(np.array([v % gold.P for v in values], np.uint64), self.device)
        return lo[None, :], hi[None, :]

    def scale_row(self, m, weights: list[int]):
        """Multiply column j by the constant weights[j]."""
        return gf64.gl_mul(m, self._row_consts(weights))

    def sum_cols(self, m):
        """(n, k) -> (n,) by log-depth pairwise column sums (k need not be a
        power of two)."""
        lo, hi = m
        while lo.shape[1] > 1:
            k = lo.shape[1]
            half = k // 2
            s = gf64.gl_add(
                (lo[:, :half], hi[:, :half]), (lo[:, half : 2 * half], hi[:, half : 2 * half])
            )
            if k % 2:
                lo = torch.cat([s[0], lo[:, -1:]], dim=1)
                hi = torch.cat([s[1], hi[:, -1:]], dim=1)
            else:
                lo, hi = s
        return lo[:, 0], hi[:, 0]

    def wsum(self, m, weights: list[int]):
        """sum_j weights[j] * m[:, j] -> (n,)."""
        return self.sum_cols(self.scale_row(m, weights))

    def const_row(self, values: list[int]):
        """Constant row vector broadcast over rows: (1, k)."""
        return self._row_consts(values)

    def pad_cols(self, m, left: int, right: int):
        """Pad an (n, k) matrix with zero columns on either side."""
        return tuple(torch.nn.functional.pad(c, (left, right)) for c in m)

    def concat_cols(self, *ms):
        """Concatenate matrices along the column axis."""
        return (
            torch.cat([m[0] for m in ms], dim=1),
            torch.cat([m[1] for m in ms], dim=1),
        )


class HostExtAlgebra:
    """GF(p^2) arithmetic on (c0, c1) python-int pairs (verifier at zeta).
    Matrix elements are python lists of pairs; scalar ops broadcast."""

    def const(self, v: int):
        return (v % gold.P, 0)

    def _bin(self, op, a, b):
        if isinstance(a, list) or isinstance(b, list):
            if not isinstance(a, list):
                a = [a] * len(b)
            if not isinstance(b, list):
                b = [b] * len(a)
            return [op(x, y) for x, y in zip(a, b)]
        return op(a, b)

    def add(self, a, b):
        return self._bin(gold.ext_add, a, b)

    def sub(self, a, b):
        return self._bin(gold.ext_sub, a, b)

    def mul(self, a, b):
        return self._bin(gold.ext_mul, a, b)

    # --- matrix extension ---------------------------------------------------

    def stack(self, cols):
        return list(cols)

    def width(self, m) -> int:
        return len(m) if isinstance(m, list) else 1

    def colv(self, v):
        return v  # scalars broadcast against lists in _bin

    def rotr_bits(self, m, r: int):
        return m[r:] + m[:r]

    def shr_bits(self, m, r: int):
        return m[r:] + [(0, 0)] * r

    def scale_row(self, m, weights: list[int]):
        return [gold.ext_mul(x, (w % gold.P, 0)) for x, w in zip(m, weights)]

    def sum_cols(self, m):
        acc = (0, 0)
        for x in m:
            acc = gold.ext_add(acc, x)
        return acc

    def wsum(self, m, weights: list[int]):
        return self.sum_cols(self.scale_row(m, weights))

    def const_row(self, values: list[int]):
        return [(v % gold.P, 0) for v in values]

    def pad_cols(self, m, left: int, right: int):
        return [(0, 0)] * left + list(m) + [(0, 0)] * right

    def concat_cols(self, *ms):
        out = []
        for m in ms:
            out += list(m) if isinstance(m, list) else [m]
        return out


class Air:
    """Base class. Subclasses define the trace width, the constraint list,
    and (for provers) the witness layout."""

    n_cols: int = 0
    n_fixed: int = 0
    n_challenges: int = 0
    n_stage2: int = 0  # challenge-dependent columns, committed after sampling
    max_degree: int = 2  # max total degree of any constraint in trace values
    # Constraints may be split into groups evaluated one after another; group
    # accumulators combine by field addition (exact), and the alpha powers use
    # GLOBAL constraint offsets, so the quotient is identical to one pass.
    n_constraint_groups: int = 1

    def eval_constraints(
        self,
        local,
        nxt,
        publics,
        alg,
        fixed=None,
        fixed_next=None,
        challenges=None,
        stage2=None,
        stage2_next=None,
    ):
        """Return [(value, kind), ...].

        local/nxt: per-column trace values (algebra elements) on the current /
        next row. publics: per-public-input values, ALSO algebra elements
        (on the device, (1,) tensors). fixed/fixed_next: per-fixed-column
        values (device: whole-domain arrays; host: values at zeta / g*zeta).
        challenges: post-commit Fiat-Shamir scalars (algebra elements).
        stage2/stage2_next: per-stage2-column values (the second, challenge-
        dependent trace commitment — e.g. a bus accumulator).
        alg.const is for static literals only. Constraint ORDER and widths
        define the alpha-power assignment and must be identical for prover
        and verifier (it is: same code).
        """
        raise NotImplementedError

    def eval_constraint_group(
        self,
        g: int,
        local,
        nxt,
        publics,
        alg,
        fixed=None,
        fixed_next=None,
        challenges=None,
        stage2=None,
        stage2_next=None,
    ):
        """Constraints of group g (0 <= g < n_constraint_groups). INVARIANT:
        concatenating the groups in order must equal eval_constraints exactly
        (same values, widths, kinds, order) — the alpha assignment depends on
        it. Default: one group == the whole list."""
        assert g == 0 and self.n_constraint_groups == 1
        return self.eval_constraints(
            local,
            nxt,
            publics,
            alg,
            fixed=fixed,
            fixed_next=fixed_next,
            challenges=challenges,
            stage2=stage2,
            stage2_next=stage2_next,
        )

    def build_stage2(self, trace: np.ndarray, challenges: list[int], aux) -> np.ndarray:
        """(n, n_stage2) uint64 challenge-dependent columns (host-built; e.g.
        a Horner bus accumulator). Committed in a second Merkle tree AFTER
        the challenges are sampled, so it may depend on them soundly."""
        raise NotImplementedError

    def fixed_columns(self, n: int) -> np.ndarray | None:
        """(n, n_fixed) uint64 preprocessed columns, or None."""
        return None

    def observe_aux(self, challenger, aux) -> None:
        """Observe post-commit claims (aux) into the transcript."""

    def sample_challenges(self, challenger, aux) -> list[int]:
        """Sample/derive post-commit challenge scalars (base field ints)."""
        return []

    def cache_key(self):
        """Key for instance-VALUE caches (fixed-column tables and their
        LDEs). Airs whose preprocessed values depend on instance parameters
        must include them here."""
        return type(self)

