"""The process mesh: SPMD over torch.distributed, one process (rank) per shard.

A ``Mesh`` is the first ``n`` ranks of the initialized process group, each
with its own device: ``cuda:<local rank>`` on the card, or the CPU when the
caller asks for it. Every rank runs the same program on its own shard and
the few collectives below move data between them:

- ``all_gather``: equal-shape tensors from every rank, in rank order;
- ``all_to_all``: one chunk to every rank (any sizes), one from every rank;
  the column -> row re-shard of a matrix, the six-step NTT's transpose and
  the FRI re-pairing build on it;
- ``exchange``: send to one rank and receive from another
  (``batch_isend_irecv``), the XOR-partner step of a recursive-doubling
  reduction;
- ``all_gather_object``: small host objects (openings, Merkle paths).

Backend and placement are explicit. NCCL moves CUDA tensors itself; gloo
moves host tensors, so a gloo mesh whose device is the card stages every
collective through host memory (``staging``), by the backend's choice and
never as a reaction to a failure. ``moved`` counts the bytes this rank sent,
by collective.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

A2A_ROUND_BYTES = 1 << 28  # the most one all-to-all round sends to (or takes from) one rank


class Mesh:
    """Ranks ``0 .. size-1`` of the process group, this process's rank among
    them and its device."""

    def __init__(self, group, ranks, device: torch.device, backend: str):
        self.group = group
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(dist.get_rank())
        self.device = device
        self.backend = backend
        self.staging = backend == "gloo" and device.type == "cuda"
        self.moved: dict[str, int] = {}

    def __repr__(self) -> str:
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, backend={self.backend})"

    # -- helpers ---------------------------------------------------------------

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend moves it: on the host under gloo."""
        t = t.contiguous()
        return t.cpu() if self.staging else t

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self.staging else t

    def _count(self, kind: str, nbytes: int) -> None:
        self.moved[kind] = self.moved.get(kind, 0) + int(nbytes)

    # -- collectives -------------------------------------------------------------

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's equal-shape ``t``, in rank order."""
        src = self._wire(t)
        outs = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(outs, src, group=self.group)
        self._count("all_gather", src.numel() * src.element_size() * (self.size - 1))
        return [self._home(o) for o in outs]

    def all_to_all(self, chunks: list[torch.Tensor], recv_shapes: list[tuple], dim: int = 0,
                   out: list[torch.Tensor] | None = None) -> list[torch.Tensor]:
        """Send ``chunks[s]`` to rank s and receive a tensor of
        ``recv_shapes[t]`` from every rank t (one dtype, any sizes, empty
        allowed): ``all_to_all_single`` with uneven splits, in as many rounds
        as keep every message under A2A_ROUND_BYTES (the ranks agree on the
        count), each round a slice of every chunk along ``dim``. The
        received slices are copied into ``out[t]`` (allocated when None;
        views of a caller's tensor are fine), which is returned."""
        dtype = chunks[0].dtype
        item = torch.empty((), dtype=dtype).element_size()
        sizes = [int(c.numel()) for c in chunks] + [int(np.prod(s)) for s in recv_shapes]
        rounds = max(self.all_gather_object(-(-max(sizes + [1]) * item // A2A_ROUND_BYTES)))
        if out is None:
            out = [torch.empty(s, dtype=dtype, device=self.device) for s in recv_shapes]
        for j in range(rounds):
            pieces = [c.narrow(dim, *_span(split_bounds(c.shape[dim], rounds)[j])) for c in chunks]
            spans = [_span(split_bounds(s[dim], rounds)[j]) for s in recv_shapes]
            shapes = [tuple(s[:dim]) + (k,) + tuple(s[dim + 1 :]) for s, (_, k) in zip(recv_shapes, spans)]
            in_splits = [int(x.numel()) for x in pieces]
            out_splits = [int(np.prod(s)) for s in shapes]
            send = torch.cat([self._wire(x).reshape(-1) for x in pieces])
            recv = torch.empty(sum(out_splits), dtype=dtype, device=send.device)
            dist.all_to_all_single(recv, send, out_splits, in_splits, group=self.group)
            self._count("all_to_all", (sum(in_splits) - in_splits[self.rank]) * item)
            at = 0
            for t, (shape, k, (a, n)) in enumerate(zip(shapes, out_splits, spans)):
                out[t].narrow(dim, a, n).copy_(recv[at : at + k].reshape(shape))
                at += k
        return out

    def exchange(self, t: torch.Tensor, send_to: int, recv_from: int, recv_shape=None) -> torch.Tensor:
        """Send ``t`` to mesh rank ``send_to`` and receive a tensor of
        ``recv_shape`` (default ``t``'s) from ``recv_from``."""
        recv_shape = tuple(t.shape) if recv_shape is None else tuple(recv_shape)
        if send_to == self.rank and recv_from == self.rank:
            return t.clone()
        src = self._wire(t)
        buf = torch.empty(recv_shape, dtype=t.dtype, device=src.device)
        ops = [
            dist.P2POp(dist.isend, src, self.ranks[send_to], group=self.group),
            dist.P2POp(dist.irecv, buf, self.ranks[recv_from], group=self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self._count("exchange", src.numel() * src.element_size())
        return self._home(buf)

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out


def local_rank() -> int:
    """This process's index among the processes of its host (LOCAL_RANK when
    a launcher sets it, else the global rank)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def rank_device(device=None) -> torch.device:
    """The rank's own device: ``cuda:<local rank mod cards>`` for "cuda" (or
    None), the CPU for "cpu". A CUDA device without a card raises."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for a mesh of CPU ranks")
        if dev.index is None:
            dev = torch.device("cuda", local_rank() % torch.cuda.device_count())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_mesh(n_devices: int | None = None, device=None) -> Mesh | None:
    """A mesh over the first ``n_devices`` ranks (default: all) of the
    initialized process group. Every rank of the group must call it (the
    sub-group is created collectively); a rank outside the mesh gets None."""
    if torch.device("cuda" if device is None else device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' for a mesh of CPU ranks")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.maybe_initialize first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    assert 1 <= n <= world, f"need {n} ranks, have {world}"
    dev = rank_device(device)
    ranks = list(range(n))
    group = dist.new_group(ranks)
    if dist.get_rank() >= n:
        return None
    return Mesh(group, ranks, dev, dist.get_backend(group))


# -- shard bounds -------------------------------------------------------------------


def _span(bounds: tuple[int, int]) -> tuple[int, int]:
    """[a, b) -> (start, length), narrow's arguments."""
    return bounds[0], bounds[1] - bounds[0]


def split_bounds(n: int, d: int) -> list[tuple[int, int]]:
    """[a, b) of each of d shards of n items, the first n % d one longer
    (torch.tensor_split's rule); shards may be empty."""
    q, r = divmod(n, d)
    out, a = [], 0
    for i in range(d):
        b = a + q + (1 if i < r else 0)
        out.append((a, b))
        a = b
    return out


def col_bounds(n_cols: int, mesh: Mesh) -> tuple[int, int]:
    """This rank's columns [a, b) of an n_cols-column matrix."""
    return split_bounds(n_cols, mesh.size)[mesh.rank]


def cols_to_rows(block: torch.Tensor, widths: list[int], mesh: Mesh) -> torch.Tensor:
    """Column-sharded (..., R, widths[rank]) -> row-sharded (..., R/D,
    sum(widths)): one all-to-all. Rank s holds the s-th run of widths[s]
    columns (any widths, 0 allowed) of a matrix whose row axis is dim -2;
    each rank's columns land straight in their place of the output."""
    d = mesh.size
    lead = tuple(block.shape[:-2])
    rows = block.shape[-2]
    assert rows % d == 0, (rows, d)
    assert len(widths) == d and block.shape[-1] == widths[mesh.rank], (widths, block.shape)
    m = rows // d
    n_cols = sum(widths)
    bounds = [(sum(widths[:s]), sum(widths[: s + 1])) for s in range(d)]
    dim = block.dim() - 2
    out = torch.empty(lead + (m, n_cols), dtype=block.dtype, device=mesh.device)
    chunks = [block.narrow(dim, s * m, m) for s in range(d)]
    mesh.all_to_all(chunks, [lead + (m, b - a) for a, b in bounds], dim=dim,
                    out=[out[..., a:b] for a, b in bounds])
    return out


def reshard_rows(local: torch.Tensor, src: list[tuple[int, int]], want: list[list[tuple[int, int]]],
                 mesh: Mesh) -> list[torch.Tensor]:
    """Move rows between ranks: rank t holds global rows src[t] (``local``,
    rows on dim 0) and rank s wants the ranges want[s]. Returns this rank's
    wanted ranges, one tensor each, gathered in one all-to-all."""
    a0, b0 = src[mesh.rank]

    def pieces(have, ranges):
        out = []
        for a, b in ranges:
            lo, hi = max(a, have[0]), min(b, have[1])
            if lo < hi:
                out.append((lo, hi, a))
        return out

    tail = tuple(local.shape[1:])
    chunks = []
    for s in range(mesh.size):
        ps = pieces((a0, b0), want[s])
        chunks.append(torch.cat([local[lo - a0 : hi - a0] for lo, hi, _ in ps]) if ps
                      else local[:0])
    mine = want[mesh.rank]
    recv_shapes = [(sum(hi - lo for lo, hi, _ in pieces(src[t], mine)),) + tail for t in range(mesh.size)]
    recv = mesh.all_to_all(chunks, recv_shapes)
    out = [[] for _ in mine]
    for t in range(mesh.size):
        at = 0
        for lo, hi, _ in pieces(src[t], mine):
            k = next(i for i, (a, b) in enumerate(mine) if a <= lo and hi <= b)
            out[k].append((lo, recv[t][at : at + hi - lo]))
            at += hi - lo
    return [torch.cat([x for _, x in sorted(parts, key=lambda p: p[0])]) if parts
            else local[:0] for parts in out]
