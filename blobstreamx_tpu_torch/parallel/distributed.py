"""Multi-process bring-up: one process (rank) per card, joined by
torch.distributed.

Launch recipe (one process per rank, each with the same arguments but its
own id):

    # rank 0 (its host holds the store):
    python -m blobstreamx_tpu_torch --coordinator 10.0.0.1:9955 --num-processes 2 \
        --process-id 0 prove-skip ...
    # rank 1:
    python -m blobstreamx_tpu_torch --coordinator 10.0.0.1:9955 --num-processes 2 \
        --process-id 1 prove-skip ...

The environment variables BSX_COORDINATOR / BSX_NUM_PROCESSES /
BSX_PROCESS_ID stand in for the flags where a launcher cannot edit argv. The
same flow runs over loopback on the CPU with the gloo backend
(tests/test_torch_parallel.py).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def add_distributed_args(parser) -> None:
    parser.add_argument(
        "--coordinator",
        default=os.environ.get("BSX_COORDINATOR"),
        help="coordinator address host:port (enables torch.distributed)",
    )
    parser.add_argument(
        "--num-processes",
        type=int,
        default=int(os.environ.get("BSX_NUM_PROCESSES", "0")) or None,
        help="total number of processes in the job",
    )
    parser.add_argument(
        "--process-id",
        type=int,
        default=int(os.environ.get("BSX_PROCESS_ID", "-1")),
        help="this process's rank in [0, num_processes)",
    )


def default_backend(num_processes: int) -> str:
    """NCCL when this host has a card for every process, gloo otherwise (the
    CPU, or several ranks sharing one card: NCCL refuses two ranks on one
    GPU). LOCAL_WORLD_SIZE, where a launcher sets it, is the number of
    processes on this host."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def maybe_initialize(args=None, *, coordinator=None, num_processes=None, process_id=None, backend=None) -> bool:
    """torch.distributed.init_process_group over tcp://<coordinator> when a
    coordinator is configured; returns True if it initialized. Call it
    before any device work. backend: "nccl" or "gloo" (default:
    default_backend)."""
    if args is not None:
        coordinator = coordinator or getattr(args, "coordinator", None)
        num_processes = num_processes or getattr(args, "num_processes", None)
        if process_id is None:
            pid = getattr(args, "process_id", -1)
            process_id = None if pid is None or pid < 0 else pid
    if not coordinator:
        return False
    assert num_processes and process_id is not None, (
        "--coordinator requires --num-processes and --process-id"
    )
    backend = backend or default_backend(int(num_processes))
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
    return True


def global_mesh(device=None):
    """A mesh over every rank of the job (call after maybe_initialize on
    every rank)."""
    from .mesh import make_mesh

    return make_mesh(None, device)
