"""Phase pipelining across proofs: host witness builds overlapped with
device proves.

A relayer catching up over many skip intervals pays host witness
generation (fixture packing, byte encoding, scalar prep: Python and numpy)
in series with device work. Here a background worker builds witness i+k
while the card proves witness i: a CUDA launch and a wait on the card
release the GIL, so the two stages overlap on one host. Depth `prefetch`
bounds the live witnesses (double-buffered at 1).

    jobs = [(chain, 1, 64), (chain, 64, 128), ...]
    for proof in prove_pipelined(
        (lambda c=c, a=a, b=b: build_skip_witness(c, a, b)) for c, a, b in jobs
    ):
        ...

The proofs come back in job order. Pipelining reorders host wall-clock
only: each proof's bytes are those of a serial prove.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

from blobstreamx_tpu_torch.prover.pipeline import SkipProof, prove_skip


def prove_pipelined(
    witness_builders: Iterable[Callable[[], object]],
    prove_fn: Callable[..., SkipProof] = prove_skip,
    prefetch: int = 1,
    **prove_kwargs,
) -> Iterator[SkipProof]:
    """Prove a stream of witnesses with host witness builds overlapped
    against device proves. witness_builders yields zero-argument callables
    (each builds one witness on the worker thread); the proofs are yielded
    in order, and a builder's exception is raised in its place.
    prove_kwargs go to prove_fn (device= among them: the card by default).

    prefetch >= 1: how many witnesses may be built ahead of the prover.
    """
    if prefetch < 1:
        raise ValueError(f"prefetch must be at least 1, not {prefetch}")
    it = iter(witness_builders)
    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="witness")
    try:
        pending = []
        try:
            for _ in range(prefetch):
                pending.append(pool.submit(next(it)))
        except StopIteration:
            pass
        exhausted = len(pending) < prefetch
        while pending:
            fut = pending.pop(0)
            witness = fut.result()  # a builder's exception surfaces here, in order
            if not exhausted:
                try:
                    pending.append(pool.submit(next(it)))
                except StopIteration:
                    exhausted = True
            yield prove_fn(witness, **prove_kwargs)
    finally:
        # an early close must not block on an in-flight witness build
        # (shutdown(wait=True) would): cancel what never started and detach
        pool.shutdown(wait=False, cancel_futures=True)
