"""A closed loop of one relayer: a stream of proof requests, each with a
fresh witness, proved through the program's ``prove_pipelined``.

Request i's witness is built on the pipeline's worker thread (the chain's
new headers and signatures, then the program's witness builder) while the
card proves request i - 1. Request 0 is the warm-up, proved during set-up;
the window takes requests 1, 2, ... until ``seconds`` have passed, and ends
with the proof that crosses that mark, so it holds whole proofs only.

For each window proof the harness keeps the wait for its witness (from
asking the pipeline for the next proof to the program's prove being
entered), its prove wall (to a synchronised card), its TimingTree, and what
the host did meanwhile (``hostclock``). After the window, ``probe()`` sends
the traffic's forged requests (``portbench/harness/forge.py``) through the
same prove function, at the heights of the window's last request. Then the
reference works out every proof's publics and outputs from the raw chain,
verifies a sample of the proofs drawn from the seed in full (signatures
and the STARK), and judges each forged request's outcome.

With ``--trace 1`` the profiler then covers ``trace_requests`` more
requests, after the window, so that its start and its stop (seconds each)
fall outside it; the TimingTree readers take the window's proofs alone.

A subclass gives ``build(i)`` (request i's chain grown and its witness),
``witness(chain, i)`` (request i's witness from a chain as it stands),
``heights(i)`` (the heights a forgery may change), ``expected(i, full,
chain)`` (the reference's verdict), ``air`` and the program's prove
function.
"""

from __future__ import annotations

import random
import sys
import threading
import time
import traceback

import torch
from torch.profiler import record_function

from portbench.harness import forge, hostclock, timing
from portbench.harness.chain import Chain
from portbench.reference import stark_verify


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class ProofStream:
    family = "proof"
    air = None

    def __init__(self, cell, seed: int, device):
        self.cfg = cell.config
        self.traffic = cell.traffic
        self.seed = seed
        self.device = device
        self.chain = Chain(seed, int(self.cfg["n_validators"]), self.cfg["chain_id"],
                           float(self.cfg["sign_fraction"]))
        self.params = stark_verify.StarkParams(**self.cfg["stark"])
        self.proofs: list = []
        self.records: list[dict] = []
        self.failed = 0
        self.errors: list[str] = []
        self.warm = None
        self._stop = threading.Event()
        self._enter = self._exit = 0.0
        self._wait_span = None
        self.pipe = None
        self.prove_kwargs: dict = {}
        self.forged: list[dict] = []
        self.host = hostclock.HostClock()

    # --- the subclass's part ------------------------------------------------

    def program_prove(self):
        raise NotImplementedError

    def build(self, i: int):
        raise NotImplementedError

    def witness(self, chain, i: int):
        raise NotImplementedError

    def heights(self, i: int) -> dict:
        raise NotImplementedError

    def expected(self, i: int, full: bool, chain=None) -> dict:
        raise NotImplementedError

    # --- the loop -------------------------------------------------------------

    def _builders(self):
        i = 0
        while True:
            yield (lambda i=i: None if self._stop.is_set() else self.build(i))
            i += 1

    def _prove(self, witness, **kwargs):
        if self._wait_span is not None:  # the witness is here: the wait ends
            self._wait_span.__exit__(None, None, None)
            self._wait_span = None
        self._enter = time.perf_counter()
        with record_function("portbench.prove"):
            proof = self.prove_fn(witness, **kwargs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._exit = time.perf_counter()
        return proof

    def _next(self):
        self._wait_span = record_function("portbench.witness_wait")
        self._wait_span.__enter__()
        try:
            return next(self.pipe)
        finally:
            if self._wait_span is not None:
                self._wait_span.__exit__(None, None, None)
                self._wait_span = None

    def setup(self) -> None:
        from blobstreamx_tpu_torch.prover.config import StarkConfig
        from blobstreamx_tpu_torch.prover.overlap import prove_pipelined

        self.prove_fn = self.program_prove()
        self.prove_kwargs = {"config": StarkConfig(**self.cfg["stark"]), "device": self.device}
        self.pipe = prove_pipelined(
            self._builders(),
            prove_fn=self._prove,
            prefetch=int(self.traffic["prefetch"]),
            **self.prove_kwargs,
        )
        self.warm = self._next()  # request 0: the first witness and a cold prove of the cell's shape

    def _request(self, k: int, traced: bool) -> bool:
        """Prove request k + 1 and keep its record; False when it failed."""
        t_request = time.perf_counter()
        self.host.mark()
        try:
            proof = self._next()
        except Exception:  # a failed request ends the run's requests; the run is not correct
            self.failed += 1
            self.errors.append(f"request {k + 1}: {traceback.format_exc()}")
            return False
        self.proofs.append(proof)
        r = {"request": k + 1, "wait_s": self._enter - t_request, "prove_s": self._exit - self._enter,
             "timing": proof.timing, "traced": traced, "host": self.host.since_mark()}
        self.records.append(r)
        phases = " ".join(f"{p} {timing.phase(r['timing'], p) or 0:.4f}" for p in ("consensus", "trace", "stark"))
        log(f"request {k + 1}: wait {r['wait_s']:.4f} s, prove {r['prove_s']:.4f} s ({phases}; "
            f"{hostclock.describe(r['host'])}){' traced' if traced else ''}")
        return True

    def window(self, seconds: float, tracer) -> dict:
        """The measured window, then (traced runs) trace_requests more
        requests under the profiler, outside the window."""
        self.host.start()
        t_start = time.perf_counter()
        k = 0
        ok = True
        while ok:
            ok = self._request(k, False)
            k += ok
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
        log(f"host over the window: {hostclock.describe(self.host.since_start())}")
        if ok and tracer.enabled:
            tracer.start()
            for _ in range(int(self.traffic.get("trace_requests", 1))):
                if not self._request(k, True):
                    break
                k += 1
                tracer.requests += 1
            tracer.stop()
        self._stop.set()
        self.pipe.close()
        return {"window_s": window_s, "attempted": k + self.failed, "failed": self.failed}

    def probe(self) -> None:
        """The traffic's forged requests, at the heights of the window's
        last request, through the prove function the window drove."""
        last = len(self.proofs)
        heights = self.heights(last)
        for kind in self.traffic.get("forged", []):
            view = forge.forge(kind, self.chain, self.seed, heights)
            t = time.perf_counter()
            try:
                proof, refused = self._prove(self.witness(view, last), **self.prove_kwargs), None
            except Exception as e:  # the program refuses the request
                proof, refused = None, f"{type(e).__name__}: {e}"[:300]
            log(f"forged {kind}: {'refused (' + refused + ')' if refused else 'proved'}, "
                f"{time.perf_counter() - t:.3f} s")
            self.forged.append({"kind": kind, "request": last, "view": view, "proof": proof})

    def release(self) -> None:
        self.pipe = self.warm = None

    def _same(self, proof, exp: dict) -> bool:
        return (
            exp["accept"]
            and [int(v) for v in proof.publics] == exp["publics"]
            and int(proof.n_rows) == exp["n_rows"]
            and all(getattr(proof.outputs, key) == v for key, v in exp["outputs"].items())
        )

    def _judge_forged(self) -> int:
        """Forged requests whose outcome the reference does not allow."""
        wrong = 0
        for f in self.forged:
            exp = self.expected(f["request"], True, f["view"])
            proof = f["proof"]
            if proof is None:
                ok = not exp["accept"] or f["kind"] in forge.MAY_REFUSE
            else:
                ok = self._same(proof, exp) and stark_verify.verify(
                    self.air, proof.stark, exp["publics"], self.params, exp["n_rows"])
            if not ok:
                log(f"forged {f['kind']}: the reference says {'accept' if exp['accept'] else 'refuse'} "
                    f"{exp['reasons']}, the program {'proved' if proof is not None else 'refused'}")
            wrong += not ok
        return wrong

    def check(self) -> dict:
        n = len(self.proofs)
        rng = random.Random(self.seed ^ 0x5EED_C4EC)
        sample = set(rng.sample(range(n), min(int(self.traffic["check_sample"]), n)))
        wrong = rejected = 0
        for j, proof in enumerate(self.proofs):
            full = j in sample
            exp = self.expected(j + 1, full)
            wrong += not self._same(proof, exp)
            if full and not stark_verify.verify(self.air, proof.stark, exp["publics"], self.params, exp["n_rows"]):
                rejected += 1
        n_forged = len(self.traffic.get("forged", []))
        return {
            "wrong_outputs": {"value": wrong, "limit": 0, "is": "at_most"},
            "stark_rejected": {"value": rejected, "limit": 0, "is": "at_most"},
            "wrong_verdicts": {"value": self._judge_forged(), "limit": 0, "is": "at_most"},
            "forged_judged": {"value": len(self.forged), "limit": n_forged, "is": "at_least"},
            "failed_requests": {"value": self.failed, "limit": 0, "is": "at_most"},
            "proofs_compared": {"value": n, "limit": 1, "is": "at_least"},
            "starks_verified": {"value": len(sample), "limit": 1, "is": "at_least"},
        }

    def record(self) -> dict:
        return {"family": self.family, "requests": self.records}


def program_patch(module: str, attr: str, make):
    """Replace the program's `module`.`attr` by make(original); returns the undo."""
    import importlib

    mod = importlib.import_module(module)
    original = getattr(mod, attr)
    setattr(mod, attr, make(original))
    return lambda: setattr(mod, attr, original)


def skip_signatures_fault(op):
    """The signature batch reads as valid without being verified."""
    return program_patch("blobstreamx_tpu_torch.ops.ed25519", "batch_verify",
                         lambda orig: lambda items, *a, **kw: (True, None))


def skip_links_fault(op, circuit: str):
    """Every header link reads as sound without being checked."""
    def make(orig):
        return lambda blocks, n_blocks, siblings, dirs, roots, prev_roots: torch.ones(
            roots.shape[1], dtype=torch.bool, device=roots.device)

    return program_patch(circuit, "_verify_link_leaves", make)


def skip_valset_fault(op, circuit: str):
    """A validator set is taken to hash to the digest it claims, unhashed."""
    import numpy as np

    def make(orig):
        return lambda w, device: np.frombuffer(w.expected_root, dtype=">u4").reshape(8, 1)

    return program_patch(circuit, "_valset_root", make)


def stale_fault(op):
    """Each request gets the previous request's proof back (the first
    window request the warm-up's)."""
    prove = op.prove_fn
    last = [op.warm]

    def stale(w, **kw):
        proof = prove(w, **kw)
        out = last[0]
        last[:] = [proof]
        return out

    op.prove_fn = stale
    return lambda: setattr(op, "prove_fn", prove)


def altered_fault(op, word: int):
    """One bit of publics[word] flipped in every proof, after it is made."""
    prove = op.prove_fn

    def altered(w, **kw):
        proof = prove(w, **kw)
        proof.publics[word] ^= 1
        return proof

    op.prove_fn = altered
    return lambda: setattr(op, "prove_fn", prove)
