"""The rank side of tests/test_torch_parallel.py (run as a script, one
process a rank; it imports the port only).

    python tests/torch_parallel_ranks.py RANK WORLD STORE_FILE OUT_DIR [DEVICE [WHAT]]

Joins a gloo process group of four ranks through a file store, makes a CPU
mesh of ranks {0, 1} ("d2") and one of all four ("d4"), runs the sharded
checks on each (the heaviest, D4_ONLY, on "d4" alone; ranks 2 and 3 compute
the single-device references while "d2" runs) and writes what it got to
OUT_DIR/rank<RANK>.pkl: a dict (mesh, check, case) -> value, or the
exception's text if a check raised, with each check's seconds and the bytes
each collective sent. The test holds these values to the single-device port
and the JAX package. With WORLD 2 and DEVICE cuda (tests/test_torch_kernels_cuda.py,
two ranks sharing one card): the "d2" mesh alone, on the card. WHAT
"tiny_ed": only prove_skip(mesh=) of the 3-header chain at the Ed25519 tier
(the slow test), on a mesh of all ranks.
"""

from __future__ import annotations

import pickle
import random
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

P = (1 << 64) - (1 << 32) + 1
CFG = dict(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=4, final_poly_len=4)
TOY_CFG = dict(rate_bits=2, num_query_rounds=4, proof_of_work_bits=2)
SMALL_CHAIN = dict(seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75, sign_heights={10})
NTT_LOGS = (4, 5, 6, 7, 8, 9, 10)
TREE_CAPS = (0, 1, 2, 3)
MSM_CASES = {"n1": (1, 4), "n5": (5, 4), "n8": (8, 4), "wide": (6, 8)}  # N, window bits c
BITWISE_NS = (3, 17)


def gl_input(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def tuple_input(n: int):
    rng = np.random.default_rng(4 + n)
    return list(range(700, 700 + n)), [rng.bytes(32) for _ in range(n)]


def msm_input(n: int, c: int):
    """n random multiples of the base point and n scalars (golden group law)."""
    from blobstreamx_tpu_torch.golden import ed25519 as ged

    rng = random.Random(100 + n + c)
    pts = [ged.point_mul(rng.randrange(1, ged.L), ged.BASE) for _ in range(n)]
    return pts, [rng.randrange(0, ged.L) for _ in range(n)]


def signed_items(n: int, seed: int = 0, tamper: int | None = None):
    from blobstreamx_tpu_torch.golden import ed25519 as ged

    items = []
    for i in range(n):
        secret = bytes([seed]) + bytes([i]) * 31
        msg = f"sharded header {i}".encode()
        items.append((ged.public_key(secret), msg, ged.sign(secret, msg)))
    if tamper is not None:
        pk, msg, sig = items[tamper]
        items[tamper] = (pk, msg + b"!", sig)
    return items


def small_witness():
    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit

    return wit.build_skip_witness(fx.generate_chain(**SMALL_CHAIN), trusted_height=2, target_height=10)


class _ToyBody:
    """tests/test_torch_stark_stream.py's toy AIR: 19 committed columns (c0
    with c0' = c0 + f, f the fixed column row mod 3, and 18 bit columns), a
    stage-2 accumulator acc' = acc*r + c0' whose challenge r is sampled after
    the aux claim, c0's last value public, two constraint groups."""

    n_cols = 19
    n_fixed = 1
    n_stage2 = 1
    n_challenges = 1
    max_degree = 2
    n_constraint_groups = 2

    def fixed_columns(self, n):
        return (np.arange(n, dtype=np.uint64) % 3).reshape(n, 1)

    def observe_aux(self, challenger, aux):
        challenger.observe_many(aux)

    def sample_challenges(self, challenger, aux):
        return [challenger.sample()]

    def build_stage2(self, trace, challenges, aux):
        out, cur = [], 0
        for v in trace[:, 0]:
            cur = (cur * challenges[0] + int(v)) % P
            out.append(cur)
        return np.array(out, np.uint64).reshape(-1, 1)

    def eval_constraint_group(self, g, local, nxt, publics, alg, fixed=None, fixed_next=None,
                              challenges=None, stage2=None, stage2_next=None):
        from blobstreamx_tpu_torch.prover.air import frame_block

        if g == 0:
            bits = frame_block(alg, local, 1, 19)
            return [(alg.mul(bits, alg.sub(bits, alg.const_row([1] * 18))), "all")]
        return [
            (alg.sub(nxt[0], alg.add(local[0], fixed[0])), "transition"),
            (alg.sub(stage2_next[0], alg.add(alg.mul(stage2[0], challenges[0]), nxt[0])), "transition"),
            (alg.sub(stage2[0], local[0]), "first"),
            (alg.sub(local[0], publics[0]), "last"),
        ]

    def eval_constraints(self, local, nxt, publics, alg, **frame):
        return [c for g in range(2) for c in self.eval_constraint_group(g, local, nxt, publics, alg, **frame)]


def toy_air():
    from blobstreamx_tpu_torch.prover.air import Air

    return type("ToyAir", (_ToyBody, Air), {})()


def toy_case(n: int = 16):
    rng = np.random.default_rng(3)
    trace = np.zeros((n, 19), np.uint64)
    trace[:, 1:] = rng.integers(0, 2, (n, 18))
    c0 = int(rng.integers(0, P, dtype=np.uint64))
    for i in range(n):
        trace[i, 0] = c0
        c0 = (c0 + i % 3) % P
    return trace, [int(trace[-1, 0])], [5, 6, 7]


def checks(mesh, w):
    """(check, case) -> a thunk giving this rank's value on `mesh`."""
    from blobstreamx_tpu_torch.circuits.data_commitment import data_commitment_device, heights_to_u32
    from blobstreamx_tpu_torch.fields import gf25519 as f, gf64
    from blobstreamx_tpu_torch.ops import msm as msm_ops, sha256 as sha_ops
    from blobstreamx_tpu_torch.parallel import mesh as pm, merkle as pmerkle, msm as pmsm, ntt as pntt
    from blobstreamx_tpu_torch.parallel.mesh import col_bounds
    from blobstreamx_tpu_torch.prover import serialize, stark, stark_stream
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    dev = mesh.device
    out = {}
    for log_n in NTT_LOGS:
        for inverse in (False, True):
            x = gl_input(log_n, (1 << log_n,))
            out[("ntt_sharded", (log_n, inverse))] = (
                lambda x=x, inverse=inverse: gf64.to_u64(pntt.ntt_sharded(gf64.from_u64(x, dev), mesh, inverse)))

    def matrix_local():
        # this rank's output columns of the (n2, n1) matrix of a 2^8 input
        n1, n2 = pntt._factor(8)
        x = gl_input(99, (1 << 8,)).reshape(n1, n2)
        w = n2 // mesh.size
        xl = gf64.from_u64(np.ascontiguousarray(x[:, mesh.rank * w : (mesh.rank + 1) * w]), dev)
        return gf64.to_u64(pntt.ntt_matrix_sharded(xl, mesh))

    out[("ntt_matrix_local", 8)] = matrix_local

    for round_bytes in (pm.A2A_ROUND_BYTES, 64):
        def cols_to_rows(round_bytes=round_bytes):
            # this rank's columns of a (2, 64, 19) matrix -> its rows, in one round or in many
            full = torch.from_numpy(gl_input(19, (2, 64, 19)).astype(np.int64) & 0xFFFFFFFF).to(dev)
            a, b = col_bounds(19, mesh)
            saved, pm.A2A_ROUND_BYTES = pm.A2A_ROUND_BYTES, round_bytes
            try:
                widths = [y - x for x, y in pm.split_bounds(19, mesh.size)]
                return pm.cols_to_rows(full[..., a:b], widths, mesh).cpu().numpy()
            finally:
                pm.A2A_ROUND_BYTES = saved

        out[("cols_to_rows", round_bytes)] = cols_to_rows

    for shape in ((32, 16), (32, 7)):
        def lde(shape=shape):
            a, b = col_bounds(shape[1], mesh)
            coeffs = gf64.from_u64(np.ascontiguousarray(gl_input(3, shape)[:, a:b]), dev)
            return gf64.to_u64(pntt.lde_cols_sharded(coeffs, 2, mesh))

        out[("lde_cols_local", shape)] = lde

    def tuple_root(n=64):
        heights, hashes = tuple_input(n)
        hlo, hhi = heights_to_u32(heights)
        root = pmerkle.tuple_tree_root_sharded(hlo, hhi, sha_ops.bytes32_to_words(hashes), mesh)
        return sha_ops.digests_to_bytes(root)[0]

    out[("tuple_tree_root", 64)] = tuple_root
    for n in (64, 48, 6):
        out[("data_commitment", n)] = lambda n=n: data_commitment_device(*tuple_input(n), mesh.device, mesh=mesh)

    leaves = gl_input(5, (8, 64))
    per = 64 // mesh.size
    local = gf64.from_u64(np.ascontiguousarray(leaves[:, mesh.rank * per : (mesh.rank + 1) * per]), dev)
    out[("leaf_layer_local", 64)] = lambda: gf64.to_u64(pmerkle.poseidon_leaf_layer_sharded(local, mesh))
    for cap in TREE_CAPS:
        def tree(cap=cap):
            t = pmerkle.poseidon_tree_sharded(local, mesh, cap)
            cap_ints = gf64.to_u64(t.cap).T.tolist()
            return cap_ints, {i: t.path(i) for i in range(64) if t.owner(i) == mesh.rank}

        out[("poseidon_tree", cap)] = tree

    for case, (n, c) in MSM_CASES.items():
        def msm(n=n, c=c):
            pts, scalars = msm_input(n, c)
            dp = tuple(f.from_int([p[i] for p in pts], dev) for i in range(4))
            return pmsm.msm_sharded(dp, msm_ops.scalars_to_digits(scalars, c=c), mesh, streams=2)

        out[("msm_sharded", case)] = msm

    def overflow():
        pts, _ = msm_input(2, 4)
        dp = tuple(f.from_int([p[i] for p in pts], dev) for i in range(4))
        digits = np.zeros((16, 2), np.uint32)  # W = 16 -> c = 16 ...
        digits[0, 0] = 1 << 16  # ... but a c = 17 digit
        try:
            pmsm.msm_sharded(dp, digits, mesh, streams=2)
        except AssertionError as e:
            return f"AssertionError: {e}"
        return "no error"

    out[("msm_overflow", 17)] = overflow
    for n in BITWISE_NS:
        def bitwise(n=n):
            pts, scalars = msm_input(n, 1)
            dp = tuple(f.from_int([p[i] for p in pts], dev) for i in range(4))
            return pmsm.msm_bitwise_sharded(dp, scalars, mesh)

        out[("msm_bitwise_sharded", n)] = bitwise
    out[("batch_verify", "valid")] = lambda: pmsm.batch_verify_sharded(signed_items(12), mesh, streams=2)[0]
    out[("batch_verify", "tampered")] = lambda: pmsm.batch_verify_sharded(
        signed_items(12, seed=9, tamper=7), mesh, streams=2)[0]

    def toy():
        trace, publics, aux = toy_case()
        proof = stark.prove(toy_air(), trace, publics, StarkConfig(**TOY_CFG), aux=aux, mesh=mesh)
        return serialize.stark_proof_to_bytes(proof)

    out[("stark", "toy_air")] = toy

    def toy_rounds():
        # 8-column chunks: 19 columns are 3 chunks, two all-to-all rounds on two ranks
        trace, publics, aux = toy_case()
        proof = stark_stream.prove_streaming(toy_air(), trace, publics, StarkConfig(**TOY_CFG), aux=aux,
                                             col_chunk=8, mesh=mesh)
        return serialize.stark_proof_to_bytes(proof)

    out[("stark", "toy_air_chunk8")] = toy_rounds
    # the SkipAir STARK on the seed-11 chain is prove_skip's last stark.prove(mesh=)
    out[("prove_skip", "default")] = lambda: prove_skip_bytes(w, mesh=mesh)
    return out


def prove_skip_bytes(w, **where) -> tuple[bytes, bytes, list[int], int]:
    """(the skip proof's bytes, its SkipAir STARK's bytes, publics, rows)."""
    from blobstreamx_tpu_torch.prover import pipeline, serialize
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    proof = pipeline.prove_skip(w, StarkConfig(**CFG), **where)
    return (serialize.skip_proof_to_bytes(proof), serialize.stark_proof_to_bytes(proof.stark),
            proof.publics, proof.n_rows)


TINY_CHAIN = dict(seed=11, n_headers=3, n_validators=1, sign_heights={2})
TINY_CFG = dict(rate_bits=2, cap_height=1, num_query_rounds=4, proof_of_work_bits=4, final_poly_len=4)


def tiny_ed_bytes(mesh) -> bytes:
    """prove_skip(mesh=) of the 3-header, 1-validator chain (1 -> 2) at the
    Ed25519 tier under TINY_CFG (chip_smoke.py's TINY_CHAIN and TINY_CFG)."""
    from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit
    from blobstreamx_tpu_torch.prover import pipeline, serialize
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    w = wit.build_skip_witness(fx.generate_chain(**TINY_CHAIN), trusted_height=1, target_height=2)
    return serialize.skip_proof_to_bytes(
        pipeline.prove_skip(w, StarkConfig(**TINY_CFG), with_ed_stark=True, mesh=mesh))


def references(rank: int, w) -> dict:
    """The single-device results the mesh results are held to, computed on
    the ranks outside the two-rank mesh while it runs."""
    from blobstreamx_tpu_torch.prover import serialize, stark
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    if rank == 2:
        return {("single", "prove_skip", "default"): prove_skip_bytes(w, device="cpu")}
    if rank == 3:
        trace, publics, aux = toy_case()
        proof = stark.prove(toy_air(), trace, publics, StarkConfig(**TOY_CFG), aux=aux, device="cpu")
        return {("single", "stark", "toy_air"): serialize.stark_proof_to_bytes(proof)}
    return {}


# checks left to the four-rank mesh, and to the two-rank one; each mesh runs the rest
D4_ONLY = {("msm_sharded", "wide"), ("batch_verify", "valid"), ("batch_verify", "tampered"), ("stark", "toy_air")}
D2_ONLY = {("stark", "toy_air_chunk8")}


def main() -> int:
    rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    what = sys.argv[6] if len(sys.argv) > 6 else "checks"
    torch.set_num_threads(1)
    import torch.distributed as dist

    from blobstreamx_tpu_torch.parallel import mesh as pm

    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    if what == "tiny_ed":
        got = {("tiny_ed", "prove_skip", "ed"): tiny_ed_bytes(pm.make_mesh(world, device=device))}
        with open(out_dir / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(got, fh)
        dist.destroy_process_group()
        return 0
    assert world in (2, 4), world
    meshes = {"d2": pm.make_mesh(2, device=device)}
    if world == 4:
        meshes["d4"] = pm.make_mesh(world, device=device)
    w = small_witness()
    got = {}
    for name, mesh in meshes.items():
        if mesh is None:
            got.update(references(rank, w))
            continue
        seconds = {}
        for key, run in checks(mesh, w).items():
            if key in (D4_ONLY if name == "d2" else D2_ONLY):
                continue
            t0 = time.perf_counter()
            try:
                got[(name,) + key] = run()
            except Exception:  # recorded: the test fails on it with the traceback
                got[(name,) + key] = "raised: " + traceback.format_exc()
            seconds[key] = time.perf_counter() - t0
        got[(name, "moved", None)] = dict(mesh.moved)
        got[(name, "seconds", None)] = seconds
    with open(out_dir / f"rank{rank}.pkl", "wb") as fh:
        pickle.dump(got, fh)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
