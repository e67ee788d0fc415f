"""The port's parallel/ package (SPMD over torch.distributed) on the CPU:
four gloo ranks, spawned once for the module (tests/torch_parallel_ranks.py,
a file store under tmp_path, one thread a rank), run every sharded check on
a mesh of all four ranks ("d4") and one of ranks {0, 1} ("d2"); the tests
below hold what each rank got to the port's single-device functions and to
the JAX package's pure-Python goldens and verifiers:

- ntt_sharded (log n 4-10, both ways), the six-step output's layout (fold
  pairs stay on their rank), lde_cols_sharded (even and ragged columns);
- tuple_tree_root_sharded and data_commitment_device(mesh=) for leaf counts
  divisible by D and not; poseidon_leaf_layer_sharded and
  poseidon_tree_sharded at caps 0-3 (the cap and every leaf's path);
- msm_sharded at N = 1, 5, 8 and 8-bit windows, its digit-overflow assert,
  msm_bitwise_sharded, batch_verify_sharded valid and tampered;
- stark.prove(mesh=) on the toy AIR of tests/test_torch_stark_stream.py
  (stage 2, aux, a fixed column, 19 columns over 4 ranks; and in 8-column
  chunks on 2 ranks, two all-to-all rounds) and prove_skip(w,
  mesh=) on the seed-11 chain (its SkipAir STARK): byte for byte the
  single-device proofs, and the JAX verifier accepts them;
- parallel.distributed.maybe_initialize: two processes, by flags and by
  environment variables, see each other's contribution.
"""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from blobstreamx_tpu.golden import ed25519 as jgold_ed, merkle as jgold_merkle, ntt as jgold_ntt
from blobstreamx_tpu.prover import air as jax_air, pipeline as jax_pipeline, serialize as jax_serialize
from blobstreamx_tpu.prover import stark as jax_stark
from blobstreamx_tpu.prover.config import StarkConfig as JaxStarkConfig
from blobstreamx_tpu_torch.circuits.data_commitment import data_commitment_device
from blobstreamx_tpu_torch.fields import gf64
from blobstreamx_tpu_torch.ops import merkle as merkle_ops, ntt as ntt_ops
from blobstreamx_tpu_torch.parallel import ntt as pntt

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_ranks as R  # noqa: E402

torch.set_num_threads(1)
RANKS = Path(__file__).resolve().parent / "torch_parallel_ranks.py"
MESHES = {"d2": 2, "d4": 4}
RANK_TIMEOUT_S = 300


def spawn_ranks(out: Path, world: int, *extra: str, timeout: float = RANK_TIMEOUT_S) -> list[dict]:
    """Run `world` ranks of tests/torch_parallel_ranks.py; each rank's results."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(RANKS), str(r), str(world), str(out / "store"), str(out), *extra],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(world)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the four ranks once; return each rank's results."""
    return spawn_ranks(tmp_path_factory.mktemp("ranks"), 4)


def values(ranks, mesh: str, check: str, case):
    """Every rank's value of one check on one mesh, failing on a raise."""
    got = [res[(mesh, check, case)] for res in ranks if (mesh, check, case) in res]
    assert len(got) == MESHES[mesh], (mesh, check, case)
    for v in got:
        assert not (isinstance(v, str) and v.startswith("raised")), v
    return got


def reference(ranks, check: str, case):
    return next(res[("single", check, case)] for res in ranks if ("single", check, case) in res)


# ----------------------------------------------------------------------------
# the sharded NTT and LDE
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("log_n", R.NTT_LOGS)
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_sharded(ranks, mesh, log_n, inverse):
    x = R.gl_input(log_n, (1 << log_n,))
    want = gf64.to_u64(ntt_ops.ntt_cols(gf64.from_u64(x[:, None]), inverse))[:, 0]
    golden = (jgold_ntt.intt if inverse else jgold_ntt.ntt)([int(v) for v in x])
    assert want.tolist() == golden
    for got in values(ranks, mesh, "ntt_sharded", (log_n, inverse)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES)
def test_fold_pairs_stay_local(ranks, mesh):
    """Rank r holds columns [r*n1/D, (r+1)*n1/D) of the (n2, n1) output Z
    with out[k2*n1 + k1] = Z[k2, k1]: a FRI fold pair (i, i + n/2) is rows
    (k2, k2 + n2/2) of one column, so it stays on its rank."""
    n1, n2 = pntt._factor(8)
    parts = values(ranks, mesh, "ntt_matrix_local", 8)
    assert all(p.shape == (n2, n1 // MESHES[mesh]) for p in parts)
    z = np.concatenate(parts, axis=1)
    want = gf64.to_u64(ntt_ops.ntt_cols(gf64.from_u64(R.gl_input(99, (256,))[:, None])))[:, 0]
    np.testing.assert_array_equal(z.reshape(-1), want)
    for i in range(128):
        (k2a, k1a), (k2b, k1b) = divmod(i, n1), divmod(i + 128, n1)
        assert k1a == k1b and k2b == k2a + n2 // 2


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("round_bytes", [1 << 28, 64])
def test_cols_to_rows(ranks, mesh, round_bytes):
    """The column -> row re-shard of a (2, 64, 19) matrix (ragged columns),
    in one all-to-all round and in many (64-byte rounds): rank r gets rows
    [16r, 16r + 16) (d4) of every column, in column order."""
    from blobstreamx_tpu_torch.parallel import mesh as pm

    assert pm.A2A_ROUND_BYTES == 1 << 28
    full = R.gl_input(19, (2, 64, 19)).astype(np.int64) & 0xFFFFFFFF
    got = values(ranks, mesh, "cols_to_rows", round_bytes)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), full)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", [(32, 16), (32, 7)])
def test_lde_cols_sharded(ranks, mesh, shape):
    coeffs = R.gl_input(3, shape)
    want = gf64.to_u64(ntt_ops.lde_cols(gf64.from_u64(coeffs), 2))
    got = np.concatenate(values(ranks, mesh, "lde_cols_local", shape), axis=1)
    np.testing.assert_array_equal(got, want)
    for j in (0, shape[1] - 1):
        assert want[:, j].tolist() == jgold_ntt.lde([int(v) for v in coeffs[:, j]], 2)


# ----------------------------------------------------------------------------
# the sharded Merkle trees
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_tuple_tree_root_sharded(ranks, mesh):
    golden = jgold_merkle.data_commitment(*R.tuple_input(64))
    assert all(v == golden for v in values(ranks, mesh, "tuple_tree_root", 64))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("n", [64, 48, 6])
def test_data_commitment_device_mesh(ranks, mesh, n):
    """Sharded when n and n/D are powers of two (64), the single-device
    reduction on every rank otherwise (48 and 6 leaves)."""
    heights, hashes = R.tuple_input(n)
    golden = jgold_merkle.data_commitment(heights, hashes)
    assert data_commitment_device(heights, hashes, "cpu") == golden
    assert all(v == golden for v in values(ranks, mesh, "data_commitment", n))


@pytest.mark.parametrize("mesh", MESHES)
def test_poseidon_leaf_layer_sharded(ranks, mesh):
    leaves = R.gl_input(5, (8, 64))
    got = np.concatenate(values(ranks, mesh, "leaf_layer_local", 64), axis=1)
    for j in (0, 31, 63):
        assert got[:, j].tolist() == jgold_merkle.poseidon_leaf([int(v) for v in leaves[:, j]])
    want = gf64.to_u64(merkle_ops.build_tree(gf64.from_u64(leaves)).layers[0])
    np.testing.assert_array_equal(got, want)


_GOLDEN_CAPS: dict = {}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cap", R.TREE_CAPS)
def test_poseidon_tree_sharded(ranks, mesh, cap):
    """The cap on every rank, and each leaf's path from its rank, equal
    build_tree's; the JAX golden gives the cap and accepts the paths of a
    leaf on the first rank, one inside and the last leaf."""
    leaves = R.gl_input(5, (8, 64))
    tree = merkle_ops.build_tree(gf64.from_u64(leaves), cap)
    cap_ints = gf64.to_u64(tree.cap).T.tolist()
    cols = [[int(v) for v in leaves[:, j]] for j in range(64)]
    if cap not in _GOLDEN_CAPS:
        _GOLDEN_CAPS[cap] = jgold_merkle.poseidon_tree_cap(cols, cap)
    assert cap_ints == _GOLDEN_CAPS[cap]
    paths = {}
    for got_cap, got_paths in values(ranks, mesh, "poseidon_tree", cap):
        assert got_cap == cap_ints
        assert not set(paths) & set(got_paths)
        paths.update(got_paths)
    assert sorted(paths) == list(range(64))
    for i, path in paths.items():
        assert path == tree.path(i)
    for i in (0, 21, 63):
        assert jgold_merkle.poseidon_verify_path(cap_ints, cols[i], i, paths[i][0])


# ----------------------------------------------------------------------------
# the sharded MSM and batch verification
# ----------------------------------------------------------------------------


def _golden_msm(points, scalars):
    acc = jgold_ed.IDENTITY
    for s, p in zip(scalars, points):
        acc = jgold_ed.point_add(acc, jgold_ed.point_mul(s, p))
    return acc


MSM_PARAMS = [(m, c) for m in MESHES for c in R.MSM_CASES if m == "d4" or ("msm_sharded", c) not in R.D4_ONLY]


@pytest.mark.parametrize("mesh,case", MSM_PARAMS)
def test_msm_sharded(ranks, mesh, case):
    n, c = R.MSM_CASES[case]
    want = _golden_msm(*R.msm_input(n, c))
    for got in values(ranks, mesh, "msm_sharded", case):
        assert jgold_ed.point_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES)
def test_msm_sharded_digit_overflow_asserts(ranks, mesh):
    """16 digit rows infer c = 16; a digit of 2^16 (built with c = 17)
    would overflow the bucket lanes, so msm_sharded refuses it."""
    for got in values(ranks, mesh, "msm_overflow", 17):
        assert got.startswith("AssertionError: digit 65536 overflows inferred window c=16"), got


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("n", R.BITWISE_NS)
def test_msm_bitwise_sharded(ranks, mesh, n):
    want = _golden_msm(*R.msm_input(n, 1))
    for got in values(ranks, mesh, "msm_bitwise_sharded", n):
        assert jgold_ed.point_equal(got, want)


@pytest.mark.parametrize("case,tamper", [("valid", None), ("tampered", 7)])
def test_batch_verify_sharded(ranks, case, tamper):
    items = R.signed_items(12, seed=0 if tamper is None else 9, tamper=tamper)
    want = all(jgold_ed.verify(pk, msg, sig) for pk, msg, sig in items)
    assert want == (tamper is None)
    assert all(v is want for v in values(ranks, "d4", "batch_verify", case))


# ----------------------------------------------------------------------------
# mesh proofs
# ----------------------------------------------------------------------------


class JaxToyAir(R._ToyBody, jax_air.Air):
    pass


def test_mesh_stark_toy_air_equals_single_device(ranks):
    """19 columns and one stage-2 column over 4 ranks (column chunks of 8,
    8, 3 and none: one rank extends no chunk), a fixed column, an aux
    claim: every rank's proof is the
    single-device proof's bytes, and the JAX verifier accepts it."""
    want = reference(ranks, "stark", "toy_air")
    assert all(v == want for v in values(ranks, "d4", "stark", "toy_air"))
    trace, publics, aux = R.toy_case()
    proof = jax_serialize.stark_proof_from_bytes(want)
    cfg = JaxStarkConfig(**R.TOY_CFG)
    assert jax_stark.verify(JaxToyAir(), proof, publics, cfg, trace.shape[0], aux=aux)
    assert not jax_stark.verify(JaxToyAir(), proof, publics, cfg, trace.shape[0], aux=aux[:2] + [8])


def test_mesh_stark_toy_air_in_many_rounds(ranks):
    """The toy AIR through prove_streaming(col_chunk=8, mesh=) on two ranks:
    three column chunks, so the commit takes two all-to-all rounds and one
    rank has no chunk in the second; the proof is the single-device one."""
    want = reference(ranks, "stark", "toy_air")
    assert all(v == want for v in values(ranks, "d2", "stark", "toy_air_chunk8"))


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_prove_skip_equals_single_device(ranks, mesh):
    """prove_skip(w, mesh=) on the seed-11 chain: every rank's proof bytes
    and its SkipAir STARK's (stark.prove(mesh=)) are the single-device
    ones, and the JAX verifier accepts that STARK."""
    blob, stark_blob, publics, n_rows = reference(ranks, "prove_skip", "default")
    for got in values(ranks, mesh, "prove_skip", "default"):
        assert got == (blob, stark_blob, publics, n_rows)
    proof = jax_serialize.stark_proof_from_bytes(stark_blob)
    cfg = JaxStarkConfig(**R.CFG)
    assert jax_stark.verify(jax_pipeline.SkipAir(), proof, publics, cfg, n_rows)
    assert not jax_stark.verify(jax_pipeline.SkipAir(), proof, [publics[0] + 1] + publics[1:], cfg, n_rows)


@pytest.mark.parametrize("mesh", MESHES)
def test_collectives_moved_bytes(ranks, mesh):
    """Every rank of a mesh counted the bytes it sent by collective: the
    all-to-all re-shards, the gathers and the partner exchanges."""
    for moved in values(ranks, mesh, "moved", None):
        assert {"all_to_all", "all_gather", "exchange"} <= set(moved)
        assert all(v > 0 for v in moved.values())


# ----------------------------------------------------------------------------
# parallel.distributed: two processes through maybe_initialize
# ----------------------------------------------------------------------------

WORKER = r"""
import argparse, sys
import torch
import torch.distributed as dist
from blobstreamx_tpu_torch.parallel import distributed

parser = argparse.ArgumentParser()
distributed.add_distributed_args(parser)
args = parser.parse_args(sys.argv[1:])
assert distributed.maybe_initialize(args, backend="gloo")
mesh = distributed.global_mesh(device="cpu")
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x, group=mesh.group)
got = torch.cat(mesh.all_gather(torch.tensor([dist.get_rank()])))
assert float(x[0]) == 3.0 and got.tolist() == [0, 1], (x, got)
print(f"rank {mesh.rank} of {mesh.size}: sum ok")
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("how", ["flags", "env"])
def test_maybe_initialize_two_processes(how):
    coord = f"127.0.0.1:{_free_port()}"
    root = Path(__file__).resolve().parent.parent
    procs = []
    for pid in range(2):
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(root))
        argv = []
        if how == "flags":
            argv = ["--coordinator", coord, "--num-processes", "2", "--process-id", str(pid)]
        else:
            env.update(BSX_COORDINATOR=coord, BSX_NUM_PROCESSES="2", BSX_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen([sys.executable, "-c", WORKER] + argv, env=env, cwd=root,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"rank {pid} of 2: sum ok" in out


@pytest.mark.slow
def test_mesh_prove_skip_ed_tier_tiny_chain(tmp_path):
    """(slow: about 7 min of eager proving on two CPU ranks.) prove_skip of
    the 3-header chain at the Ed25519 tier over a 2-rank mesh gives, on
    both ranks, the bytes whose SHA-256 chip_smoke.py pins for the
    single-device proof (TINY_ED_PROOF_SHA256, which the JAX verifier
    accepts: tests/test_torch_ed_tier.py's slow test)."""
    import hashlib

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    assert R.TINY_CHAIN == chip_smoke.TINY_CHAIN and R.TINY_CFG == chip_smoke.TINY_CFG
    got = spawn_ranks(tmp_path, 2, "cpu", "tiny_ed", timeout=3600)
    for res in got:
        assert hashlib.sha256(res[("tiny_ed", "prove_skip", "ed")]).hexdigest() == chip_smoke.TINY_ED_PROOF_SHA256
