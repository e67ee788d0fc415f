"""The port stands alone: no module of blobstreamx_tpu_torch (nor its
scripts chip_smoke.py, kernel_report.py and prover_ab.py) imports JAX or the JAX package, and the public entry points
refuse to fall back to the CPU when CUDA is missing."""

import ast
from pathlib import Path

import pytest
import torch

from blobstreamx_tpu_torch.circuits import fixtures as fx, witness as wit

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ("chip_smoke.py", "kernel_report.py", "prover_ab.py")
PORT_FILES = sorted((ROOT / "blobstreamx_tpu_torch").rglob("*.py")) + [ROOT / f for f in SCRIPTS]
FORBIDDEN = ("jax", "jaxlib", "blobstreamx_tpu")


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


# the Ed25519 STARK's modules: each must be among the files checked above
ED_MODULES = ("gf25519_gadget", "lookup", "ed_air", "ed_claims")


def test_ed_stark_modules_are_checked():
    checked = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"blobstreamx_tpu_torch/prover/{m}.py" for m in ED_MODULES} <= checked


# the operator's surface (the CLI, its facades, checkpoints, retry, metrics, profiling, pipelining)
OPERATOR_MODULES = ("__main__", "models/__init__", "models/skip", "models/step", "models/sha256_stark",
                    "utils/checkpoint", "utils/failure", "utils/metrics", "utils/profiling", "utils/timing",
                    "prover/overlap")


def test_operator_modules_are_checked():
    checked = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"blobstreamx_tpu_torch/{m}.py" for m in OPERATOR_MODULES} <= checked


def test_native_runtime_is_checked_and_built_from_the_port():
    """The port's native host runtime is among the AST-checked files, and the
    library it loads was built from its own C source into build/native/,
    never the JAX package's native/libbsx.so."""
    from blobstreamx_tpu_torch import native

    checked = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "blobstreamx_tpu_torch/native/__init__.py" in checked
    assert native.SOURCE.resolve() == (ROOT / "blobstreamx_tpu_torch" / "native" / "bsx_sha256.c").resolve()
    loaded = Path(native.loaded_path()).resolve()
    assert loaded == native.lib_path().resolve()
    assert loaded.parent == (ROOT / "build" / "native").resolve()
    assert loaded != (ROOT / "native" / "libbsx.so").resolve()


@pytest.fixture(scope="module")
def small_witness():
    chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4,
                              sign_fraction=0.75, sign_heights={10})
    return wit.build_skip_witness(chain, trusted_height=2, target_height=10)


def test_prove_skip_without_device_raises_when_no_cuda(small_witness):
    from blobstreamx_tpu_torch.prover import pipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.prove_skip(small_witness)


def test_other_entry_points_raise_when_no_cuda(small_witness):
    from blobstreamx_tpu_torch.circuits import step
    from blobstreamx_tpu_torch.circuits.skip import verify_skip
    from blobstreamx_tpu_torch.ops import ed25519 as ted
    from blobstreamx_tpu_torch.prover import pipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    items = [(pk, small_witness.sign_bytes, sig) for pk, sig in
             zip(small_witness.target_set.pubkeys, small_witness.signatures) if sig]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ted.batch_verify(items)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        verify_skip(small_witness)
    chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4,
                              sign_fraction=0.75, sign_heights={10})
    step_witness = step.build_step_witness(chain, prev_height=9)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step.verify_step(step_witness)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.prove_step(step_witness)


def test_ed_stark_entry_points_raise_when_no_cuda(small_witness):
    """prove_batch_stark and prove_skip(with_ed_stark=True) refuse to fall
    back to the CPU; prove_batch_stark takes the CPU when named (it reaches
    the batch check, which refuses a malformed batch)."""
    from blobstreamx_tpu_torch.prover import ed_claims, pipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    items = pipeline.signature_items(small_witness)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ed_claims.prove_batch_stark(items)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipeline.prove_skip(small_witness, with_ed_stark=True)
    pk, msg, sig = items[0]
    with pytest.raises(ValueError, match="malformed"):
        ed_claims.prove_batch_stark([(pk[:31], msg, sig)], device="cpu")


def test_grind_without_device_raises_when_no_cuda():
    from blobstreamx_tpu_torch.golden.challenger import Challenger
    from blobstreamx_tpu_torch.ops import fri

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fri.grind(Challenger(), 4)
    assert fri.grind(Challenger(), 4, "cpu", batch=64) >= 0


def test_kernel_wrappers_take_the_plain_version_only_for_cpu_tensors():
    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt, poseidon

    kernels.reset_counts()
    x = gf64.from_u64([[1, 2], [3, 4]])
    assert gf64.to_u64(ntt.ntt_cols(x)).tolist() == gf64.to_u64(ntt.ntt_cols_plain(x)).tolist()
    s = gf64.zeros((12, 3))
    assert gf64.to_u64(poseidon.permute(s)).tolist() == gf64.to_u64(poseidon.permute_plain(s)).tolist()
    vec = gf64.from_u64(list(range(8)))
    assert gf64.to_u64(ntt.ntt_four_step(vec)).tolist() == gf64.to_u64(ntt.ntt_four_step_plain(vec)).tolist()
    assert all(v == 0 for v in kernels.launches.values())
    with pytest.raises(ValueError):
        ntt.ntt_cols(tuple(t.to("meta") for t in x))


# the parallel package: the mesh, the bring-up and the sharded modules
PARALLEL_MODULES = ("__init__", "mesh", "distributed", "ntt", "merkle", "msm")


def test_parallel_modules_are_checked():
    checked = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {f"blobstreamx_tpu_torch/parallel/{m}.py" for m in PARALLEL_MODULES} <= checked


def test_cuda_mesh_without_a_card_raises():
    from blobstreamx_tpu_torch.parallel import mesh as pm

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: a cuda mesh is usable here")
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pm.make_mesh(1, device=device)


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-process gloo group (file store), torn down after the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_entry_points_refuse_a_device_other_than_the_mesh(small_witness, one_rank_group):
    """device= and mesh= that disagree raise ValueError before any work: a
    CPU mesh with device="cuda", and a mesh on the card with device="cpu"."""
    import torch.distributed as dist

    from blobstreamx_tpu_torch.circuits.skip import verify_skip
    from blobstreamx_tpu_torch.parallel import mesh as pm
    from blobstreamx_tpu_torch.prover import pipeline

    cpu_mesh = pm.make_mesh(1, device="cpu")
    assert (cpu_mesh.rank, cpu_mesh.size, cpu_mesh.backend, cpu_mesh.staging) == (0, 1, "gloo", False)
    card_mesh = pm.Mesh(dist.group.WORLD, [0], torch.device("cuda", 0), "gloo")
    assert card_mesh.staging  # gloo moves host tensors: a card mesh stages through the host
    for mesh, device in ((cpu_mesh, "cuda"), (card_mesh, "cpu"), (card_mesh, "cuda:1")):
        with pytest.raises(ValueError, match="disagrees with the mesh"):
            pipeline.prove_skip(small_witness, mesh=mesh, device=device)
        with pytest.raises(ValueError, match="disagrees with the mesh"):
            verify_skip(small_witness, mesh=mesh, device=device)
