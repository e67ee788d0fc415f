"""The CUDA kernels against their plain PyTorch versions on the card
(exact equality; GF(2^255-19) outputs by field value, the kernels' limbs
canonical). Marked ``cuda``: run on a machine with a card by
``pytest -m cuda tests/test_torch_kernels_cuda.py``; each test skips here,
deciding inside the test whether a card is present."""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def gl(rng, shape):
    from blobstreamx_tpu_torch.fields import gf64

    v = rng.integers(0, gf64.P, size=shape, dtype=np.uint64)
    flat = v.reshape(-1)
    flat[:4] = [0, gf64.P - 1, (1 << 32) - 1, 1 << 32][: flat.size]
    return gf64.from_u64(v, "cuda")


def fe(rng, n):
    from blobstreamx_tpu_torch.fields import gf25519 as f

    vals = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    vals[:8] = [0, 1, f.Q - 1, f.Q, f.Q + 18, (1 << 255) - 1, (1 << 256) - 1, 2 * f.Q][:n]
    return f.from_int(vals, "cuda")


@pytest.mark.parametrize("n,c,inverse", [
    (32, 8, True), (256, 8, False), (256, 2, True), (1 << 15, 4, False), (8, 1, True),
    (2048, 2050, False), (1 << 14, 3, True), (1, 4, False), (1024, 2048, False), (2048, 1024, True),
    # the long-column path at the SHA tier's shapes and the edges of its design: the smallest
    # long column, a ragged column tile, an uneven split, the largest two-pass and a three-pass column
    (1 << 21, 32, False), (1 << 18, 20, True), (1 << 21, 2, True),
    (1 << 15, 1, False), (1 << 15, 3, True), (1 << 17, 5, False), (1 << 22, 8, False), (1 << 23, 4, False),
    # the 256-validator StepAir's trace INTT and LDE, and the full tier's 512-block shard: its
    # 128-column trace chunks and ragged last chunk, inverse at 2^15 rows and forward at 2^18
    (256, 4, True), (2048, 4, False),
    (1 << 15, 128, True), (1 << 18, 128, False), (1 << 15, 20, True), (1 << 18, 20, False),
    # config 5's Ed25519 STARK (65,536 rows, rate_bits 3): its trace chunk INTT and LDE, its
    # ragged last trace and stage-2 chunks, the quotient's coset INTT and LDE
    (1 << 16, 128, True), (1 << 19, 128, False), (1 << 16, 45, True), (1 << 19, 49, False),
    (1 << 19, 2, True), (1 << 19, 16, False),
])
def test_ntt_kernel(n, c, inverse):
    from blobstreamx_tpu_torch.ops import ntt

    _card()
    x = gl(np.random.default_rng(n + c), (n, c))
    k, p = ntt._ntt_cols_cuda(x, inverse), ntt.ntt_cols_plain(x, inverse)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("n", [4096, 16383, 1])
def test_poseidon_kernel(n):
    from blobstreamx_tpu_torch.ops import poseidon as pos

    _card()
    s = gl(np.random.default_rng(1), (12, n))
    k, p = pos._permute_cuda(s), pos.permute_plain(s)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def add_lanes(rng, n):
    """n (p, q) lanes of extended coordinates as ints: the edge lanes first
    (an identity operand, a doubling, p + (-p), points of order 2 and 4,
    coordinates stored semi-reduced in [p, 2^256)), then random points with
    random projective scale."""
    from blobstreamx_tpu_torch.golden import ed25519 as ged

    Q = ged.Q
    pts = [ged.point_mul(int(rng.integers(1, 1 << 62)), ged.BASE) for _ in range(16)]
    neg = (Q - pts[0][0], pts[0][1], pts[0][2], Q - pts[0][3])
    i4 = (pow(2, (Q - 1) // 4, Q), 0, 1, 0)
    semi = [tuple(c + Q if c + Q < 1 << 256 else c for c in pt) for pt in pts[:2]]
    lanes = [(pts[0], ged.IDENTITY), (pts[0], pts[0]), (pts[0], neg), (pts[0], (0, Q - 1, 1, 0)), (i4, i4),
             (semi[0], semi[1])]
    while len(lanes) < n:
        lam = int(rng.integers(1, 1 << 62))
        lanes.append((tuple(c * lam % Q for c in pts[len(lanes) % 16]), pts[(7 * len(lanes) + 3) % 16]))
    return lanes[:n]


@pytest.mark.parametrize("n", [1, 33, 64, 1024, 4096, 32768])
def test_edwards_add_kernel(n):
    from blobstreamx_tpu_torch.fields import gf25519 as f
    from blobstreamx_tpu_torch.ops import curve25519 as curve

    _card()
    lanes = add_lanes(np.random.default_rng(n), n)
    p = tuple(f.from_int([pq[0][i] for pq in lanes], "cuda") for i in range(4))
    q = tuple(f.from_int([pq[1][i] for pq in lanes], "cuda") for i in range(4))
    k, pl = curve._add_cuda(p, q), curve.add(p, q)
    for kc, pc in zip(k, pl):
        assert torch.equal(kc, f.canonicalize(pc)) and torch.equal(kc, f.canonicalize(kc))


@pytest.mark.parametrize("n", [1, 64, 4096])
def test_double_on_the_card(n):
    """curve.double on CUDA tensors (one Edwards-add launch) against the
    plain formula add(p, p)."""
    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.fields import gf25519 as f
    from blobstreamx_tpu_torch.ops import curve25519 as curve

    _card()
    lanes = add_lanes(np.random.default_rng(n + 7), n)
    p = tuple(f.from_int([pq[0][i] for pq in lanes], "cuda") for i in range(4))
    before = kernels.launches["edwards_add"]
    got = curve.double(p)
    assert kernels.launches["edwards_add"] == before + 1
    for kc, pc in zip(got, curve.add(p, p)):
        assert torch.equal(kc, f.canonicalize(pc))


@pytest.mark.parametrize("n_points", [2, 8, 1024])
def test_bitwise_window_sums_on_the_card(n_points, monkeypatch):
    """msm_bitwise_windows_device on CUDA tensors (its adds through the
    Edwards-add kernel) against the same function on the plain add."""
    from blobstreamx_tpu_torch.fields import gf25519 as f
    from blobstreamx_tpu_torch.ops import curve25519 as curve, msm

    _card()
    rng = np.random.default_rng(n_points)
    lanes = add_lanes(rng, n_points)
    pts = tuple(f.from_int([pq[0][i] for pq in lanes], "cuda") for i in range(4))
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(n_points)]
    bits = torch.from_numpy(msm.scalars_to_digits(scalars, 1).astype(np.int64)).cuda()
    got = msm.msm_bitwise_windows_device(pts, bits)
    monkeypatch.setattr(curve, "add_fused", curve.add)
    want = msm.msm_bitwise_windows_device(pts, bits)
    for kc, pc in zip(got, want):
        assert torch.equal(kc, f.canonicalize(pc))


@pytest.mark.parametrize("k,n", [(None, 64), (None, 4096), (None, 33), (1, 64), (5, 64), (50, 64)])
def test_power_chain_kernel(k, n):
    from blobstreamx_tpu_torch.fields import gf25519 as f

    _card()
    a = fe(np.random.default_rng(3), n)
    got = f._chain_cuda(a, k)
    want = f.pow22523_plain(a) if k is None else f.sqn_plain(a, k)
    assert torch.equal(got, f.canonicalize(want)) and torch.equal(got, f.canonicalize(got))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1,n2", [(1, 2), (1024, 2048), (2048, 2048)])
def test_twiddle_transpose_kernel(n1, n2, inverse):
    from blobstreamx_tpu_torch.ops import ntt

    _card()
    log_n = (n1 * n2).bit_length() - 1
    m = gl(np.random.default_rng(n1 + n2), (n1, n2))
    k, p = ntt._twiddle_transpose_cuda(m, log_n, inverse), ntt.twiddle_transpose_plain(m, log_n, inverse)
    assert k[0].shape == (n2, n1)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 2, 21, 22])
def test_four_step_kernels(log_n, inverse):
    """Each launch of the two-launch four-step against its plain version:
    the first at (n1, n2) = (1, 2), (2, 2), (1024, 2048), (2048, 2048), its
    u64 intermediate through its (lo, hi) split; the last at (n2, n1)."""
    from blobstreamx_tpu_torch.ops import ntt

    _card()
    n1, n2 = ntt.four_step_shape(log_n)
    rng = np.random.default_rng(log_n + 40)
    m = gl(rng, (n1, n2))
    buf = ntt._four_step_first_cuda(m, log_n, inverse)
    assert buf.shape == (n2, n1) and buf.dtype == torch.int64
    k, p = ntt.gl_from_scratch(buf), ntt.four_step_first_plain(m, log_n, inverse)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    g = gl(rng, (n2, n1))
    k, p = ntt._four_step_last_cuda(ntt.scratch_from_gl(g), log_n, inverse), ntt.four_step_last_plain(g, log_n, inverse)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [0, 1, 5, 11, 21, 22])
def test_ntt_four_step_on_the_card(log_n, inverse):
    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.ops import ntt

    _card()
    x = gl(np.random.default_rng(log_n), (1 << log_n,))
    kernels.reset_counts()
    k = ntt.ntt_four_step(x, inverse)
    # up to 2^28 the four-step is two launches, one of each kernel, and no other
    assert {name: c for name, c in kernels.launches.items() if c} == {"four_step_first": 1, "four_step_last": 1}
    p = ntt.ntt_four_step_plain(x, inverse)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    col = ntt.ntt_cols((x[0][:, None], x[1][:, None]), inverse)
    assert torch.equal(k[0], col[0][:, 0]) and torch.equal(k[1], col[1][:, 0])


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [5, 22])
def test_four_step_long_column_route_on_the_card(log_n, inverse):
    """The route ntt_four_step takes above 2^28 (NTT kernel, twiddle-transpose
    kernel, NTT kernel), run at a length that fits the two-launch route, is
    word for word the two-launch four-step."""
    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.ops import ntt

    _card()
    x = gl(np.random.default_rng(log_n + 7), (1 << log_n,))
    kernels.reset_counts()
    k = ntt._four_step_long_columns_cuda(x, inverse)
    assert kernels.launches["twiddle_transpose"] == 1 and kernels.launches["ntt"] == 2
    p = ntt.ntt_four_step(x, inverse)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_streaming_prover_on_the_card_equals_the_cpu():
    """prove_streaming on the card (multi-launch NTT, Poseidon, the class
    evaluation in row ranges) gives stark.prove's bytes on the CPU, on a
    one-message SHA-256 AIR (128 rows, three column chunks)."""
    from blobstreamx_tpu_torch.prover import serialize, sha_air, stark, stark_stream
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    _card()
    chain, blocks = sha_air.plan_blocks([b"\x00" + bytes(range(64))])
    trace, aux = sha_air.build_sha_trace(chain, blocks)
    air = sha_air.Sha256Air(chain)
    cfg = StarkConfig(rate_bits=2, num_query_rounds=4, proof_of_work_bits=2)
    on_card = stark_stream.prove_streaming(air, trace, [], cfg, aux=aux, col_chunk=512, device="cuda")
    on_cpu = stark.prove(air, trace, [], cfg, aux=aux, device="cpu")
    assert serialize.stark_proof_to_bytes(on_card) == serialize.stark_proof_to_bytes(on_cpu)


def test_step_on_the_card_equals_the_cpu():
    """prove_step on the card (the tile NTT, Poseidon, the Edwards add and
    the power chain) gives the CPU's proof bytes on tests/test_pipeline.py's
    chain, step 9 -> 10."""
    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.circuits import fixtures as fx, step
    from blobstreamx_tpu_torch.prover import pipeline
    from blobstreamx_tpu_torch.prover.config import StarkConfig
    from blobstreamx_tpu_torch.prover.serialize import step_proof_to_bytes

    _card()
    cfg = StarkConfig(rate_bits=2, cap_height=1, num_query_rounds=12, proof_of_work_bits=4, final_poly_len=4)
    chain = fx.generate_chain(seed=11, n_headers=12, n_validators=4, rotate_every=4, sign_fraction=0.75,
                              sign_heights={10})
    w = step.build_step_witness(chain, prev_height=9)
    kernels.reset_counts()
    on_card = pipeline.prove_step(w, cfg, device="cuda")
    assert all(kernels.launches[k] > 0 for k in ("ntt", "poseidon", "edwards_add", "pow_chain")), kernels.launches
    on_cpu = pipeline.prove_step(w, cfg, device="cpu")
    assert step_proof_to_bytes(on_card) == step_proof_to_bytes(on_cpu)
    assert pipeline.verify_step_proof(on_card, cfg)


# ----------------------------------------------------------------------------
# parallel/: two gloo ranks sharing the card (tests/torch_parallel_ranks.py's
# "d2" mesh on cuda), held to the single-device port on the CPU
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_ranks(tmp_path_factory):
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    _card()
    out = tmp_path_factory.mktemp("card_ranks")
    script = Path(__file__).resolve().parent / "torch_parallel_ranks.py"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "2", str(out / "store"), str(out), "cuda"],
                              env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(2)]


def _card_values(card_ranks, check, case):
    got = [res[("d2", check, case)] for res in card_ranks]
    for v in got:
        assert not (isinstance(v, str) and v.startswith("raised")), v
    return got


def _golden_msm(points, scalars):
    from blobstreamx_tpu_torch.golden import ed25519 as ged

    acc = ged.IDENTITY
    for s, p in zip(scalars, points):
        acc = ged.point_add(acc, ged.point_mul(s, p))
    return acc


@pytest.mark.parametrize("log_n", [4, 7, 10])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_sharded_on_the_card(card_ranks, log_n, inverse):
    import torch_parallel_ranks as R
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt

    x = R.gl_input(log_n, (1 << log_n,))
    want = gf64.to_u64(ntt.ntt_cols_plain(gf64.from_u64(x[:, None]), inverse))[:, 0]
    for got in _card_values(card_ranks, "ntt_sharded", (log_n, inverse)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(32, 16), (32, 7)])
def test_lde_cols_sharded_on_the_card(card_ranks, shape):
    import torch_parallel_ranks as R
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import ntt

    want = gf64.to_u64(ntt.lde_cols(gf64.from_u64(R.gl_input(3, shape)), 2))
    np.testing.assert_array_equal(np.concatenate(_card_values(card_ranks, "lde_cols_local", shape), axis=1), want)


@pytest.mark.parametrize("cap", [0, 1, 2, 3])
def test_poseidon_tree_sharded_on_the_card(card_ranks, cap):
    import torch_parallel_ranks as R
    from blobstreamx_tpu_torch.fields import gf64
    from blobstreamx_tpu_torch.ops import merkle

    tree = merkle.build_tree(gf64.from_u64(R.gl_input(5, (8, 64))), cap)
    paths = {}
    for got_cap, got_paths in _card_values(card_ranks, "poseidon_tree", cap):
        assert got_cap == gf64.to_u64(tree.cap).T.tolist()
        paths.update(got_paths)
    assert paths == {i: tree.path(i) for i in range(64)}


@pytest.mark.parametrize("n", [64, 48])
def test_data_commitment_sharded_on_the_card(card_ranks, n):
    import torch_parallel_ranks as R
    from blobstreamx_tpu_torch.circuits.data_commitment import data_commitment_device

    want = data_commitment_device(*R.tuple_input(n), "cpu")
    assert all(v == want for v in _card_values(card_ranks, "data_commitment", n))
    if n == 64:
        assert all(v == want for v in _card_values(card_ranks, "tuple_tree_root", 64))


@pytest.mark.parametrize("check,case", [("msm_sharded", "n1"), ("msm_sharded", "n5"), ("msm_sharded", "n8"),
                                        ("msm_bitwise_sharded", 3), ("msm_bitwise_sharded", 17)])
def test_msm_sharded_on_the_card(card_ranks, check, case):
    import torch_parallel_ranks as R
    from blobstreamx_tpu_torch.golden import ed25519 as ged

    n, c = R.MSM_CASES[case] if check == "msm_sharded" else (case, 1)
    want = _golden_msm(*R.msm_input(n, c))
    assert all(ged.point_equal(v, want) for v in _card_values(card_ranks, check, case))


def test_prove_skip_mesh_on_the_card_equals_the_cpu(card_ranks):
    import torch_parallel_ranks as R

    want = R.prove_skip_bytes(R.small_witness(), device="cpu")
    assert all(v == want for v in _card_values(card_ranks, "prove_skip", "default"))


def test_mesh_stark_in_many_rounds_on_the_card_equals_the_cpu(card_ranks):
    """The toy AIR through prove_streaming(col_chunk=8, mesh=) on the two
    ranks sharing the card: the single-device proof on the CPU, byte for byte."""
    import torch_parallel_ranks as R
    from blobstreamx_tpu_torch.prover import serialize, stark
    from blobstreamx_tpu_torch.prover.config import StarkConfig

    trace, publics, aux = R.toy_case()
    want = serialize.stark_proof_to_bytes(
        stark.prove(R.toy_air(), trace, publics, StarkConfig(**R.TOY_CFG), aux=aux, device="cpu"))
    assert all(v == want for v in _card_values(card_ranks, "stark", "toy_air_chunk8"))
