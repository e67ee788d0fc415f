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
@pytest.mark.parametrize("log_n", [5, 11, 21, 22])
def test_ntt_four_step_on_the_card(log_n, inverse):
    from blobstreamx_tpu_torch import kernels
    from blobstreamx_tpu_torch.ops import ntt

    _card()
    x = gl(np.random.default_rng(log_n), (1 << log_n,))
    kernels.reset_counts()
    k = ntt.ntt_four_step(x, inverse)
    assert kernels.launches["ntt"] == 2 and kernels.launches["twiddle_transpose"] == 1
    p = ntt.ntt_four_step_plain(x, inverse)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    col = ntt.ntt_cols((x[0][:, None], x[1][:, None]), inverse)
    assert torch.equal(k[0], col[0][:, 0]) and torch.equal(k[1], col[1][:, 0])


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
