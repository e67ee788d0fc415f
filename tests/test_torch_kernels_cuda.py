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
    vals[:4] = [0, f.Q - 1, f.Q, (1 << 256) - 1]
    return f.from_int(vals, "cuda")


@pytest.mark.parametrize("n,c,inverse", [(32, 8, True), (256, 8, False), (256, 2, True), (1 << 15, 4, False)])
def test_ntt_kernel(n, c, inverse):
    from blobstreamx_tpu_torch.ops import ntt

    _card()
    x = gl(np.random.default_rng(n + c), (n, c))
    k, p = ntt._ntt_cols_cuda(x, inverse), ntt.ntt_cols_plain(x, inverse)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_poseidon_kernel():
    from blobstreamx_tpu_torch.ops import poseidon as pos

    _card()
    s = gl(np.random.default_rng(1), (12, 4096))
    k, p = pos._permute_cuda(s), pos.permute_plain(s)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


def test_edwards_add_kernel():
    from blobstreamx_tpu_torch.fields import gf25519 as f
    from blobstreamx_tpu_torch.golden import ed25519 as ged
    from blobstreamx_tpu_torch.ops import curve25519 as curve

    _card()
    rng = np.random.default_rng(2)
    pts = [ged.point_mul(int(rng.integers(1, 1 << 62)), ged.BASE) for _ in range(256)]
    p = tuple(f.from_int([pt[i] for pt in pts], "cuda") for i in range(4))
    q = tuple(c.roll(1, dims=1) for c in p)
    k, pl = curve._add_cuda(p, q), curve.add(p, q)
    for kc, pc in zip(k, pl):
        assert torch.equal(kc, f.canonicalize(pc)) and torch.equal(kc, f.canonicalize(kc))


@pytest.mark.parametrize("k", [None, 1, 5, 50])
def test_power_chain_kernel(k):
    from blobstreamx_tpu_torch.fields import gf25519 as f

    _card()
    a = fe(np.random.default_rng(3), 64)
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
@pytest.mark.parametrize("log_n", [5, 11, 22])
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
