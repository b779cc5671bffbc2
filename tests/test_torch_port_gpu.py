"""Card tests of the port: the CUDA attention kernel against its plain
version, and the NRMS serving path with the kernel against the same path
with the plain attention.  They need an NVIDIA card and skip without one;
this file imports no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_gpu.py

Tolerances: float32 atol/rtol 1e-5 (the same sums in another order);
bfloat16 atol 2e-2 / rtol 1e-2 against the plain version on the same bf16
inputs, computed in float32 and rounded once (about one bf16 step).
"""

import copy

import numpy as np
import pytest
import torch

from newsreclib_tpu_torch.data.synthetic import make_serving_workload
from newsreclib_tpu_torch.models.components.attention import MultiHeadSelfAttention
from newsreclib_tpu_torch.models.general_rec import NRMS
from newsreclib_tpu_torch.ops import mhsa
from newsreclib_tpu_torch.serving import CachedScorer

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(atol=1e-5, rtol=1e-5), torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(u, l, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((u, l, 3 * d), generator=g).to(dtype)
    lens = torch.randint(1, l + 1, (u,), generator=g)
    mask = torch.arange(l)[None, :] < lens[:, None]
    mask[0] = False
    return qkv.cuda(), mask.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h", [(4096, 16, 300, 15), (1024, 30, 300, 15),
                                     (256, 50, 300, 15), (8, 6, 24, 4), (33, 30, 60, 6),
                                     (7, 64, 96, 3)])
def test_kernel_matches_plain(cuda, u, l, d, h, dtype):
    qkv, mask = _inputs(u, l, d, dtype, seed=u + l)
    before = mhsa.launches
    got = mhsa.fused_small_mhsa(qkv, mask, h)
    torch.cuda.synchronize()
    assert mhsa.launches == before + 1
    want = mhsa.mhsa_plain(qkv, mask, h)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _edge_inputs(u, l, d, dtype, seed, masking):
    """qkv and a key mask with row 0 and every 7th row fully masked; the
    others hold a prefix ("prefix") or a random subset ("random") of keys."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(u, l, 3 * d)).astype(np.float32)).to(dtype)
    if masking == "prefix":
        mask = np.arange(l)[None, :] < rng.integers(1, l + 1, size=(u, 1))
    else:
        mask = rng.random((u, l)) < 0.6
    mask[::7] = False
    return qkv.cuda(), torch.from_numpy(mask).cuda()


def _check_against_plain(qkv, mask, h):
    before = mhsa.launches
    got = mhsa.fused_small_mhsa(qkv, mask, h)
    torch.cuda.synchronize()
    assert mhsa.launches == before + 1
    want = mhsa.mhsa_plain(qkv, mask, h)
    u, l, d3 = qkv.shape
    assert got.shape == (u, l, d3 // 3) and got.dtype == qkv.dtype
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[qkv.dtype])


# Lengths that pad the keys to 32 and 64 (odd L: slabs that are not 16-byte
# multiples), head dims 6 / 8 / 20 / 32, U = 1 and U not a multiple of the
# sequences per block (three at L = 16 and two at L = 30 in bf16).
EDGE_SHAPES = [(64, 17, 300, 15), (40, 30, 300, 15), (33, 49, 300, 15), (65, 50, 300, 15),
               (9, 64, 300, 15), (50, 17, 24, 4), (50, 33, 32, 4), (50, 16, 60, 3),
               (20, 64, 96, 3), (1, 16, 300, 15), (1, 50, 300, 15), (1, 1, 300, 15),
               (4097, 16, 300, 15), (1001, 30, 300, 15), (263, 50, 300, 15)]


@pytest.mark.parametrize("masking", ["prefix", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h", EDGE_SHAPES)
def test_kernel_edge_shapes_match_plain(cuda, u, l, d, h, dtype, masking):
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=u * 131 + l, masking=masking)
    _check_against_plain(qkv, mask, h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l", [(6, 16), (5, 49)])
def test_kernel_on_unaligned_storage_matches_plain(cuda, u, l, dtype):
    """qkv and out that start off a 16-byte boundary: the staging and the
    output copy take their byte / element paths."""
    base, mask = _edge_inputs(u, l, 300, dtype, seed=l, masking="random")
    for shift in (1, 3):
        buf = torch.zeros(base.numel() + shift, dtype=dtype, device=base.device)
        qkv = buf[shift:].view(base.shape)
        qkv.copy_(base)
        _check_against_plain(qkv, mask, 15)


def test_kernel_refuses_grad_and_runs_without(cuda):
    qkv, mask = _edge_inputs(8, 30, 300, torch.float32, seed=3, masking="prefix")
    x = qkv.clone().requires_grad_(True)
    before = mhsa.launches
    with pytest.raises(RuntimeError, match="no backward"):
        mhsa.fused_small_mhsa(x, mask, 15)
    assert mhsa.launches == before
    want = mhsa.mhsa_plain(qkv, mask, 15)
    with torch.no_grad():
        got = mhsa.fused_small_mhsa(x, mask, 15)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    with torch.inference_mode():
        got = mhsa.fused_small_mhsa(x, mask, 15)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert mhsa.launches == before + 2


def test_kernel_raises_on_unsupported_input(cuda):
    qkv, mask = _inputs(2, 65, 24, torch.float32, seed=0)
    with pytest.raises(ValueError):
        mhsa.fused_small_mhsa(qkv, mask, 4)
    with pytest.raises(TypeError):
        mhsa.fused_small_mhsa(qkv[:, :16].half().contiguous(), mask[:, :16].contiguous(), 4)


def _plain_model(model):
    plain = copy.deepcopy(model)
    for m in plain.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.attention = mhsa.mhsa_plain
    return plain


def test_serving_with_kernel_matches_plain_and_cpu(cuda):
    store, imp = make_serving_workload(np.random.default_rng(0), corpus=2000, n_impressions=300,
                                       vocab_size=5000)
    model = NRMS(5000, device=cuda).eval()
    before = mhsa.launches
    got = CachedScorer(model, device=cuda).evaluate(store, imp)
    assert mhsa.launches > before
    plain = CachedScorer(_plain_model(model), device=cuda).evaluate(store, imp)
    on_cpu = CachedScorer(copy.deepcopy(model).cpu(), device="cpu").evaluate(store, imp)
    for k in plain:
        assert abs(got[k] - plain[k]) < 1e-4, (k, got[k], plain[k])
        assert abs(got[k] - on_cpu[k]) < 1e-4, (k, got[k], on_cpu[k])
