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
