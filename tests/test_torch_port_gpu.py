"""Card tests of the port: the CUDA attention kernel against its plain
version, the backward kernel against ``mhsa_backward`` and autograd of the
plain version, ``FusedSmallMHSA``'s gradient, the NRMS serving path and
train step with the kernels against the same paths with the plain
attention, a train step of each zoo model, the FairRec models (MANNeR's
attention shapes, train steps against the plain route, an A-module step),
the PLM tower (a checkpoint loaded on the card, scores against the
CPU's, frozen layers bit-identical after train steps), and the Adressa ETL's
native host parser with NRMS's recommendation export.  They need an
NVIDIA card and skip without one;
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
from newsreclib_tpu_torch.models.components.attention import use_plain_attention
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
                                     (256, 50, 300, 15), (64, 50, 300, 15), (8, 6, 24, 4),
                                     (33, 30, 60, 6), (7, 64, 96, 3)])
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
    others hold a prefix ("prefix") or a random subset ("random") of keys,
    or ("tiles") a random subset with keys 64-127 masked, and in every third
    row keys 0-139 too."""
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy(rng.normal(size=(u, l, 3 * d)).astype(np.float32)).to(dtype)
    if masking == "prefix":
        mask = np.arange(l)[None, :] < rng.integers(1, l + 1, size=(u, 1))
    else:
        mask = rng.random((u, l)) < 0.6
    if masking == "tiles":  # a 64-key tile of masked keys between valid ones, and
        mask[:, 64:128] = False  # rows whose first tiles are all masked
        mask[1::3, :140] = False
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


def test_kernel_runs_with_and_without_grad(cuda):
    """With grad the wrapper goes through ``FusedSmallMHSA`` (one launch,
    a graph to backpropagate); under no_grad / inference_mode it launches
    the kernel alone."""
    qkv, mask = _edge_inputs(8, 30, 300, torch.float32, seed=3, masking="prefix")
    x = qkv.clone().requires_grad_(True)
    want = mhsa.mhsa_plain(qkv, mask, 15)
    before = mhsa.launches
    got = mhsa.fused_small_mhsa(x, mask, 15)
    assert got.grad_fn is not None and mhsa.launches == before + 1
    torch.testing.assert_close(got.detach(), want, **TOL[torch.float32])
    with torch.no_grad():
        got = mhsa.fused_small_mhsa(x, mask, 15)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    with torch.inference_mode():
        got = mhsa.fused_small_mhsa(x, mask, 15)
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert mhsa.launches == before + 3


TRAIN_SHAPES = [(1792, 16), (256, 30), (64, 50)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l", TRAIN_SHAPES)
def test_fused_gradient_matches_plain_autograd(cuda, u, l, dtype):
    """At the NRMS train step's shapes: the output and d(sum(w * out))/d qkv
    of ``FusedSmallMHSA`` against autograd of ``mhsa_plain``; both compute
    in float32 and round once to the input type."""
    qkv, mask = _edge_inputs(u, l, 300, dtype, seed=u + l, masking="prefix")
    w = torch.randn((u, l, 300), generator=torch.Generator().manual_seed(l)).to(dtype).cuda()
    x = qkv.clone().requires_grad_(True)
    y = qkv.clone().requires_grad_(True)
    out = mhsa.FusedSmallMHSA.apply(x, mask, 15)
    (out * w).sum().backward()
    ref = mhsa.mhsa_plain(y, mask, 15)
    (ref * w).sum().backward()
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])
    assert x.grad.dtype == dtype and torch.isfinite(x.grad).all()
    torch.testing.assert_close(x.grad.float(), y.grad.float(), **TOL[dtype])


def test_kernel_raises_on_unsupported_input(cuda):
    qkv, mask = _inputs(2, 129, 24, torch.float32, seed=0)
    with pytest.raises(ValueError):
        mhsa.fused_small_mhsa(qkv, mask, 5)
    with pytest.raises(TypeError):
        mhsa.fused_small_mhsa(qkv[:, :16].half().contiguous(), mask[:, :16].contiguous(), 4)


@pytest.mark.parametrize("l,d,h,dtype", [(200, 300, 15, torch.float16),
                                         (129, 300, 7, torch.float32),
                                         (16, 1025, 1, torch.bfloat16),
                                         (300, 2050, 2, torch.float32)])
def test_refused_shapes_raise_in_the_wrapper_and_in_the_model(cuda, l, d, h, dtype):
    """What ``kernel_supports`` still refuses raises on the card, in the
    wrapper and in ``MultiHeadSelfAttention``: float16, heads that do not
    divide D (the module refuses them when built) and head dims above
    1,024.  Nothing gives way to the plain version, and nothing is
    launched.  (L = 129, head dim 129 and head dims above 64 at L above 64,
    refused before the long instances: ``LONG_SHAPES``.)"""
    from newsreclib_tpu_torch.models.components.attention import MultiHeadSelfAttention

    assert not mhsa.kernel_supports(l, d, h, dtype)
    qkv = torch.zeros((3, l, 3 * d), dtype=dtype, device=cuda)
    mask = torch.ones((3, l), dtype=torch.bool, device=cuda)
    before = mhsa.launches
    with pytest.raises((ValueError, TypeError)):
        mhsa.fused_small_mhsa(qkv, mask, h)
    if d % h:
        with pytest.raises(ValueError, match="divisible"):
            MultiHeadSelfAttention(d, h)
    else:
        module = MultiHeadSelfAttention(d, h).to(cuda, dtype)
        with pytest.raises((ValueError, TypeError)):
            module(torch.zeros((3, l, d), dtype=dtype, device=cuda), mask)
    assert mhsa.launches == before


# The long instances (``long_instance``): the shapes refused before them
# (L = 129, head dim 129, head dims above 64 at L above 64), NRMS's user
# encoder at history 200, the PLM head at 257 tokens, CAUM's default head
# dim 100 at L = 100, head dims 150 and 1,024, L = 1 and 300; the edges of
# the tensor-core instances: head dim 20 at L = 150, head dim 130 in one
# partial tile, head dims 255 and 257 (just below and above their bound).
LONG_SHAPES = [(7, 129, 64, 1), (9, 129, 300, 15), (5, 64, 129, 1), (6, 65, 130, 2),
               (4, 128, 256, 2), (9, 200, 300, 15), (5, 257, 768, 16), (6, 100, 400, 4),
               (5, 200, 300, 2), (3, 129, 1024, 1), (4, 300, 600, 2), (11, 1, 2048, 2),
               (5, 150, 60, 3), (4, 40, 260, 2), (3, 100, 255, 1), (3, 70, 514, 2)]


@pytest.mark.parametrize("masking", ["prefix", "random", "tiles"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h", LONG_SHAPES)
def test_long_shapes_run_in_the_wrapper_and_in_the_model(cuda, u, l, d, h, dtype, masking):
    """The long instances on the card: the forward kernel against
    ``mhsa_plain``, the backward kernel against ``mhsa_backward`` and
    autograd of ``mhsa_plain`` (fully masked rows: no q or k gradient), one
    long launch each way; and ``MultiHeadSelfAttention`` against the same
    module on the plain attention."""
    from newsreclib_tpu_torch.models.components.attention import MultiHeadSelfAttention

    assert mhsa.long_instance(l, d, h) and mhsa.kernel_supports(l, d, h, dtype)
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=u * 3 + l, masking=masking)
    before = mhsa.long_launches, mhsa.long_bwd_launches
    _check_against_plain(qkv, mask, h)
    got = _check_backward(qkv, mask, h, _grad_out(u, l, d, dtype, seed=l + 5))
    assert bool((got[~mask.any(dim=1)][:, :, :2 * d] == 0).all())
    assert (mhsa.long_launches, mhsa.long_bwd_launches) == (before[0] + 1, before[1] + 1)
    module = MultiHeadSelfAttention(d, h, torch.Generator().manual_seed(l)).to(cuda, dtype)
    plain = copy.deepcopy(module)
    plain.attention = mhsa.mhsa_plain
    x = torch.randn((u, l, d), generator=torch.Generator().manual_seed(d)).to(cuda, dtype)
    with torch.no_grad():
        torch.testing.assert_close(module(x, mask).float(), plain(x, mask).float(),
                                   **TOL[dtype])
    assert mhsa.long_launches == before[0] + 2


def _plain_model(model):
    return use_plain_attention(copy.deepcopy(model))


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


@pytest.mark.parametrize("compute_dtype,tol", [(None, 1e-4), ("bfloat16", 2e-2)])
def test_train_step_kernel_route_matches_plain_route(cuda, compute_dtype, tol):
    """Three NRMS train steps at full width (dropout on, same seeds; AdamW
    with the global-norm clip) with the kernel and with the plain
    attention: per-step losses agree; the
    kernel route launches the kernel twice a step (title encoder, user
    encoder), the plain route never."""
    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    cfg = SyntheticConfig(vocab_size=5000)
    batches = [to_device(make_batch(np.random.default_rng(i), batch_size=16, unique_news=256,
                                    cfg=cfg), cuda) for i in range(3)]
    model = NRMS(5000, device=cuda)
    losses = {}
    for route, m in (("kernel", model), ("plain", _plain_model(model))):
        state = create_train_state(m, make_optimizer(1e-3, weight_decay=0.01,
                                                     grad_clip_norm=1.0), dropout_seed=0)
        step = make_train_step(cross_entropy_loss, compute_dtype=compute_dtype)
        before = mhsa.launches
        losses[route] = [step(state, b)[1]["loss"].item() for b in batches]
        assert mhsa.launches == before + (2 * len(batches) if route == "kernel" else 0)
    np.testing.assert_allclose(losses["kernel"], losses["plain"], atol=tol, rtol=0)


# The backward kernel.  Every NRMS training shape (kernel_bench.TRAIN_SHAPES)
# and the serving path's (4096, 16), L = 1, 15 and 64, other head dims, and
# the edges of kernel_supports: f32 (64, 50), (L, D) = (64, 300), and a bf16
# slab of 230,400 bytes at (64, 600) with 20 heads of 30 (which f32 takes too,
# staging one head's columns).
BACKWARD_SHAPES = [(4096, 16, 300, 15), (3584, 16, 300, 15), (1792, 16, 300, 15),
                   (512, 30, 300, 15), (256, 30, 300, 15), (64, 50, 300, 15), (7168, 16, 300, 15),
                   (1024, 30, 300, 15), (256, 50, 300, 15), (9, 1, 300, 15), (33, 15, 300, 15),
                   (20, 64, 300, 15), (50, 17, 24, 4), (50, 33, 32, 4), (20, 64, 96, 3),
                   (3, 64, 300, 15), (3, 64, 600, 20)]


def _grad_out(u, l, d, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(u, l, d)).astype(np.float32)).to(dtype).cuda()


def _check_backward(qkv, mask, h, grad_out):
    """The backward kernel (one launch) against ``mhsa_backward`` and
    against autograd of ``mhsa_plain``, on the same inputs."""
    before = mhsa.bwd_launches
    got = mhsa._backward(qkv, mask, h, grad_out)
    torch.cuda.synchronize()
    assert mhsa.bwd_launches == before + 1
    assert got.shape == qkv.shape and got.dtype == qkv.dtype and torch.isfinite(got).all()
    want = mhsa.mhsa_backward(qkv, mask, h, grad_out)
    torch.testing.assert_close(got.float(), want.float(), **TOL[qkv.dtype])
    x = qkv.detach().clone().requires_grad_(True)
    want = torch.autograd.grad(mhsa.mhsa_plain(x, mask, h), x, grad_out)[0]
    torch.testing.assert_close(got.float(), want.float(), **TOL[qkv.dtype])
    return got


@pytest.mark.parametrize("masking", ["prefix", "random"])
@pytest.mark.parametrize("u,l,d,h,dtype", [
    (*shape, dtype) for shape in BACKWARD_SHAPES for dtype in (torch.float32, torch.bfloat16)
    if mhsa.kernel_supports(*shape[1:], dtype)])
def test_backward_kernel_matches_plain(cuda, u, l, d, h, dtype, masking):
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=u * 7 + l, masking=masking)
    _check_backward(qkv, mask, h, _grad_out(u, l, d, dtype, seed=l))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [16, 30, 50])
def test_backward_kernel_masked_rows(cuda, l, dtype):
    """Fully masked sequences get dQ = dK = 0 and dV = the mean of dO over
    their L rows; masked query rows carry a zero dO, as the caller's
    zeroing gives them."""
    u, d = 70, 300
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=l, masking="random")
    empty = ~mask.any(dim=1)
    grad_out = _grad_out(u, l, d, dtype, seed=l + 1) * (mask | empty[:, None])[..., None]
    got = _check_backward(qkv, mask, 15, grad_out)
    assert empty.sum() >= 10
    assert bool((got[empty][..., :2 * d] == 0).all())
    mean = grad_out[empty].float().mean(dim=1, keepdim=True).expand(-1, l, -1)
    torch.testing.assert_close(got[empty][..., 2 * d:].float(), mean, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l", [(6, 16), (5, 49), (4, 1)])
def test_backward_kernel_on_unaligned_storage(cuda, u, l, dtype):
    """qkv and dO that start off a 16-byte (and a 4-byte) boundary."""
    base, mask = _edge_inputs(u, l, 300, dtype, seed=l, masking="random")
    go_base = _grad_out(u, l, 300, dtype, seed=3)
    for shift in (1, 3):
        buf = torch.zeros(base.numel() + shift, dtype=dtype, device=base.device)
        qkv = buf[shift:].view(base.shape)
        qkv.copy_(base)
        gbuf = torch.zeros(go_base.numel() + shift, dtype=dtype, device=base.device)
        grad_out = gbuf[shift:].view(go_base.shape)
        grad_out.copy_(go_base)
        _check_backward(qkv, mask, 15, grad_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_takes_expanded_and_strided_grad_out(cuda, dtype):
    """``out.sum().backward()`` hands over an expanded (stride 0) dO, and a
    strided one goes in as it is: both are made contiguous first."""
    qkv, mask = _edge_inputs(40, 30, 300, dtype, seed=5, masking="prefix")
    x = qkv.clone().requires_grad_(True)
    before = mhsa.bwd_launches
    mhsa.FusedSmallMHSA.apply(x, mask, 15).sum().backward()
    assert mhsa.bwd_launches == before + 1
    want = mhsa.mhsa_backward(qkv, mask, 15, torch.ones_like(qkv[..., :300]))
    torch.testing.assert_close(x.grad.float(), want.float(), **TOL[dtype])
    strided = _grad_out(30, 40, 300, dtype, seed=6).transpose(0, 1)
    got = mhsa._backward(qkv, mask, 15, strided)
    want = mhsa.mhsa_backward(qkv, mask, 15, strided.contiguous())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_backward_kernel_with_no_sequences(cuda):
    qkv = torch.zeros((0, 16, 900), device=cuda)
    mask = torch.zeros((0, 16), dtype=torch.bool, device=cuda)
    got = mhsa._backward(qkv, mask, 15, torch.zeros((0, 16, 300), device=cuda))
    assert got.shape == (0, 16, 900)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_kernel_is_deterministic(cuda, dtype):
    """No atomics: two runs give the same bits, one launch each."""
    qkv, mask = _edge_inputs(1001, 30, 300, dtype, seed=8, masking="random")
    grad_out = _grad_out(1001, 30, 300, dtype, seed=9)
    before = mhsa.bwd_launches
    a = mhsa._backward(qkv, mask, 15, grad_out)
    b = mhsa._backward(qkv, mask, 15, grad_out)
    torch.cuda.synchronize()
    assert mhsa.bwd_launches == before + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("u,l", [(3584, 16), (1792, 16), (64, 50)])
def test_f32_backward_is_bitwise_repeatable_at_cli_shapes(cuda, u, l):
    """The training CLI's float32 route (the title encoder at L = 16, the
    user encoder at (64, 50)): each dqkv value is written by one lane with
    no atomics, so two runs give the same bits."""
    qkv, mask = _edge_inputs(u, l, 300, torch.float32, seed=u + l, masking="prefix")
    grad_out = _grad_out(u, l, 300, torch.float32, seed=l)
    a = mhsa._backward(qkv, mask, 15, grad_out)
    b = mhsa._backward(qkv, mask, 15, grad_out)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    torch.testing.assert_close(a, mhsa.mhsa_backward(qkv, mask, 15, grad_out),
                               **TOL[torch.float32])


# The zoo's new shapes: MINS's user encoder (6 heads of 50, the wide
# instances) and CenNewsRec's / CAUM's D = 400 with 20 heads of 20 in f32
# (the hd = 20 instances, beyond the whole-slab rule of earlier versions);
# then the wide instances' edges: head dims 33, 48 (the PLM tower's 16 heads
# over 768), 55 (odd, 4-byte staging), 64, L = 1, 17, 64, U not a multiple
# of anything; since the box grew, L = 65, 96, 127 and 128, head dims 65,
# 100 (CAUM's default 4 heads over 400) and 128, head dims up to 32 at L
# above 64, and a bf16 slab of (64, 960) beyond one block (32 heads of 30).
ZOO_SHAPES = [(64, 50, 300, 6), (320, 50, 400, 20), (64, 50, 400, 20), (512, 30, 400, 20)]
WIDE_SHAPES = [(9, 50, 300, 6), (7, 64, 192, 3), (33, 17, 96, 2), (20, 32, 768, 16),
               (13, 49, 330, 6), (5, 1, 300, 6), (3, 64, 4096, 64), (11, 16, 132, 4),
               (64, 96, 768, 16), (21, 65, 300, 15), (9, 96, 96, 2), (7, 127, 64, 1),
               (5, 128, 128, 2), (6, 128, 20, 1), (11, 80, 330, 10), (9, 50, 400, 4),
               (7, 33, 130, 2), (5, 64, 256, 2), (9, 50, 128, 1), (3, 100, 300, 15),
               (64, 64, 960, 32), (4, 17, 500, 5)]


@pytest.mark.parametrize("masking", ["prefix", "random"])
@pytest.mark.parametrize("u,l,d,h,dtype", [
    (*shape, dtype) for shape in ZOO_SHAPES + WIDE_SHAPES
    for dtype in (torch.float32, torch.bfloat16) if mhsa.kernel_supports(*shape[1:], dtype)])
def test_zoo_shapes_forward_and_backward_match_plain(cuda, u, l, d, h, dtype, masking):
    """The forward kernel against ``mhsa_plain`` and the backward kernel
    against ``mhsa_backward`` and autograd of ``mhsa_plain``; a shape of the
    wide instances (``wide_instance``) counts as a wide launch, each way."""
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=u * 5 + l, masking=masking)
    wide = mhsa.wide_instance(l, d, h, dtype)
    before = mhsa.wide_launches, mhsa.wide_bwd_launches
    _check_against_plain(qkv, mask, h)
    _check_backward(qkv, mask, h, _grad_out(u, l, d, dtype, seed=l + 2))
    assert (mhsa.wide_launches, mhsa.wide_bwd_launches) == (before[0] + wide, before[1] + wide)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_backward_masked_rows_and_repeatable(cuda, dtype):
    """Fully masked sequences at head dim 50 get dQ = dK = 0 and dV = the
    mean of dO; two runs give the same bits (no atomics)."""
    u, l, d, h = 70, 50, 300, 6
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=4, masking="random")
    empty = ~mask.any(dim=1)
    grad_out = _grad_out(u, l, d, dtype, seed=5) * (mask | empty[:, None])[..., None]
    got = _check_backward(qkv, mask, h, grad_out)
    assert empty.sum() >= 10
    assert bool((got[empty][..., :2 * d] == 0).all())
    mean = grad_out[empty].float().mean(dim=1, keepdim=True).expand(-1, l, -1)
    torch.testing.assert_close(got[empty][..., 2 * d:].float(), mean, **TOL[dtype])
    assert torch.equal(got, mhsa._backward(qkv, mask, h, grad_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_kernel_on_unaligned_storage(cuda, dtype):
    """qkv and dO off a 16-byte (and a 4-byte) boundary at head dim 50."""
    base, mask = _edge_inputs(5, 49, 300, dtype, seed=6, masking="random")
    go_base = _grad_out(5, 49, 300, dtype, seed=7)
    for shift in (1, 3):
        buf = torch.zeros(base.numel() + shift, dtype=dtype, device=base.device)
        qkv = buf[shift:].view(base.shape)
        qkv.copy_(base)
        gbuf = torch.zeros(go_base.numel() + shift, dtype=dtype, device=base.device)
        grad_out = gbuf[shift:].view(go_base.shape)
        grad_out.copy_(go_base)
        _check_against_plain(qkv, mask, 6)
        _check_backward(qkv, mask, 6, grad_out)


@pytest.mark.parametrize("name", ["mins", "cen_news_rec", "caum"])
def test_zoo_train_step_kernel_route_matches_plain_route(cuda, name):
    """Two full-width f32 train steps of each zoo model (dropout on, same
    seeds) with the kernels and with the plain attention: per-step losses
    agree (1e-4), and the kernel route launches the forward and the
    backward kernel once per attention call."""
    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    cfg = SyntheticConfig(vocab_size=5000, entity_vocab_size=800)
    batches = [to_device(make_batch(np.random.default_rng(i), batch_size=16, unique_news=256,
                                    cfg=cfg), cuda) for i in range(2)]
    info = factory.DataInfo(vocab_size=5000, entity_vocab_size=800)
    model = factory.build_model({"name": name}, info, device=cuda)
    calls = {"mins": 3, "cen_news_rec": 2, "caum": 2}[name]  # attentions a step
    losses = {}
    for route, m in (("kernel", model), ("plain", _plain_model(model))):
        state = create_train_state(m, make_optimizer(1e-3), dropout_seed=0)
        step = make_train_step(cross_entropy_loss)
        before = mhsa.launches, mhsa.bwd_launches
        losses[route] = [step(state, b)[1]["loss"].item() for b in batches]
        n = calls * len(batches) if route == "kernel" else 0
        assert (mhsa.launches, mhsa.bwd_launches) == (before[0] + n, before[1] + n)
    np.testing.assert_allclose(losses["kernel"], losses["plain"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h", [(512, 96, 768, 16), (64, 50, 300, 6), (64, 50, 400, 4),
                                     (20, 128, 64, 1), (20, 64, 256, 2)])
def test_wide_backward_gives_the_same_bits_twice(cuda, u, l, d, h, dtype):
    """The wide backward sums dQ in the warp of its query tile and dK, dV in
    the warp of their key tile, in a fixed order, with no atomics: two runs
    give the same bits, with fully masked sequences among the inputs."""
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=u + l + d, masking="random")
    grad_out = _grad_out(u, l, d, dtype, seed=d)
    before = mhsa.wide_bwd_launches
    a = mhsa._backward(qkv, mask, h, grad_out)
    b = mhsa._backward(qkv, mask, h, grad_out)
    torch.cuda.synchronize()
    assert mhsa.wide_bwd_launches == before + 2
    assert torch.isfinite(a).all() and torch.equal(a, b)
    torch.testing.assert_close(a.float(), mhsa.mhsa_backward(qkv, mask, h, grad_out).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_element_checks_reject_the_planted_faults_at_the_plm_shape(cuda, dtype):
    """At the PLM head's (512, 96, 768, 16), ``kernel_bench.check_backward``
    passes the kernels and rejects each planted fault that ``chip_smoke.py``
    plants there (``ELEMENT_FAULTS``: logits 10% too large in float32, the
    gradient's rowsum term dropped in both types)."""
    import chip_smoke
    from newsreclib_tpu_torch.kernel_bench import check_backward, dtype_name

    check_backward(512, 96, dtype, d=768, h=16)
    faults = chip_smoke.element_faults()
    for fault in chip_smoke.ELEMENT_FAULTS[dtype_name(dtype)]:
        with pytest.raises(AssertionError):
            check_backward(512, 96, dtype, d=768, h=16, **faults[fault])


@pytest.mark.parametrize("name", ["naml", "tanr", "lstur", "npa", "miner", "dkn"])
def test_glove_zoo_model_trains_a_step_on_the_card(cuda, name):
    """NAML, TANR, LSTUR, NPA, MINER and DKN from the factory at their
    config files' widths build on the card and take one float32 train step
    (dropout and LSTUR's user masking on) with a finite loss and finite
    scores; MINER's title encoder launches the forward and the backward
    kernel once per news segment, the others launch neither."""
    from newsreclib_tpu_torch.config.compose import compose
    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    cfg = SyntheticConfig(vocab_size=5000, entity_vocab_size=800)
    batch = to_device(make_batch(np.random.default_rng(0), batch_size=16, unique_news=256,
                                 cfg=cfg), cuda)
    info = factory.DataInfo(vocab_size=5000, entity_vocab_size=800, num_users=cfg.num_users)
    model = factory.build_model(compose(overrides=[f"model={name}"])["model"], info, device=cuda)
    state = create_train_state(model, make_optimizer(1e-4), dropout_seed=0)
    before = mhsa.launches, mhsa.bwd_launches
    loss = make_train_step(cross_entropy_loss)(state, batch)[1]["loss"]
    n = 1 + (batch.news2 is not None) if name == "miner" else 0
    assert (mhsa.launches, mhsa.bwd_launches) == (before[0] + n, before[1] + n)
    assert bool(torch.isfinite(loss))
    with torch.no_grad():
        scores, _ = state.model(batch)
    assert scores.shape == batch.cand_idx.shape and bool(torch.isfinite(scores).all())


# MANNeR's title + abstract attention (kernel_bench.MANNER_SHAPES, 15 heads of
# 20 at L = 66 to 82: the wide instances at head dim 20)
MANNER_SHAPES = [(1792, 66, 300, 15), (256, 82, 300, 15), (64, 80, 300, 15)]


@pytest.mark.parametrize("masking", ["prefix", "random"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,l,d,h", MANNER_SHAPES)
def test_manner_shapes_forward_and_backward_match_plain(cuda, u, l, d, h, dtype, masking):
    """Both kernels at MANNeR's shapes against the plain versions; every
    launch is a wide one."""
    qkv, mask = _edge_inputs(u, l, d, dtype, seed=u + l, masking=masking)
    assert mhsa.kernel_supports(l, d, h, dtype) and mhsa.wide_instance(l, d, h, dtype)
    before = mhsa.wide_launches, mhsa.wide_bwd_launches
    _check_against_plain(qkv, mask, h)
    _check_backward(qkv, mask, h, _grad_out(u, l, d, dtype, seed=l + 3))
    assert (mhsa.wide_launches, mhsa.wide_bwd_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("name", ["sentirec", "senti_debias", "manner_cr"])
def test_fair_rec_train_steps_kernel_route_matches_plain_route(cuda, name):
    """Two full-width float32 train steps of SentiRec, SentiDebias (its
    alternating G / D step) and MANNeR's CR module (SupCon) with the kernels
    and with the plain attention, dropout on, same seeds: per-step losses
    agree (1e-4), and the kernel route launches the forward and the backward
    kernel as ``profile_train.attention_launches`` counts."""
    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu_torch.profile_train import attention_launches, cell_state_and_step

    cfg = SyntheticConfig(vocab_size=5000, entity_vocab_size=800)
    batches = [to_device(make_batch(np.random.default_rng(i), batch_size=16, unique_news=256,
                                    cfg=cfg), cuda) for i in range(2)]
    losses = {}
    for route in ("kernel", "plain"):
        state, step = cell_state_and_step(name, cuda, None, 1e-3)
        if route == "plain":
            use_plain_attention(state.model)
        before = mhsa.launches, mhsa.bwd_launches
        losses[route] = [step(state, b)[1]["loss"].item() for b in batches]
        on = route == "kernel"
        fwd = sum(attention_launches(b, name) for b in batches) * on
        bwd = sum(attention_launches(b, name, backward=True) for b in batches) * on
        assert (mhsa.launches, mhsa.bwd_launches) == (before[0] + fwd, before[1] + bwd)
    assert all(np.isfinite(losses["kernel"]))
    np.testing.assert_allclose(losses["kernel"], losses["plain"], atol=1e-4, rtol=0)


def test_aspect_step_on_the_card(cuda):
    """Two SupCon steps of an A-module at ``manner_a.yaml``'s widths on
    m-per-class batches of 64 articles (L = 30 + 50): one wide launch each
    way a step, the plain route's losses."""
    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.news_batching import MPerClassNewsBatcher
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.profile_train import cell_config, cell_info
    from newsreclib_tpu_torch.training.aspect import make_aspect_train_step
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer

    store, _ = make_serving_workload(np.random.default_rng(0), corpus=2000, n_impressions=10)
    batches = [to_device(b, cuda) for _, b in
               zip(range(2), MPerClassNewsBatcher(store, "category", 64, 8).epoch(0))]
    losses = {}
    for route in ("kernel", "plain"):
        model = factory.build_manner_a(cell_config("manner_a"), cell_info(), device=cuda)
        if route == "plain":
            use_plain_attention(model)
        state = create_train_state(model, make_optimizer(1e-3))
        before = mhsa.wide_launches, mhsa.wide_bwd_launches
        losses[route] = [make_aspect_train_step()(state, b)[1]["loss"].item() for b in batches]
        n = 2 if route == "kernel" else 0
        assert (mhsa.wide_launches, mhsa.wide_bwd_launches) == (before[0] + n, before[1] + n)
    np.testing.assert_allclose(losses["kernel"], losses["plain"], atol=1e-4, rtol=0)


def _plm_nrms(tmp_path, device):
    """NRMS over a two-layer tower 96 wide (the head's 2 heads of 48: the
    wide instances) loaded by the factory from a checkpoint that
    ``save_as_hf_bert`` wrote, and the tower's weights."""
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.models.components import plm

    kw = dict(vocab_size=5000, hidden_dim=96, num_layers=2, num_heads=4, intermediate_dim=192,
              max_position=64)
    tower = plm.TransformerEncoder(**kw, generator=torch.Generator().manual_seed(3))
    ckpt = plm.save_as_hf_bert(tower.state_dict(), kw, str(tmp_path / "ckpt"))
    cfg = {"name": "nrms", "use_plm": True, "plm_model": ckpt, "num_heads": 2, "query_dim": 16,
           "loss": "sup_con_loss"}
    model = factory.build_model(cfg, factory.DataInfo(vocab_size=5000), device=device)
    return cfg, model, tower.state_dict()


def test_plm_checkpoint_loads_and_scores_on_the_card(cuda, tmp_path):
    """The factory loads the checkpoint into the tower on the card tensor for
    tensor; the card's scores (TF32 off) equal the same weights' on the
    CPU, with one wide forward launch per news segment and one for the
    user encoder."""
    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch

    _, model, tower = _plm_nrms(tmp_path, cuda)
    got = model.text_encoder_module.encoder.state_dict()
    assert all(got[k].device.type == cuda.type and torch.equal(got[k].cpu(), v)
               for k, v in tower.items())
    cpu = copy.deepcopy(model).cpu().eval()
    b = make_batch(np.random.default_rng(0), batch_size=8, unique_news=200,
                   cfg=SyntheticConfig(vocab_size=5000))
    before = mhsa.wide_launches
    with torch.no_grad():
        card_scores, _ = model.eval()(to_device(b, cuda))
        assert mhsa.wide_launches == before + 2
        want, _ = cpu(to_device(b, "cpu"))
    torch.testing.assert_close(card_scores.cpu(), want, atol=1e-4, rtol=1e-4)


def test_plm_frozen_layers_stay_bit_identical_on_the_card(cuda, tmp_path):
    """Two float32 train steps with ``model.frozen_layers: [0]`` (and the
    embeddings) through the training CLI's ``build_optimizer``: the frozen
    tensors bit-identical on the card, out of autograd, every other tensor
    moved (but the key biases, whose gradient is float32 noise), and the
    kernels launched each way once per attention call."""
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.profile_train import attention_launches
    from newsreclib_tpu_torch.training.state import create_train_state
    from newsreclib_tpu_torch.training.steps import make_train_step

    cfg, model, _ = _plm_nrms(tmp_path, cuda)
    cfg = dict(cfg, frozen_layers=[0])
    state = create_train_state(model, train.build_optimizer({"model": cfg, "trainer": {}}, 1,
                                                            model))
    step = make_train_step(factory.build_loss(cfg))
    store, imp = make_serving_workload(np.random.default_rng(0), corpus=2000, n_impressions=200,
                                       vocab_size=5000)
    batches = [b for _, b in zip(range(2), TrainBatcher(
        store, imp, batch_size=8, max_history_len=50, u_bucket_min=128,
        split_title_len=16).epoch(0))]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    launches = mhsa.launches, mhsa.bwd_launches
    losses = [step(state, to_device(b, cuda))[1]["loss"].item() for b in batches]
    calls = sum(attention_launches(b) for b in batches)
    assert (mhsa.launches, mhsa.bwd_launches) == (launches[0] + calls, launches[1] + calls)
    assert all(np.isfinite(losses))
    labels = state.tx.freeze_labels
    params = dict(model.named_parameters())
    after = model.state_dict()
    for k, label in labels.items():
        if label == "freeze":
            assert torch.equal(after[k], before[k]) and not params[k].requires_grad, k
        elif not k.endswith(".k.bias"):
            assert not torch.equal(after[k], before[k]), k
    assert sum(v == "freeze" for v in labels.values()) == 16 + 5


def test_adressa_native_parser_and_export_on_the_card(cuda, tmp_path, monkeypatch):
    """The Adressa ETL of ``write_adressa_fixture``'s tar through the native
    host parser (built with g++; arrays equal to the Python route's), then
    NRMS's recommendation export on the card: every test impression's
    candidates scored, within 1e-5 of the same weights' export on the CPU,
    with kernel launches on the card."""
    from newsreclib_tpu_torch.data import adressa, fastetl, testing

    testing.write_adressa_fixture(str(tmp_path))
    data = adressa.AdressaData(adressa.AdressaConfig(data_dir=str(tmp_path), neg_num=10))
    assert fastetl.get_lib() is not None
    store = data.news_store()
    imp = data.impressions("test")
    monkeypatch.setattr(fastetl, "_lib", None)  # the pure-Python route from here on
    monkeypatch.setattr(fastetl, "_lib_tried", True)
    python = data.impressions("test")
    for f in ("hist_flat", "hist_offsets", "cand_flat", "cand_offsets", "labels_flat",
              "user_idx"):
        assert np.array_equal(getattr(imp, f), getattr(python, f)), f
    cpu = NRMS(data.vocab_size(), embed_dim=60, num_heads=6, query_dim=16, device="cpu",
               generator=torch.Generator().manual_seed(0)).eval()
    card = copy.deepcopy(cpu).to(cuda)
    want = CachedScorer(cpu, device="cpu").export_recommendations(
        store, imp, str(tmp_path / "cpu.json"), max_history_len=10)
    before = mhsa.launches
    got = CachedScorer(card, device=cuda).export_recommendations(
        store, imp, str(tmp_path / "card.json"), max_history_len=10)
    assert mhsa.launches > before
    row2nid = {r: n for n, r in store.nid2row.items()}
    for i in range(len(imp)):
        assert all(row2nid[r] in got[f"U{imp.user_ids[i]}"] for r in imp.cands(i)[0])
    assert set(got) == set(want)
    for u in want:
        assert set(got[u]) == set(want[u])
        np.testing.assert_allclose([got[u][n] for n in want[u]], list(want[u].values()),
                                   **TOL[torch.float32])
