"""The attention kernel's contract at the shapes the card takes since the
box grew (L up to 128 at head dim up to 64, head dim up to 128 at L up to
64; beyond it the long instances take any L and head dims up to 1,024), on
the CPU: the port's ``fused_small_mhsa`` against the TPU kernel
itself (Pallas, interpret mode, ``precision=HIGHEST``) and against JAX's
``mhsa_reference``, and ``FusedSmallMHSA``'s gradient against ``jax.grad``
of ``mhsa_reference``, from the same numpy inputs, with partly and fully
masked sequences; and the wrapper's routing and refusals at the rule's edges.
The CUDA kernels themselves are tested on the card
(``test_torch_port_gpu.py``).

Tolerance: float32 atol/rtol 1e-5 — the three compute the same sums in a
different order (the Pallas kernel online over the keys, the others by
softmax), which moves float32 results by a few ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.lax import Precision

from newsreclib_tpu.ops.mhsa import fused_small_mhsa as pallas_mhsa
from newsreclib_tpu.ops.mhsa import mhsa_reference
from newsreclib_tpu_torch.ops import mhsa

TOL = dict(atol=1e-5, rtol=1e-5)
# (U, L, D, heads): L = 96 at 2 heads of 48 (the PLM head's head dim at its
# title length), L = 128 at 2 heads of 16 (the longest L), L = 50 at 2 heads
# of 100 (CAUM's default head dim), and the corners of the box
NEW_SHAPES = [(6, 96, 96, 2), (5, 128, 32, 2), (6, 50, 200, 2), (3, 128, 64, 1),
              (3, 64, 128, 1), (4, 65, 40, 2)]


def _inputs(u, l, d, seed):
    """qkv ~ N(0, 1); sequence 1 fully masked, sequence 0 with its first key
    alone valid, the others random masks with the first key valid; an
    output gradient ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(u, l, 3 * d)).astype(np.float32)
    mask = rng.random((u, l)) < 0.7
    mask[:, 0] = True
    mask[0, 1:] = False
    mask[1] = False
    w = rng.normal(size=(u, l, d)).astype(np.float32)
    return qkv, mask, w


@pytest.mark.parametrize("u,l,d,h", NEW_SHAPES)
def test_forward_matches_pallas_interpret_and_reference(u, l, d, h):
    """The port's forward (its CPU route, ``mhsa_plain``) against the TPU
    kernel in interpret mode at valid query rows (it leaves masked query
    rows unspecified) and against ``mhsa_reference`` everywhere, the fully
    masked sequence's uniform attention included."""
    qkv, mask, _ = _inputs(u, l, d, seed=u * l + d)
    assert mhsa.kernel_supports(l, d, h, torch.float32)
    assert mhsa.kernel_supports(l, d, h, torch.bfloat16)
    got = mhsa.fused_small_mhsa(torch.from_numpy(qkv), torch.from_numpy(mask), h).numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(pallas_mhsa(jnp.asarray(qkv), jnp.asarray(mask), num_heads=h, block_u=8,
                                  interpret=True, precision=Precision.HIGHEST))
    m = mask[..., None]
    np.testing.assert_allclose(got * m, want * m, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(mhsa_reference(jnp.asarray(qkv), jnp.asarray(mask), h)), **TOL)
    np.testing.assert_allclose(got[1], np.broadcast_to(qkv[1, :, 2 * d:].mean(axis=0), (l, d)),
                               **TOL)


@pytest.mark.parametrize("u,l,d,h", NEW_SHAPES)
def test_gradient_matches_jax_grad_of_reference(u, l, d, h):
    """``FusedSmallMHSA``'s backward (its CPU route, ``mhsa_backward``)
    against ``jax.grad`` of ``mhsa_reference``: the fully masked sequence
    gets no gradient on q and k and the mean of dO on v."""
    qkv, mask, w = _inputs(u, l, d, seed=3 * u * l + d)
    want = np.asarray(jax.grad(
        lambda x: (mhsa_reference(x, jnp.asarray(mask), h) * jnp.asarray(w)).sum()
    )(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_(True)
    before = mhsa.bwd_launches
    (mhsa.FusedSmallMHSA.apply(x, torch.from_numpy(mask), h) * torch.from_numpy(w)).sum().backward()
    assert mhsa.bwd_launches == before
    got = x.grad.numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[1, :, :2 * d], 0.0)
    np.testing.assert_allclose(got[1, :, 2 * d:], np.broadcast_to(w[1].mean(axis=0), (l, d)),
                               **TOL)


@pytest.mark.parametrize("l,d,h,dtype,wide", [
    (16, 300, 15, torch.bfloat16, False), (50, 300, 15, torch.float32, False),
    (64, 300, 15, torch.bfloat16, False), (65, 300, 15, torch.bfloat16, True),
    (65, 300, 15, torch.float32, True), (50, 300, 6, torch.float32, True),
    (16, 99, 3, torch.bfloat16, True), (16, 96, 3, torch.bfloat16, False),
    (64, 960, 32, torch.bfloat16, True), (64, 960, 32, torch.float32, False),
    (96, 768, 16, torch.bfloat16, True), (50, 400, 4, torch.float32, True)])
def test_routing_to_the_wide_instances(l, d, h, dtype, wide):
    """The wide instances run every shape the hd <= 32, L <= 64 instances do
    not take: head dim above 32, L above 64, or a bf16 slab larger than one
    block (``csrc/mhsa.cu``, ``wide_instance``); NRMS's hd = 20 shapes stay
    on their own instances."""
    assert mhsa.wide_instance(l, d, h, dtype) == wide
    assert mhsa.kernel_supports(l, d, h, dtype)


@pytest.mark.parametrize("l,d,h", [(129, 1025, 1), (1, 1030, 1), (64, 2050, 2), (300, 4100, 4),
                                   (16, 1025, 1)])
@pytest.mark.parametrize("backward", [False, True])
def test_outside_the_box_raises_with_the_bound_named(l, d, h, backward):
    """Off the CPU (a meta tensor stands for the card) a shape outside the
    kernel's rule, a head dim above 1,024 (the long instances take any L),
    raises, naming the bound, forward and backward; on the CPU the same
    shape computes."""
    qkv = torch.zeros(2, l, 3 * d, device="meta")
    mask = torch.ones(2, l, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match=r"head dim <= 1024 \(any L\)"):
        if backward:
            mhsa._backward(qkv, mask, h, torch.zeros(2, l, d, device="meta"))
        else:
            mhsa.fused_small_mhsa(qkv, mask, h)
    cpu = torch.zeros(2, l, 3 * d)
    assert mhsa.fused_small_mhsa(cpu, torch.ones(2, l, dtype=torch.bool), h).shape == (2, l, d)
