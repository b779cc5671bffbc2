"""The port's attention kernel wrapper on the CPU: its plain version against
the JAX reference (``mhsa_reference``) and the Pallas kernel in interpret
mode, and the wrapper's input checks.  The CUDA kernel itself is tested on
the card (``test_torch_port_gpu.py``).

Tolerance: float32 atol/rtol 1e-5 — the three compute the same sums in a
different order (the Pallas kernel online, the others by softmax), which
moves float32 results by a few ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.ops.mhsa import fused_small_mhsa as pallas_mhsa
from newsreclib_tpu.ops.mhsa import mhsa_reference
from newsreclib_tpu_torch.ops import build, mhsa

TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(u, l, d, seed, full_first=True):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(u, l, 3 * d)).astype(np.float32)
    mask = rng.random((u, l)) < 0.85
    if full_first:
        mask[:, 0] = True
    return qkv, mask


def _plain(qkv, mask, h):
    return mhsa.mhsa_plain(torch.from_numpy(qkv), torch.from_numpy(mask), h).numpy()


@pytest.mark.parametrize("u,l,d,h", [(8, 6, 24, 4), (33, 30, 60, 6), (17, 16, 300, 15),
                                     (9, 30, 300, 15), (5, 50, 300, 15)])
def test_plain_matches_jax_reference(u, l, d, h):
    qkv, mask = _inputs(u, l, d, seed=u + l)
    want = np.asarray(mhsa_reference(jnp.asarray(qkv), jnp.asarray(mask), h))
    np.testing.assert_allclose(_plain(qkv, mask, h), want, **TOL)


@pytest.mark.parametrize("u,l,d,h", [(8, 6, 24, 4), (33, 30, 60, 6), (16, 16, 60, 3)])
def test_plain_matches_pallas_interpret(u, l, d, h):
    """Held against the TPU kernel itself, at valid query rows (the Pallas
    kernel leaves masked query rows unspecified)."""
    from jax.lax import Precision

    qkv, mask = _inputs(u, l, d, seed=7 * u + l)
    got = _plain(qkv, mask, h)
    want = np.asarray(pallas_mhsa(jnp.asarray(qkv), jnp.asarray(mask), num_heads=h,
                                  block_u=8, interpret=True, precision=Precision.HIGHEST))
    m = mask[..., None]
    np.testing.assert_allclose(got * m, want * m, **TOL)


@pytest.mark.parametrize("l", [16, 30, 50])
def test_fully_masked_rows_are_finite_and_uniform(l):
    """The padding article has no valid key: the -1e30 mask gives a uniform
    softmax (mean of v), not NaN."""
    qkv, mask = _inputs(6, l, 300, seed=l, full_first=False)
    mask[0] = False
    got = _plain(qkv, mask, 15)
    assert np.all(np.isfinite(got))
    want = np.asarray(mhsa_reference(jnp.asarray(qkv), jnp.asarray(mask), 15))
    np.testing.assert_allclose(got, want, **TOL)
    v_mean = qkv[0, :, 600:].mean(axis=0)
    np.testing.assert_allclose(got[0], np.broadcast_to(v_mean, (l, 300)), **TOL)


def test_wrapper_on_cpu_runs_plain_version_without_counting():
    qkv, mask = _inputs(4, 16, 300, seed=0)
    before = mhsa.launches
    got = mhsa.fused_small_mhsa(torch.from_numpy(qkv), torch.from_numpy(mask), 15)
    assert mhsa.launches == before
    np.testing.assert_array_equal(got.numpy(), _plain(qkv, mask, 15))


def test_plain_bf16_sums_in_float32():
    qkv, mask = _inputs(4, 30, 300, seed=1)
    x = torch.from_numpy(qkv).to(torch.bfloat16)
    m = torch.from_numpy(mask)
    got = mhsa.fused_small_mhsa(x, m, 15)
    assert got.dtype == torch.bfloat16
    want = mhsa.mhsa_plain(x.float(), m, 15).to(torch.bfloat16)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("u,l,d,h", [(8, 6, 24, 4), (6, 17, 60, 3), (5, 50, 300, 15)])
def test_plain_gradient_matches_jax_grad_of_reference(u, l, d, h):
    """What the kernel's backward will have to match: d(sum(w * out)) / d qkv
    of ``mhsa_plain`` against ``jax.grad`` of ``mhsa_reference``, with a
    fully masked sequence among the inputs."""
    import jax

    qkv, mask = _inputs(u, l, d, seed=3 * u + l)
    mask[1] = False
    w = np.random.default_rng(l).normal(size=(u, l, d)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda x: (mhsa_reference(x, jnp.asarray(mask), h) * jnp.asarray(w)).sum()
    )(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_(True)
    (mhsa.mhsa_plain(x, torch.from_numpy(mask), h) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, **TOL)


def test_wrapper_on_cpu_stays_differentiable():
    """On the CPU the wrapper is the plain version, gradient included (the
    CUDA route refuses a tensor that requires grad)."""
    qkv, mask = _inputs(4, 16, 60, seed=2)
    m = torch.from_numpy(mask)
    x = torch.from_numpy(qkv).requires_grad_(True)
    mhsa.fused_small_mhsa(x, m, 3).square().sum().backward()
    y = torch.from_numpy(qkv).requires_grad_(True)
    mhsa.mhsa_plain(y, m, 3).square().sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), y.grad.numpy())


@pytest.mark.parametrize("l,d,h,dtype,fits", [
    (64, 300, 15, torch.float32, True), (50, 300, 15, torch.float32, True),
    (64, 303, 101, torch.float32, False), (64, 600, 20, torch.float32, False),
    (64, 600, 20, torch.bfloat16, True), (64, 606, 101, torch.bfloat16, False)])
def test_wrapper_refuses_what_one_block_cannot_stage(l, d, h, dtype, fits):
    """The kernel stages one sequence's (L, 3D) slab in the input type: the
    wrapper refuses, on every device, a shape whose slab does not fit one
    block's shared memory."""
    assert (mhsa.smem_bytes(l, d, torch.tensor([], dtype=dtype).element_size())
            <= 232448) == fits
    qkv = torch.zeros(2, l, 3 * d, dtype=dtype)
    mask = torch.ones(2, l, dtype=torch.bool)
    if fits:
        assert mhsa.fused_small_mhsa(qkv, mask, h).shape == (2, l, d)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            mhsa.fused_small_mhsa(qkv, mask, h)


def _bad_inputs():
    ok = torch.zeros(2, 16, 900), torch.ones(2, 16, dtype=torch.bool), 15
    qkv, mask, h = ok
    return {
        "long_sequence": (torch.zeros(2, 65, 900), torch.ones(2, 65, dtype=torch.bool), 15),
        "wide_head": (torch.zeros(2, 16, 3 * 66), mask, 2),
        "heads_do_not_divide": (qkv, mask, 7),
        "float64": (qkv.double(), mask, h),
        "int_mask": (qkv, mask.int(), h),
        "mask_shape": (qkv, mask[:, :8], h),
        "non_contiguous": (torch.zeros(16, 2, 900).transpose(0, 1), mask, h),
        "two_dims": (qkv[0], mask[0], h),
        "meta_device": (qkv.to("meta"), mask.to("meta"), h),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_raises_on_unsupported_input(case):
    qkv, mask, h = _bad_inputs()[case]
    with pytest.raises((ValueError, TypeError)):
        mhsa.fused_small_mhsa(qkv, mask, h)


def test_kernel_library_is_keyed_by_source_and_built_under_build():
    path = build.library_path("mhsa")
    assert path.parent == build.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert path == build.library_path("mhsa")
    assert (build.CSRC / "mhsa.cu").exists()


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()
