"""The port's attention kernel wrapper on the CPU: its plain version against
the JAX reference (``mhsa_reference``) and the Pallas kernel in interpret
mode, the backward of ``FusedSmallMHSA`` against ``jax.grad``, the shape
rule ``kernel_supports``, the model's attention at shapes the kernel does
not take, and the wrapper's input checks.  The CUDA kernel itself is tested
on the card (``test_torch_port_gpu.py``).

Tolerance: float32 atol/rtol 1e-5 — the three compute the same sums in a
different order (the Pallas kernel online, the others by softmax), which
moves float32 results by a few ulp.
"""

import re

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
    """On the CPU the wrapper's forward is the plain version, bit for bit,
    and its gradient is ``FusedSmallMHSA``'s backward, which agrees with
    autograd of the plain version."""
    qkv, mask = _inputs(4, 16, 60, seed=2)
    m = torch.from_numpy(mask)
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = mhsa.fused_small_mhsa(x, m, 3)
    out.square().sum().backward()
    y = torch.from_numpy(qkv).requires_grad_(True)
    ref = mhsa.mhsa_plain(y, m, 3)
    ref.square().sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    want = mhsa.mhsa_backward(x.detach(), m, 3, 2 * ref.detach())
    np.testing.assert_array_equal(x.grad.numpy(), want.numpy())
    np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), **TOL)


@pytest.mark.parametrize("l,d,h,dtype,fits", [
    (64, 300, 15, torch.float32, True), (50, 300, 15, torch.float32, True),
    (64, 303, 101, torch.float32, True), (64, 600, 20, torch.float32, True),
    (64, 600, 20, torch.bfloat16, True), (64, 606, 101, torch.bfloat16, True),
    (128, 64, 1, torch.float32, True), (64, 128, 1, torch.float32, True),
    (128, 128, 1, torch.float32, True), (200, 1024, 1, torch.bfloat16, True)])
def test_wrapper_refuses_what_one_block_cannot_stage(l, d, h, dtype, fits):
    """Each kernel instance stages its own share: a bf16 one at head dim up
    to 32 one sequence's (L, 3D) slab, the wide ones one head's columns, the
    long ones tiles of rows.  ``kernel_supports`` takes a shape only if its
    staging fits one block's shared memory, and on the CPU the wrapper
    computes every shape.  float32 stages little, so (64, 600) and (64,
    303), refused by the whole-slab rule of earlier versions, fit; a bf16
    slab too large for one block, (64, 606) with 101 heads, runs in the wide
    instances, which stage one head.  Inside the box every shape fits, up to
    the f32 backward's (128, 64) and (64, 128); its corner (128, 128),
    outside, runs in the long instances, whose tiles shrink with the head
    dim so that one block fits up to head dim 1,024 at any L."""
    assert (mhsa.smem_bytes(l, d, h, dtype) <= 232448) == fits
    assert mhsa.kernel_supports(l, d, h, dtype) == fits
    qkv = torch.zeros(2, l, 3 * d, dtype=dtype)
    mask = torch.ones(2, l, dtype=torch.bool)
    assert mhsa.fused_small_mhsa(qkv, mask, h).shape == (2, l, d)


def _bad_inputs():
    ok = torch.zeros(2, 16, 900), torch.ones(2, 16, dtype=torch.bool), 15
    qkv, mask, h = ok
    return {
        # shapes the kernel does not take, off the CPU (meta stands for the card)
        "long_sequence": (torch.zeros(2, 129, 900, device="meta"),
                          torch.ones(2, 129, dtype=torch.bool, device="meta"), 15),
        "wide_head": (torch.zeros(2, 16, 3 * 258, device="meta"), mask.to("meta"), 2),
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


@pytest.mark.parametrize("u,l,d,h", [(8, 6, 24, 4), (6, 17, 60, 3), (5, 50, 300, 15),
                                     (4, 16, 300, 15), (3, 70, 60, 4)])
def test_fused_backward_matches_jax_grad_of_reference(u, l, d, h):
    """``FusedSmallMHSA``'s backward (its explicit formula, run through the
    CPU path) against ``jax.grad`` of ``mhsa_reference``, with a fully
    masked sequence (the padding article) and partly masked ones."""
    import jax

    qkv, mask = _inputs(u, l, d, seed=5 * u + l)
    mask[1] = False
    w = np.random.default_rng(u * l).normal(size=(u, l, d)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda x: (mhsa_reference(x, jnp.asarray(mask), h) * jnp.asarray(w)).sum()
    )(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = mhsa.FusedSmallMHSA.apply(x, torch.from_numpy(mask), h)
    np.testing.assert_allclose(out.detach().numpy(), _plain(qkv, mask, h), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    assert np.all(np.isfinite(x.grad.numpy()))
    np.testing.assert_allclose(x.grad.numpy(), want, **TOL)
    # the fully masked sequence: no gradient reaches q or k, v gets the mean
    np.testing.assert_array_equal(x.grad.numpy()[1, :, : 2 * d], 0.0)


def test_fused_backward_returns_the_input_type():
    qkv, mask = _inputs(3, 16, 60, seed=9)
    x = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_(True)
    m = torch.from_numpy(mask)
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 16, 60)).astype(np.float32))
    mhsa.FusedSmallMHSA.apply(x, m, 3).backward(g.to(torch.bfloat16))
    assert x.grad.dtype == torch.bfloat16
    want = mhsa.mhsa_backward(x.detach(), m, 3, g.to(torch.bfloat16))
    torch.testing.assert_close(x.grad, want, atol=0, rtol=0)


@pytest.mark.parametrize("l,d,h,dtype,supported", [
    (64, 300, 15, torch.float32, True), (65, 300, 15, torch.float32, True),
    (16, 192, 3, torch.float32, True), (16, 195, 3, torch.float32, True),  # head dim 64 / 65
    (50, 300, 6, torch.float32, True), (16, 300, 7, torch.float32, False),
    (30, 300, 15, torch.float16, False), (30, 300, 15, torch.bfloat16, True),
    (50, 400, 20, torch.float32, True), (50, 400, 20, torch.bfloat16, True),
    (1, 3, 1, torch.float32, True), (50, 300, 0, torch.float32, False),
    (50, 300, 6, torch.bfloat16, True), (30, 400, 20, torch.float32, True),
    (64, 960, 32, torch.bfloat16, True), (64, 960, 32, torch.float32, True),
    (64, 4096, 64, torch.bfloat16, True), (50, 400, 4, torch.float32, True),
    # the old box (L up to 128 at head dim up to 64, head dim up to 128 at
    # L <= 64) and beyond it, in the long instances
    (128, 64, 1, torch.float32, True), (128, 64, 1, torch.bfloat16, True),
    (129, 64, 1, torch.float32, True), (129, 64, 1, torch.bfloat16, True),
    (129, 300, 15, torch.float32, True),
    (64, 128, 1, torch.float32, True), (64, 128, 1, torch.bfloat16, True),
    (64, 129, 1, torch.float32, True), (64, 129, 1, torch.bfloat16, True),
    (65, 65, 1, torch.float32, True), (65, 65, 1, torch.bfloat16, True),
    (128, 128, 1, torch.bfloat16, True), (96, 768, 16, torch.float32, True),
    (96, 768, 16, torch.bfloat16, True), (100, 300, 15, torch.bfloat16, True),
    (200, 300, 15, torch.float32, True), (256, 768, 16, torch.bfloat16, True),
    (512, 1024, 1, torch.float32, True), (3000, 2048, 2, torch.bfloat16, True),
    (16, 1025, 1, torch.float32, False), (300, 2050, 2, torch.bfloat16, False)])
def test_kernel_supports_at_the_edges(l, d, h, dtype, supported):
    """float32 or bfloat16, heads dividing D, any L, head dim up to 1,024,
    and what the instance stages within shared memory (always): MINS's 6
    heads of 50, CenNewsRec's and CAUM's D = 400 with 20 heads, the PLM
    head's 16 heads of 48 at L = 96 and 256, CAUM's default head dim 100, a
    bf16 slab of (64, 960), which the wide instances stage one head at a
    time, NRMS's user encoder at history 200, L = 129 and head dim 129,
    head dims above 64 at L above 64 and head dim 1,024 at any L (the long
    instances), in both types; head dims above 1,024, float16 and heads
    that do not divide D refused."""
    assert mhsa.kernel_supports(l, d, h, dtype) == supported


ZOO_SHAPES = {  # (L, D, heads, kernel_supports): the zoo's attentions on the edge
    "mins_user": (50, 300, 6, True),
    "caum_user": (50, 400, 4, True),  # CAUMUserEncoder's unused default: head dim 100
    "plm_text": (32, 768, 16, True),
    "plm_text_96": (96, 768, 16, True),  # PLM-mode titles, tokenizer_max_len 96
    "long_history": (100, 300, 15, True),
    "beyond_the_box": (130, 300, 15, True),  # the long instances
}


@pytest.mark.parametrize("name", sorted(ZOO_SHAPES))
def test_mhsa_module_matches_jax_where_the_kernel_does_not_go(name):
    """The port's ``MultiHeadSelfAttention`` on the CPU against the JAX
    module at the zoo's shapes on the edge of ``kernel_supports``: MINS's
    user encoder, the PLM tower's MHSA at L = 32 and 96, head dim 100 and
    L = 100, which the kernel's wide instances take on the card, and
    L = 130, beyond the box, which its long instances take.  On the CPU any
    shape computes."""
    import jax

    from newsreclib_tpu.models.components.attention import (
        MultiHeadSelfAttention as JMultiHeadSelfAttention,
    )
    from newsreclib_tpu_torch.convert import flax_to_state_dict
    from newsreclib_tpu_torch.models.components.attention import MultiHeadSelfAttention

    l, d, h, supported = ZOO_SHAPES[name]
    assert mhsa.kernel_supports(l, d, h, torch.float32) == supported
    rng = np.random.default_rng(l + d)
    x = rng.normal(size=(3, l, d)).astype(np.float32)
    mask = rng.random((3, l)) < 0.8
    mask[0] = False
    mask[1, 0] = True
    jm = JMultiHeadSelfAttention(num_heads=h)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    tm = MultiHeadSelfAttention(d, h)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_kernel_library_is_keyed_by_source_and_built_under_build():
    path = build.library_path("mhsa")
    assert path.parent == build.BUILD_DIR
    assert path.parent.parent.name == "build"
    assert path == build.library_path("mhsa")
    assert (build.CSRC / "mhsa.cu").exists()


# The parts compile at once, so the stand-in nvcc of each appends its line to
# the log in whatever order they finish: "shuffled" makes them finish 4, 6, 5, 3, 1, 2.
PART_DELAYS = {"as_started": {}, "shuffled": {4: 0.0, 6: 0.2, 5: 0.4, 3: 0.6, 1: 0.8, 2: 1.0}}


@pytest.mark.parametrize("order", sorted(PART_DELAYS))
def test_build_compiles_the_parts_at_once_and_links_them(tmp_path, monkeypatch, order):
    """``csrc/mhsa.cu`` builds as ``PARTS["mhsa"]`` nvcc compilations with
    ``NRL_PART`` 1 to 6 for sm_90a, then one link of their objects, in part
    order, into the library; the objects are removed.  A stand-in nvcc
    records each command and writes its output; each part's line is found
    by its ``-DNRL_PART=k``, whatever order the parts logged in."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "cuda" / "bin" / "nvcc"
    fake.parent.mkdir(parents=True)
    delays = "".join(f"    -DNRL_PART={k}) sleep {s} ;;\n"
                     for k, s in PART_DELAYS[order].items())
    fake.write_text("#!/bin/sh\n"
                    'for a in "$@"; do\n  case "$a" in\n' + delays + "  esac\ndone\n"
                    f'echo "$@" >> {log}\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    build.build_all(["mhsa"])
    calls = log.read_text().splitlines()
    parts = build.PARTS["mhsa"]
    assert len(calls) == parts + 1
    compiles, link = calls[:-1], calls[-1].split()
    logged = [int(m) for c in compiles for m in re.findall(r"-DNRL_PART=(\d+)", c)]
    assert sorted(logged) == list(range(1, parts + 1))  # each part exactly once
    if order == "shuffled":
        assert logged == list(PART_DELAYS[order])
    objects = {}
    for k, call in zip(logged, compiles):
        assert f"-c -DNRL_PART={k}" in call and call.endswith("mhsa.cu")
        assert "arch=compute_90a,code=sm_90a" in call
        args = call.split()
        objects[k] = args[args.index("-o") + 1]
    # nvcc takes a file for an object to link only by its ".o" suffix
    assert all(o.endswith(".o") for o in objects.values())
    assert len(set(objects.values())) == parts
    assert link[0] == "-shared" and link[-parts:] == [objects[k] for k in range(1, parts + 1)]
    target = build.library_path("mhsa")
    assert target.parent == tmp_path / "kernels" and target.read_text() == "built\n"
    assert sorted(p.name for p in target.parent.iterdir()) == [target.name]


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        build._nvcc()


@pytest.mark.parametrize("layout", ["expanded", "transposed", "sliced"])
def test_fused_backward_takes_any_grad_out_layout(layout):
    """Autograd can hand the backward an expanded (stride 0, from
    ``out.sum().backward()``) or strided output gradient: the gradient
    equals ``jax.vjp`` of ``mhsa_reference`` with the same cotangent, and
    the CPU route counts no backward launch."""
    import jax

    u, l, d, h = 5, 17, 60, 3
    qkv, mask = _inputs(u, l, d, seed=41)
    mask[2] = False
    rng = np.random.default_rng(42)
    if layout == "expanded":
        ct = np.ones((u, l, d), dtype=np.float32)
        grad_out = torch.ones(()).expand(u, l, d)
    elif layout == "transposed":
        ct = rng.normal(size=(u, l, d)).astype(np.float32)
        grad_out = torch.from_numpy(np.ascontiguousarray(ct.transpose(1, 0, 2))).transpose(0, 1)
    else:
        ct = rng.normal(size=(u, l, d)).astype(np.float32)
        wide = np.zeros((u, l, 2 * d), dtype=np.float32)
        wide[..., ::2] = ct
        grad_out = torch.from_numpy(wide)[..., ::2]
    assert not grad_out.is_contiguous()
    _, vjp = jax.vjp(lambda x: mhsa_reference(x, jnp.asarray(mask), h), jnp.asarray(qkv))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    x = torch.from_numpy(qkv).requires_grad_(True)
    out = mhsa.FusedSmallMHSA.apply(x, torch.from_numpy(mask), h)
    before = mhsa.bwd_launches
    if layout == "expanded":
        out.sum().backward()
    else:
        out.backward(grad_out)
    assert mhsa.bwd_launches == before
    np.testing.assert_allclose(x.grad.numpy(), want, **TOL)


def _bad_grad_outs():
    qkv, mask = (torch.from_numpy(a) for a in _inputs(2, 16, 60, seed=0))
    return qkv, mask, {
        "shape": torch.zeros(2, 16, 61),
        "rank": torch.zeros(2, 16 * 60),
        "dtype": torch.zeros(2, 16, 60, dtype=torch.float64),
        "bf16_for_f32": torch.zeros(2, 16, 60, dtype=torch.bfloat16),
        "device": torch.zeros(2, 16, 60, device="meta"),
    }


@pytest.mark.parametrize("case", sorted(_bad_grad_outs()[2]))
def test_backward_raises_on_a_wrong_grad_out(case):
    qkv, mask, bad = _bad_grad_outs()
    before = mhsa.bwd_launches
    with pytest.raises((ValueError, TypeError)):
        mhsa._backward(qkv, mask, 3, bad[case])
    assert mhsa.bwd_launches == before


def test_backward_raises_off_the_cpu_where_the_kernel_does_not_go():
    """On a device other than the CPU (a meta tensor stands for the card)
    the backward takes the kernel's shape rule, as the forward does: head
    dim 1,025 is refused; L = 129, which the long instances take, only
    finds no kernel for the meta device."""
    qkv = torch.zeros(2, 16, 3 * 1025, device="meta")
    mask = torch.ones(2, 16, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="kernel does not take"):
        mhsa._backward(qkv, mask, 1, torch.zeros(2, 16, 1025, device="meta"))
    qkv = torch.zeros(2, 129, 900, device="meta")
    mask = torch.ones(2, 129, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        mhsa._backward(qkv, mask, 15, torch.zeros(2, 129, 300, device="meta"))
