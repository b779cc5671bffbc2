"""The numeric design of the float32 attention kernels (``csrc/mhsa.cu``),
on the CPU.

On the card the float32 kernels run their products on tensor cores in
split TF32 ("3xTF32"): each operand x goes in as hi = tf32(x) and
lo = tf32(x - hi), with tf32 the rounding of ``cvt.rna.tf32.f32`` (to
nearest, ties away from zero, 10 mantissa bits kept), and each product as
a_lo b_hi + a_hi b_lo + a_hi b_hi with float32 sums.  This emulates those
products in torch, with the kernels' softmax (log2 units, -1e30 at masked
keys), for the forward and for dqkv, and holds them against JAX's
``mhsa_reference`` and ``jax.grad`` of it from the same numpy inputs, at
atol = rtol = 1e-5, the kernels' own tolerance on the card.  A single TF32
rounding of each operand must fail the same check: it is why the split is
there.  The kernels' fragment layouts and launches are tested on the card
(``test_torch_port_gpu.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.ops.mhsa import mhsa_reference

TOL = dict(atol=1e-5, rtol=1e-5)
D, H = 300, 15
SHAPES = [(64, 16), (16, 30), (8, 50)]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: +0x1000 on the bit pattern, then the low 13
    bits cleared (0xFFFFE000)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_hi_lo = tf32(a - a_hi), tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_hi_lo + a_hi @ b_hi


def single_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The control: each operand rounded to tf32 once."""
    return tf32(a) @ tf32(b)


def _heads(t):
    u, l, _ = t.shape
    return t.reshape(u, l, H, D // H).transpose(1, 2)


def _unheads(t):
    u, _, l, hd = t.shape
    return t.transpose(1, 2).reshape(u, l, H * hd)


def _probabilities(q, k, mask, mm):
    """The kernels' softmax of the logits mm(q, k^T): log2 units with the
    scale log2(e) / sqrt(hd), -1e30 at masked keys, the exact max and sum."""
    scale_log2 = math.log2(math.e) / math.sqrt(D // H)
    bias = torch.where(mask, 0.0, -1e30)[:, None, None, :]
    x = mm(q, k.transpose(-1, -2)) * scale_log2 + bias
    p = torch.exp2(x - x.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def emulated_forward(qkv, mask, mm):
    q, k, v = (_heads(t) for t in qkv.split(D, dim=-1))
    return _unheads(mm(_probabilities(q, k, mask, mm), v))


def emulated_backward(qkv, mask, grad_out, mm):
    """dqkv as the backward kernel forms it: dP = dO V^T, dS = P (dP -
    rowsum(dP P)) and 0 at masked keys, dQ = s dS K, dK = s dS^T Q,
    dV = P^T dO."""
    scale = 1.0 / math.sqrt(D // H)
    q, k, v = (_heads(t) for t in qkv.split(D, dim=-1))
    do = _heads(grad_out)
    p = _probabilities(q, k, mask, mm)
    dp = mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(mask[:, None, None, :], ds, 0.0)
    grads = (mm(ds, k) * scale, mm(ds.transpose(-1, -2), q) * scale,
             mm(p.transpose(-1, -2), do))
    return torch.cat([_unheads(g) for g in grads], dim=-1)


def _inputs(u, l, seed):
    """qkv ~ N(0, 1), random prefix key masks, row 0 fully masked (the
    padding article); the output gradient ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(u, l, 3 * D)).astype(np.float32)
    mask = np.arange(l)[None, :] < rng.integers(1, l + 1, size=(u, 1))
    mask[0] = False
    grad_out = rng.normal(size=(u, l, D)).astype(np.float32)
    return qkv, mask, grad_out


def _reference(qkv, mask, grad_out):
    """JAX's output and d(sum(out * grad_out)) / d qkv."""
    m, w = jnp.asarray(mask), jnp.asarray(grad_out)
    out = np.asarray(mhsa_reference(jnp.asarray(qkv), m, H))
    grad = np.asarray(jax.grad(lambda x: (mhsa_reference(x, m, H) * w).sum())(jnp.asarray(qkv)))
    return out, grad


def _within(got, want) -> bool:
    return bool(np.all(np.abs(got - want) <= TOL["atol"] + TOL["rtol"] * np.abs(want)))


@pytest.mark.parametrize("u,l", SHAPES)
def test_split_tf32_matches_jax_and_one_rounding_does_not(u, l):
    qkv, mask, grad_out = _inputs(u, l, seed=u * 7 + l)
    want_out, want_grad = _reference(qkv, mask, grad_out)
    x, m, g = torch.from_numpy(qkv), torch.from_numpy(mask), torch.from_numpy(grad_out)

    out = emulated_forward(x, m, split_mm).numpy()
    grad = emulated_backward(x, m, g, split_mm).numpy()
    assert np.all(np.isfinite(out)) and np.all(np.isfinite(grad))
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(grad, want_grad, **TOL)

    # the padding article: uniform attention, dQ = dK = 0, dV = the mean of dO
    np.testing.assert_allclose(out[0], np.broadcast_to(qkv[0, :, 2 * D:].mean(axis=0), (l, D)),
                               **TOL)
    assert np.all(grad[0, :, :2 * D] == 0)
    np.testing.assert_allclose(grad[0, :, 2 * D:],
                               np.broadcast_to(grad_out[0].mean(axis=0), (l, D)), **TOL)

    once_out = emulated_forward(x, m, single_mm).numpy()
    once_grad = emulated_backward(x, m, g, single_mm).numpy()
    assert not _within(once_out, want_out)
    assert not _within(once_grad, want_grad)


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest with ties away from zero at 10 mantissa bits; zero
    and -1e30 stay finite, and the lo part of an exact tf32 value is 0."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one, one + ulp / 2, one + ulp / 4, -(one + ulp / 2), 0.0, -1e30, 3.0],
                     dtype=torch.float32)
    got = tf32(x)
    assert got.tolist()[:5] == [one, one + ulp, one, -(one + ulp), 0.0]
    assert torch.isfinite(got).all()
    assert got[6].item() == 3.0 and tf32(x - got)[6].item() == 0.0
    assert abs(got[5].item() + 1e30) <= 1e30 * ulp


# The long instances (L above 128; ``csrc/mhsa.cu``, "long"): keys stream in
# tiles of 64 with an online softmax, and the backward takes each row's
# max, sum and D = rowsum(P * dP) online over 16-key chunks, then sums dQ
# over 8-key products and dK, dV over 8-query products, each in split TF32.
# Above head dim 64 float32 runs in the XL instances: tiles and chunks of 8
# keys, and the logits and dP summed over the head dim's groups of 64
# columns, one split product a group.  (U, L, D, heads, tile, chunk, group
# columns or None.)
LONG_SHAPES = [(4, 200, 300, 15, 64, 16, None), (2, 256, 768, 16, 64, 16, None),
               (3, 150, 300, 2, 8, 8, 64)]
LONG_TILE = 64


def _heads_of(t, h):
    u, l, d = t.shape
    return t.reshape(u, l, h, d // h).transpose(1, 2)


def _unheads_of(t):
    u, h, l, hd = t.shape
    return t.transpose(1, 2).reshape(u, l, h * hd)


def _dots(a, b, mm, cols):
    """a b^T over the last dimension: one product, or (``cols``) one a group
    of that many columns, summed in order."""
    if cols is None:
        return mm(a, b.transpose(-1, -2))
    return sum(mm(a[..., c:c + cols], b[..., c:c + cols].transpose(-1, -2))
               for c in range(0, a.shape[-1], cols))


def long_forward(qkv, mask, h, mm, tile=LONG_TILE, cols=None):
    """The long forward's float32 arithmetic: per key tile the logits in
    log2 units (-1e30 at masked keys), the running max from -1e30, the
    running sum and output rescaled by 2^(old max - new max)."""
    u, l, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (_heads_of(t, h) for t in qkv.split(d, dim=-1))
    scale_log2 = math.log2(math.e) / math.sqrt(d // h)
    bias = torch.where(mask, 0.0, -1e30)[:, None, None, :]
    m = torch.full((u, h, l, 1), -1e30)
    s = torch.zeros((u, h, l, 1))
    o = torch.zeros((u, h, l, d // h))
    for k0 in range(0, l, tile):
        t = slice(k0, k0 + tile)
        x = _dots(q, k[:, :, t], mm, cols) * scale_log2 + bias[..., t]
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        s = s * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + mm(p, v[:, :, t])
        m = m_new
    return _unheads_of(o / s)


def long_backward(qkv, mask, grad_out, h, mm, chunk=16, cols=None):
    """The long backward's float32 arithmetic: the statistics pass (max,
    sum and D summed online over 16-key chunks from S and dP), then P from
    them, dS = P (dP - D) and 0 at masked keys, dQ over 8-key products, dK
    and dV over 8-query products, each product summed alone and added."""
    u, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // h
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = math.log2(math.e) * scale
    q, k, v = (_heads_of(t, h) for t in qkv.split(d, dim=-1))
    do = _heads_of(grad_out, h)
    bias = torch.where(mask, 0.0, -1e30)[:, None, None, :]
    x = _dots(q, k, mm, cols) * scale_log2 + bias
    dp = _dots(do, v, mm, cols)
    m = torch.full((u, h, l, 1), -1e30)
    s = torch.zeros((u, h, l, 1))
    dd = torch.zeros((u, h, l, 1))
    for k0 in range(0, l, chunk):
        c = slice(k0, k0 + chunk)
        m_new = torch.maximum(m, x[..., c].amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x[..., c] - m_new)
        s = s * alpha + p.sum(dim=-1, keepdim=True)
        dd = dd * alpha + (p * dp[..., c]).sum(dim=-1, keepdim=True)
        m = m_new
    p = torch.exp2(x - m) * (1 / s)
    ds = torch.where(mask[:, None, None, :], p * (dp - dd / s), 0.0)
    dq = sum(mm(ds[..., c:c + 8], k[:, :, c:c + 8]) for c in range(0, l, 8)) * scale
    dk = sum(mm(ds[:, :, c:c + 8].transpose(-1, -2), q[:, :, c:c + 8])
             for c in range(0, l, 8)) * scale
    dv = sum(mm(p[:, :, c:c + 8].transpose(-1, -2), do[:, :, c:c + 8]) for c in range(0, l, 8))
    return torch.cat([_unheads_of(g) for g in (dq, dk, dv)], dim=-1)


def _float64_reference(qkv, mask, grad_out, h):
    """The attention and d(sum(out * grad_out)) / d qkv in float64."""
    x = torch.from_numpy(qkv).double().requires_grad_(True)
    d = qkv.shape[-1] // 3
    q, k, v = (_heads_of(t, h) for t in x.split(d, dim=-1))
    logits = q @ k.transpose(-1, -2) / math.sqrt(d // h)
    logits = torch.where(torch.from_numpy(mask)[:, None, None, :], logits, -1e30)
    out = _unheads_of(torch.softmax(logits, dim=-1) @ v)
    (grad,) = torch.autograd.grad(out, x, torch.from_numpy(grad_out).double())
    return out.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("u,l,d,h,tile,chunk,cols", LONG_SHAPES,
                         ids=["-".join(map(str, s[:4])) for s in LONG_SHAPES])
def test_long_split_tf32_matches_float64_and_one_rounding_does_not(u, l, d, h, tile, chunk,
                                                                    cols):
    """The long instances' streamed float32 arithmetic in split TF32 holds
    the attention and its gradient within 1e-5 + 1e-5 |x| of float64 at L =
    150 to 256 (head dims 20, 48 and 150, the last in the XL instances), a
    fully masked sequence included (dQ = dK = 0); one TF32 rounding of each
    operand does not."""
    rng = np.random.default_rng(u * l + d)
    qkv = rng.normal(size=(u, l, 3 * d)).astype(np.float32)
    mask = rng.random((u, l)) < 0.6
    mask[:, LONG_TILE:2 * LONG_TILE] = False  # a whole tile masked between valid keys
    mask[0] = False
    mask[1, 0] = True
    grad_out = rng.normal(size=(u, l, d)).astype(np.float32)
    want_out, want_grad = _float64_reference(qkv, mask, grad_out, h)
    x, m, g = torch.from_numpy(qkv), torch.from_numpy(mask), torch.from_numpy(grad_out)

    out = long_forward(x, m, h, split_mm, tile, cols).numpy()
    grad = long_backward(x, m, g, h, split_mm, chunk, cols).numpy()
    assert np.all(np.isfinite(out)) and np.all(np.isfinite(grad))
    np.testing.assert_allclose(out, want_out, **TOL)
    np.testing.assert_allclose(grad, want_grad, **TOL)
    assert np.all(grad[0, :, :2 * d] == 0)

    assert not _within(long_forward(x, m, h, single_mm, tile, cols).numpy(), want_out)
    assert not _within(long_backward(x, m, g, h, single_mm, chunk, cols).numpy(), want_grad)
