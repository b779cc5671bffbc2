"""Fused masked multi-head self-attention for many short sequences.

``fused_small_mhsa`` is the port of the TPU kernel
``newsreclib_tpu/ops/mhsa.py::fused_small_mhsa``: on a CUDA tensor it
launches the hand-written kernel ``csrc/mhsa.cu``; on a CPU tensor it runs
``mhsa_plain``, the same function in plain PyTorch, at any shape.  There is
no fallback from one to the other: a CUDA tensor whose shape the kernel does
not take (``kernel_supports``: float16, heads not dividing D, head dims above
1,024) raises.  The kernel takes every L.

Contract (as the TPU kernel's): ``qkv (U, L, 3D)`` is the fused in-projection
output, ``mask (U, L)`` bool marks the valid keys, the result is the context
``(U, L, D)`` in the input type, with sums in float32.  Masked keys take the
finite logit -1e30, so fully masked rows come out finite (uniform softmax);
rows at masked query positions hold values the caller zeroes.

``FusedSmallMHSA`` makes the kernel differentiable: its forward is
``fused_small_mhsa`` and its backward ``_backward``, which on a CUDA tensor
launches the hand-written backward kernel (``nrl_mhsa_bwd`` in
``csrc/mhsa.cu``: P recomputed from the saved qkv, dqkv in one launch, or,
in the long instances, three launches sharing a workspace) and
on a CPU tensor runs ``mhsa_backward``, the same gradient in plain PyTorch.
The JAX package trains through XLA autodiff of the plain attention
(``jax.grad`` of ``mhsa_reference``), which both match.
"""

from __future__ import annotations

import ctypes
import math

import torch

_MASK_MIN = -1e30
# The box of shapes the narrow and wide instances take (csrc/mhsa.cu,
# kernel_box): head dim up to BOX_MAX_HEAD_DIM at L <= NARROW_MAX_LEN, up to
# BOX_LONG_HEAD_DIM at L <= BOX_MAX_LEN.  Every other shape, any L and head
# dims up to MAX_HEAD_DIM, runs in the long instances (``long_instance``).
BOX_MAX_LEN = 128
BOX_MAX_HEAD_DIM = 128
NARROW_MAX_LEN = 64
BOX_LONG_HEAD_DIM = 64
NARROW_HEAD_DIM = 32  # head dims above it run the kernel's wide instances
MAX_HEAD_DIM = 1024  # the long instances' bound (bert-large's width as one head)
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the forward and of the backward kernel since the last reset,
# and of those, the launches of the wide instances (``wide_instance``) and
# of the long ones (``long_instance``); the CPU path counts none.  One
# backward counts once, whatever it launches inside (the long instances'
# backward is three kernels).
launches = 0
bwd_launches = 0
wide_launches = 0
wide_bwd_launches = 0
long_launches = 0
long_bwd_launches = 0


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(U, L, D) -> (U, H, L, hd)."""
    u, l, d = t.shape
    return t.reshape(u, l, num_heads, d // num_heads).transpose(1, 2)


def _probabilities(q, k, mask, num_heads):
    """Softmax of the masked, scaled q.k logits: (U, H, L, L) float32."""
    hd = q.shape[-1] // num_heads
    logits = _heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2) / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :], logits, _MASK_MIN)
    return torch.softmax(logits, dim=-1)


def mhsa_plain(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: ``newsreclib_tpu/ops/mhsa.py::mhsa_reference``,
    computed in float32 and returned in the input type."""
    u, l, d3 = qkv.shape
    q, k, v = qkv.float().split(d3 // 3, dim=-1)
    o = _probabilities(q, k, mask, num_heads) @ _heads(v, num_heads)
    return o.transpose(1, 2).reshape(u, l, d3 // 3).to(qkv.dtype)


def mhsa_backward(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
                  grad_out: torch.Tensor) -> torch.Tensor:
    """d(loss)/d(qkv) of the attention, given d(loss)/d(context), recomputed
    in float32 and returned in the type of qkv.  With P the probabilities and
    dO the output gradient per head: dP = dO V^T,
    dS = P * (dP - rowsum(dP * P)) at valid keys and 0 at masked ones (the
    -1e30 replaces the logit there, so no gradient reaches it),
    dQ = dS K / sqrt(hd), dK = dS^T Q / sqrt(hd), dV = P^T dO."""
    u, l, d3 = qkv.shape
    d = d3 // 3
    scale = 1.0 / math.sqrt(d // num_heads)
    q, k, v = qkv.float().split(d, dim=-1)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    p = _probabilities(q, k, mask, num_heads)
    do = _heads(grad_out.float(), num_heads)
    dp = do @ vh.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = torch.where(mask[:, None, None, :], ds, 0.0)
    grads = (ds @ kh * scale, ds.transpose(-1, -2) @ qh * scale, p.transpose(-1, -2) @ do)
    return torch.cat([g.transpose(1, 2).reshape(u, l, d) for g in grads], dim=-1).to(qkv.dtype)


def _align16(x: int) -> int:
    return (x + 15) // 16 * 16


def _narrow_bf16_bytes(l: int, d: int) -> int:
    """Shared memory of a bf16 block of one sequence at head dim up to 32:
    its whole (L, 3D) slab, 16 bytes of alignment slack, 64 key biases."""
    return _align16(16 + l * 3 * d * 2) + NARROW_MAX_LEN * 4


def in_box(l: int, hd: int) -> bool:
    """The shapes the narrow and wide instances take: head dim up to 128 at
    L <= 64, up to 64 at L <= 128."""
    return l >= 1 and hd >= 1 and ((l <= NARROW_MAX_LEN and hd <= BOX_MAX_HEAD_DIM)
                                   or (l <= BOX_MAX_LEN and hd <= BOX_LONG_HEAD_DIM))


def long_instance(l: int, d: int, num_heads: int) -> bool:
    """Whether (L, D, heads) runs in the kernel's long instances
    (``csrc/mhsa.cu``, ``long_instance``): every shape outside ``in_box``,
    in either type (the keys streamed through shared memory in tiles)."""
    return not in_box(l, d // num_heads)


def wide_instance(l: int, d: int, num_heads: int, dtype: torch.dtype) -> bool:
    """Whether (L, D, heads) in ``dtype`` runs in the kernel's wide
    instances (``csrc/mhsa.cu``, ``wide_instance``): inside the box, head
    dim above 32, L above 64, or a bfloat16 shape whose single sequence's
    slab does not fit one block."""
    return in_box(l, d // num_heads) and (
        d // num_heads > NARROW_HEAD_DIM or l > NARROW_MAX_LEN
        or (dtype == torch.bfloat16 and _narrow_bf16_bytes(l, d) > _SMEM_LIMIT))


def long_tile(hd: int) -> int:
    """Rows of a long instance's tiles at head dim ``hd`` (``long_tile``)."""
    return 64 if hd <= 64 else 32 if hd <= 256 else 16 if hd <= 512 else 8


def smem_bytes(l: int, d: int, num_heads: int, dtype: torch.dtype) -> int:
    """Shared memory of the kernel instance that runs (L, D, heads) in
    ``dtype``, the larger of its forward's and backward's: what that
    instance stages (``csrc/mhsa.cu``, ``instance_smem``).

    * long (``long_instance``): the dK / dV kernel's six T x hd tiles in
      float32 with rows of hd | 1 floats, two T x (T + 1) tiles and four
      vectors of T floats, T = ``long_tile(hd)``;
    * wide (``wide_instance``): one head's q, k, v and dO columns in the
      input type, Lp = 16 ceil(L / 16) rows each, padded to
      16 ceil(hd / 16) + 8 values (bfloat16) or 8 ceil(hd / 8) + 4
      (float32), and 4 Lp float32 key biases and row statistics;
    * float32, head dim up to 32: one head's q, k, v and dO columns, each
      rounded up to 16 bytes, plus 64 key biases;
    * bfloat16, head dim up to 32: the whole (L, 3D) slab of one sequence
      plus 16 bytes of alignment slack, plus 64 key biases."""
    hd = d // num_heads
    if long_instance(l, d, num_heads):
        t = long_tile(hd)
        return 4 * (6 * t * (hd | 1) + 2 * t * (t + 1) + 4 * t)
    if wide_instance(l, d, num_heads, dtype):
        lp = (l + 15) // 16 * 16
        if dtype == torch.bfloat16:
            row = ((hd + 15) // 16 * 16 + 8) * 2
        else:
            row = ((hd + 7) // 8 * 8 + 4) * 4
        return 4 * lp * row + 4 * lp * 4
    if dtype == torch.float32:
        return _align16(l * 3 * hd * 4) + _align16(l * hd * 4) + NARROW_MAX_LEN * 4
    return _narrow_bf16_bytes(l, d)


def kernel_supports(l: int, d: int, num_heads: int, dtype: torch.dtype) -> bool:
    """Whether ``csrc/mhsa.cu`` takes sequences of length ``l``, width ``d``
    and ``num_heads`` heads in ``dtype``: float32 or bfloat16, heads
    dividing D, any L >= 1, head dim up to ``MAX_HEAD_DIM`` (1,024), and
    what the instance stages within one block's shared memory
    (``smem_bytes``; it always fits).  Inside ``in_box`` the narrow and wide
    instances run: NRMS (D = 300, 15 heads of 20), MINS (6 heads of 50),
    CenNewsRec and CAUM (D = 400, 20 heads of 20) at L <= 50, the PLM
    tower's MHSA (16 heads of 48) up to L = 96 and CAUM's default of 4
    heads over 400 (head dim 100) at L = 50; every other shape (NRMS's user
    encoder at history 200, the PLM head at 256 tokens, head dims above
    128) in the long instances."""
    if dtype not in _DTYPES or num_heads <= 0 or d <= 0 or d % num_heads or l < 1:
        return False
    return (d // num_heads <= MAX_HEAD_DIM
            and smem_bytes(l, d, num_heads, dtype) <= _SMEM_LIMIT)


def _check(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> None:
    """The input contract, on every device."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (U, L, 3D), got {tuple(qkv.shape)}")
    u, l, d3 = qkv.shape
    d = d3 // 3
    if mask.shape != (u, l) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be bool (U, L) = {(u, l)}, got {mask.dtype} {tuple(mask.shape)}")
    if mask.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device} but mask on {mask.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv dtype {qkv.dtype} not supported (float32, bfloat16)")
    if not (qkv.is_contiguous() and mask.is_contiguous()):
        raise ValueError("qkv and mask must be contiguous")
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")


def _require_kernel(qkv: torch.Tensor, num_heads: int) -> None:
    """Raise unless the CUDA kernels take ``qkv`` (checked input, not on the CPU)."""
    u, l, d3 = qkv.shape
    if not kernel_supports(l, d3 // 3, num_heads, qkv.dtype):
        raise ValueError(
            f"the attention kernel does not take L={l}, D={d3 // 3}, {num_heads} heads, "
            f"{qkv.dtype}: it needs head dim <= {MAX_HEAD_DIM} (any L), and what its instance "
            "stages within a block's shared memory (kernel_supports)")
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")


def _forward(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The checked forward: ``mhsa_plain`` on the CPU, the kernel elsewhere."""
    global launches, wide_launches, long_launches
    _check(qkv, mask, num_heads)
    if qkv.device.type == "cpu":
        return mhsa_plain(qkv, mask, num_heads)
    _require_kernel(qkv, num_heads)
    u, l, d3 = qkv.shape
    out = torch.empty((u, l, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if u == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("nrl_mhsa_fwd")(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), u, l,
                                     d3 // 3, num_heads, _DTYPES[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"nrl_mhsa_fwd launch failed: cudaError {rc}")
    launches += 1
    wide_launches += wide_instance(l, d3 // 3, num_heads, qkv.dtype)
    long_launches += long_instance(l, d3 // 3, num_heads)
    return out


def _backward(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
              grad_out: torch.Tensor) -> torch.Tensor:
    """The checked backward, d(loss)/d(qkv) given d(loss)/d(context):
    ``mhsa_backward`` on the CPU, the backward kernel elsewhere.  ``grad_out``
    may be any layout (autograd hands over expanded or strided ones); it is
    made contiguous here.  The long instances' per-row statistics go to a
    workspace of ``nrl_mhsa_bwd_workspace`` bytes from torch's allocator."""
    global bwd_launches, wide_bwd_launches, long_bwd_launches
    _check(qkv, mask, num_heads)
    u, l, d3 = qkv.shape
    if grad_out.shape != (u, l, d3 // 3):
        raise ValueError(f"grad_out must be (U, L, D) = {(u, l, d3 // 3)}, "
                         f"got {tuple(grad_out.shape)}")
    if grad_out.dtype != qkv.dtype:
        raise TypeError(f"grad_out is {grad_out.dtype} but qkv is {qkv.dtype}")
    if grad_out.device != qkv.device:
        raise ValueError(f"qkv on {qkv.device} but grad_out on {grad_out.device}")
    grad_out = grad_out.contiguous()
    if qkv.device.type == "cpu":
        return mhsa_backward(qkv, mask, num_heads, grad_out)
    _require_kernel(qkv, num_heads)
    dqkv = torch.empty_like(qkv)
    if u == 0:
        return dqkv
    args = (u, l, d3 // 3, num_heads, _DTYPES[qkv.dtype])
    workspace = torch.empty(_kernel("nrl_mhsa_bwd_workspace")(*args), dtype=torch.uint8,
                            device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _kernel("nrl_mhsa_bwd")(qkv.data_ptr(), mask.data_ptr(), grad_out.data_ptr(),
                                     dqkv.data_ptr(), workspace.data_ptr(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"nrl_mhsa_bwd launch failed: cudaError {rc}")
    bwd_launches += 1
    wide_bwd_launches += wide_instance(l, d3 // 3, num_heads, qkv.dtype)
    long_bwd_launches += long_instance(l, d3 // 3, num_heads)
    return dqkv


class FusedSmallMHSA(torch.autograd.Function):
    """``fused_small_mhsa`` with a gradient: the forward launches the kernel
    (``mhsa_plain`` on the CPU) and saves qkv and the mask; the backward
    launches the backward kernel (``mhsa_backward`` on the CPU).  The mask
    and the head count get no gradient."""

    @staticmethod
    def forward(ctx, qkv, mask, num_heads):
        ctx.save_for_backward(qkv, mask)
        ctx.num_heads = num_heads
        return _forward(qkv, mask, num_heads)

    @staticmethod
    def backward(ctx, grad_out):
        qkv, mask = ctx.saved_tensors
        return _backward(qkv, mask, ctx.num_heads, grad_out), None, None


def fused_small_mhsa(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(U, L, 3D) qkv + (U, L) key mask -> (U, L, D) context; see module doc.
    Differentiable on every device through ``FusedSmallMHSA``."""
    return FusedSmallMHSA.apply(qkv, mask, num_heads)


# ctypes argument types of the C entry points (csrc/mhsa.cu)
_SIGNATURES = {
    "nrl_mhsa_fwd": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                     ctypes.c_int),
    "nrl_mhsa_bwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
                     ctypes.c_int),
    "nrl_mhsa_bwd_workspace": ([ctypes.c_int] * 5, ctypes.c_size_t),
}


def _kernel(name: str):
    from newsreclib_tpu_torch.ops.build import load_library

    fn = getattr(load_library("mhsa"), name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = _SIGNATURES[name]
    return fn
