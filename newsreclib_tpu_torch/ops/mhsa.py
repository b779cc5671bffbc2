"""Fused masked multi-head self-attention for many short sequences.

``fused_small_mhsa`` is the port of the TPU kernel
``newsreclib_tpu/ops/mhsa.py::fused_small_mhsa``: on a CUDA tensor it
launches the hand-written kernel ``csrc/mhsa.cu``; on a CPU tensor it runs
``mhsa_plain``, the same function in plain PyTorch.  There is no fallback
from one to the other: a CUDA tensor the kernel does not take raises.

Contract (as the TPU kernel's): ``qkv (U, L, 3D)`` is the fused in-projection
output, ``mask (U, L)`` bool marks the valid keys, the result is the context
``(U, L, D)`` in the input type, with sums in float32.  Masked keys take the
finite logit -1e30, so fully masked rows come out finite (uniform softmax);
rows at masked query positions hold values the caller zeroes.

The kernel has no backward yet: on a CUDA tensor that requires grad, with
grad enabled, the wrapper raises instead of returning a result cut off from
the graph.  The CPU route (``mhsa_plain``) is differentiable.
"""

from __future__ import annotations

import ctypes
import math

import torch

_MASK_MIN = -1e30
MAX_LEN = 64
MAX_HEAD_DIM = 32
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches since the last reset; the CPU path does not count.
launches = 0


def mhsa_plain(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: ``newsreclib_tpu/ops/mhsa.py::mhsa_reference``,
    computed in float32 and returned in the input type."""
    u, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    q, k, v = qkv.float().split(d, dim=-1)

    def heads(t):  # (U, L, D) -> (U, H, L, hd)
        return t.reshape(u, l, num_heads, hd).transpose(1, 2)

    logits = heads(q) @ heads(k).transpose(-1, -2) / math.sqrt(hd)
    logits = torch.where(mask[:, None, None, :], logits, _MASK_MIN)
    o = torch.softmax(logits, dim=-1) @ heads(v)
    return o.transpose(1, 2).reshape(u, l, d).to(qkv.dtype)


def smem_bytes(l: int, d: int, elem_size: int) -> int:
    """Shared memory the kernel needs for one sequence (``csrc/mhsa.cu``,
    ``smem_bytes`` with S = 1): the (L, 3D) slab in the input type plus 16
    bytes of alignment slack, rounded up to 16, then the L mask bytes
    rounded up to 16 (float32) or 64 float32 key biases (bfloat16)."""

    def align16(x):
        return (x + 15) // 16 * 16

    extra = align16(l) if elem_size == 4 else MAX_LEN * 4
    return align16(16 + l * 3 * d * elem_size) + extra


def _check(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> None:
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
    if l > MAX_LEN or d // num_heads > MAX_HEAD_DIM:
        raise ValueError(f"L={l} > {MAX_LEN} or head dim {d // num_heads} > {MAX_HEAD_DIM}")
    # The kernel stages a sequence's whole qkv slab in the input type: a
    # sequence whose slab does not fit one block is refused: float32 from
    # L * D of about 19,370 (L = 64 at D > 302), bfloat16 from about 38,700.
    if smem_bytes(l, d, qkv.element_size()) > _SMEM_LIMIT:
        raise ValueError(f"L={l}, D={d}, {qkv.dtype}: one sequence does not fit a block's "
                         "shared memory")


def fused_small_mhsa(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(U, L, 3D) qkv + (U, L) key mask -> (U, L, D) context; see module doc."""
    global launches
    _check(qkv, mask, num_heads)
    if qkv.device.type == "cpu":
        return mhsa_plain(qkv, mask, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"no kernel for device {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise RuntimeError("fused_small_mhsa: the CUDA kernel has no backward yet; call it under "
                           "torch.no_grad() / torch.inference_mode(), or use mhsa_plain to train")
    u, l, d3 = qkv.shape
    out = torch.empty((u, l, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if u == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(qkv.data_ptr(), mask.data_ptr(), out.data_ptr(), u, l, d3 // 3,
                num_heads, _DTYPES[qkv.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"nrl_mhsa_fwd launch failed: cudaError {rc}")
    launches += 1
    return out


def _kernel():
    from newsreclib_tpu_torch.ops.build import load_library

    fn = load_library("mhsa").nrl_mhsa_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn
