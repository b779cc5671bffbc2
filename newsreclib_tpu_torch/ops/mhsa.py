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
LONG_TC_MAX_HEAD_DIM = 256  # the long instances' tensor-core tiles (bf16); XL above
LONG_TC_MAX_HEAD_DIM_F32 = 64  # ... in float32 (the XL instances were faster above it)
TC_ROWS = 64  # rows of a tile of the long instances on the tensor-core tiles
XL_COLS = 64  # head dim columns of a warp of the XL instances
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the forward and of the backward kernel since the last reset,
# and of those, the launches of the wide instances (``wide_instance``), of
# the long ones (``long_instance``) and, among those, of the XL ones
# (``xl_instance``); the CPU path counts none.  One backward counts once,
# whatever it launches inside (the long instances' backward is three
# kernels).
launches = 0
bwd_launches = 0
wide_launches = 0
wide_bwd_launches = 0
long_launches = 0
long_bwd_launches = 0
xl_launches = 0
xl_bwd_launches = 0


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


_SMEM_TARGET = 113 * 1024  # a block's share when two share an SM
_SMEM_PER_SM = 233472  # shared memory of an H100 SM, 1 KB of it reserved a block
NARROW_BWD_MAX_HEADS = 8  # heads of a head group of the narrow bf16 backward
NARROW_BWD_MAX_SEQS = 4  # sequences of a whole-sequence group


def _bwd_stage_bytes(s: int, hg: int, l: int, d: int, h: int) -> int:
    """One stage of the narrow bf16 backward's ring (``bwd_stage_bytes``):
    whole sequences' qkv and dO slabs, or a head group's q, k, v and dO rows
    padded as the wide instances', and 64 key biases a sequence."""
    if hg == h:
        return _align16(16 + s * l * 3 * d * 2) + _align16(16 + s * l * d * 2) + s * NARROW_MAX_LEN * 4
    row = (hg * (d // h) + 15) // 16 * 16 + 8
    return 4 * l * row * 2 + NARROW_MAX_LEN * 4


def narrow_bwd_plan(u: int, l: int, d: int, num_heads: int, sms: int = 132) -> tuple:
    """``(sequences, heads, warps, blocks)`` of the narrow bfloat16
    backward's launch on a card of ``sms`` SMs (``csrc/mhsa.cu``,
    ``bwd_plan``, the same rule): groups of whole sequences, as many as fit
    twice (the ring's two stages) in a block's share of an SM (two blocks
    up to L = 16, one above) up to 4, 8 warps a block (16 at L = 17 to 32),
    when the groups give every block of a full persistent grid one at
    least; else groups of ceil(H / n) heads of one sequence, a warp each, n
    from ceil(H / 8) up: the largest group whose use of the grid's slots
    (groups over waves x blocks) is within 10% of the best split's.  On the
    H100 at D = 300, 15 heads: whole sequences at L = 16 from U = 264 and at
    L = 30 from U = 132, 8 + 7 heads at (64, 50) and (256, 50), 5 at
    (32, 50)."""
    h = num_heads
    kt = (l + 15) // 16
    budget = _SMEM_TARGET if kt == 1 else _SMEM_LIMIT
    warps = 16 if kt == 2 else 8

    def blocks_per_sm(w, smem):
        return min((16 if kt <= 2 else 8) // w, _SMEM_PER_SM // (smem + 1024))

    for s in range(NARROW_BWD_MAX_SEQS, 0, -1):
        stage = _bwd_stage_bytes(s, h, l, d, h)
        if 2 * stage > budget:
            continue
        grid = sms * blocks_per_sm(warps, 2 * stage)
        if -(-u // s) >= grid:
            return s, h, warps, grid
    cands, last = [], 0
    for n in range(-(-h // NARROW_BWD_MAX_HEADS), h + 1):
        hg = -(-h // n)
        if hg == last:
            continue
        last = hg
        slots = sms * blocks_per_sm(hg, 2 * _bwd_stage_bytes(1, hg, l, d, h))
        if slots == 0:  # its two stages do not fit an SM
            continue
        groups = u * -(-h // hg)
        cands.append(((1, hg, hg, min(groups, slots)), groups / (-(-groups // slots) * slots)))
    best = max(use for _, use in cands)
    return next(plan for plan, use in cands if use >= 0.9 * best)


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


def long_tc(hd: int, dtype: torch.dtype) -> bool:
    """Whether a long instance at head dim ``hd`` in ``dtype`` runs in the
    tensor-core tiles of ``TC_ROWS`` rows (``csrc/mhsa.cu``, ``long_tc``):
    head dims up to ``LONG_TC_MAX_HEAD_DIM`` in bfloat16 and
    ``LONG_TC_MAX_HEAD_DIM_F32`` in float32.  Above it a 16-row strip's
    output accumulators would need 128 registers and more a thread, and the
    XL instances run: a block's warps split the head dim in groups of 64
    columns and form each tile pair's logits once."""
    return hd <= (LONG_TC_MAX_HEAD_DIM_F32 if dtype == torch.float32 else LONG_TC_MAX_HEAD_DIM)


def xl_instance(l: int, d: int, num_heads: int, dtype: torch.dtype) -> bool:
    """Whether (L, D, heads) in ``dtype`` runs in the XL instances: a long
    instance above ``long_tc``'s head dims."""
    return long_instance(l, d, num_heads) and not long_tc(d // num_heads, dtype)


def xl_smem(hd: int, dtype: torch.dtype) -> int:
    """Shared memory of the largest XL kernel at head dim ``hd``
    (``xl_instance_smem``): of the forward (kind 0), the statistics and dQ
    kernels (1) and the dK / dV kernel (2), each with two stages of its ring
    where they fit 232,448 bytes, else one.  A kernel stages its own 16 rows
    (q; q and dO; k and v), stages of two streamed tiles of T rows (16 in
    bfloat16, 8 in float32), T key biases (3 T query statistics in kind 2) a
    stage, and one (kind 0) or two planes of ceil(hd / 64) warps' 16 x T
    float32 partial sums."""
    es = 2 if dtype == torch.bfloat16 else 4
    t = 16 if es == 2 else 8
    row = ((hd + 15) // 16 * 16 + 8) * 2 if es == 2 else ((hd + 7) // 8 * 8 + 4) * 4
    warps = (hd + XL_COLS - 1) // XL_COLS

    def kind_bytes(kind, stages):
        return ((1 if kind == 0 else 2) * 16 * row + stages * 2 * t * row
                + stages * (3 if kind == 2 else 1) * t * 4
                + (1 if kind == 0 else 2) * warps * 16 * t * 4)

    return max(kind_bytes(k, 2) if kind_bytes(k, 2) <= _SMEM_LIMIT else kind_bytes(k, 1)
               for k in range(3))


def smem_bytes(l: int, d: int, num_heads: int, dtype: torch.dtype) -> int:
    """Shared memory of the kernel instance that runs (L, D, heads) in
    ``dtype``, the larger of its forward's and backward's: what that
    instance stages (``csrc/mhsa.cu``, ``instance_smem``).

    * long (``long_instance``): on the tensor-core tiles (``long_tc``) the
      dK / dV kernel's six tiles of ``TC_ROWS`` rows in the input type, rows
      padded as the wide instances', and 6 ``TC_ROWS`` float32 row
      statistics; above them the largest XL kernel's (``xl_smem``);
    * wide (``wide_instance``): one head's q, k, v and dO columns in the
      input type, Lp = 16 ceil(L / 16) rows each, padded to
      16 ceil(hd / 16) + 8 values (bfloat16) or 8 ceil(hd / 8) + 4
      (float32), and 4 Lp float32 key biases and row statistics;
    * float32, head dim up to 32: one head's q, k, v and dO columns, each
      rounded up to 16 bytes, plus 64 key biases;
    * bfloat16, head dim up to 32: the forward's whole (L, 3D) slab of one
      sequence plus 16 bytes of alignment slack, plus 64 key biases (the
      backward's plan, ``narrow_bwd_plan``, picks groups that fit)."""
    hd = d // num_heads
    row = ((hd + 15) // 16 * 16 + 8) * 2 if dtype == torch.bfloat16 else ((hd + 7) // 8 * 8 + 4) * 4
    if long_instance(l, d, num_heads):
        if long_tc(hd, dtype):
            return 6 * TC_ROWS * row + 6 * TC_ROWS * 4
        return xl_smem(hd, dtype)
    if wide_instance(l, d, num_heads, dtype):
        lp = (l + 15) // 16 * 16
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
    global launches, wide_launches, long_launches, xl_launches
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
    xl_launches += xl_instance(l, d3 // 3, num_heads, qkv.dtype)
    return out


def _backward(qkv: torch.Tensor, mask: torch.Tensor, num_heads: int,
              grad_out: torch.Tensor) -> torch.Tensor:
    """The checked backward, d(loss)/d(qkv) given d(loss)/d(context):
    ``mhsa_backward`` on the CPU, the backward kernel elsewhere.  ``grad_out``
    may be any layout (autograd hands over expanded or strided ones); it is
    made contiguous here.  The long instances' per-row statistics go to a
    workspace of ``nrl_mhsa_bwd_workspace`` bytes from torch's allocator."""
    global bwd_launches, wide_bwd_launches, long_bwd_launches, xl_bwd_launches
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
    xl_bwd_launches += xl_instance(l, d3 // 3, num_heads, qkv.dtype)
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
