"""Attention blocks of the NRMS path (counterpart of
``newsreclib_tpu/models/components/attention.py:28-124``).

Masked logits are REPLACED by the finite -1e30, never ``-inf``: a fully
masked row (the padding article, row 0 of every news table) then gets a
uniform softmax and finite values, which ``masked_softmax`` zeroes and the
MHSA output multiplication by the query mask zeroes.  With ``-inf`` those
rows are 0/0 = NaN, and NaN * 0 stays NaN.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from newsreclib_tpu_torch.models.components.linear import Dense, uniform
from newsreclib_tpu_torch.ops.mhsa import fused_small_mhsa

_MASK_MIN = -1e30


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Softmax with an optional boolean mask (True = keep); fully masked
    rows come out as zeros."""
    if mask is None:
        return torch.softmax(logits, dim=dim)
    out = torch.softmax(torch.where(mask, logits, _MASK_MIN), dim=dim)
    return torch.where(mask, out, 0.0)


class AdditiveAttention(nn.Module):
    """tanh(Linear(x)) . query -> masked softmax -> weighted sum.
    ``(..., L, D)`` + mask ``(..., L)`` -> ``(..., D)``."""

    def __init__(self, in_dim: int, query_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Dense(in_dim, query_dim, generator)
        self.query = nn.Parameter(uniform((query_dim,), -0.1, 0.1, generator))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = torch.tanh(self.proj(x)) @ self.query  # (..., L)
        weights = masked_softmax(logits, mask)
        return (weights.unsqueeze(-2) @ x).squeeze(-2)


class MultiHeadSelfAttention(nn.Module):
    """Fused qkv in-projection -> masked attention -> out-projection, with
    the output zeroed at masked query positions.
    ``(..., L, D)`` + key mask ``(..., L)`` -> ``(..., L, D)``.

    The attention itself is ``self.attention``, by default
    ``ops.mhsa.fused_small_mhsa`` (the CUDA kernel on the card); leading dims
    are flattened into its sequence axis.  Assigning
    ``ops.mhsa.mhsa_plain`` runs the plain version on any device, which is
    how the kernel is held against it end to end.
    """

    def __init__(self, dim: int, num_heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, generator)
        self.out = Dense(dim, dim, generator)
        self.attention = fused_small_mhsa

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        lead, l = x.shape[:-2], x.shape[-2]
        qkv = self.qkv(x).reshape(-1, l, self.qkv.weight.shape[0])
        if mask is None:
            m = torch.ones(qkv.shape[:2], dtype=torch.bool, device=x.device)
        else:
            m = mask.reshape(-1, l).contiguous()
        ctx = self.attention(qkv.contiguous(), m, self.num_heads)
        out = self.out(ctx).reshape(*lead, l, -1)
        if mask is not None:
            out = out * mask.unsqueeze(-1).to(out.dtype)
        return out
