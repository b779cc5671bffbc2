"""Attention blocks (counterpart of
``newsreclib_tpu/models/components/attention.py``: ``AdditiveAttention``,
``MultiHeadSelfAttention``, MINER's ``PolyAttention`` and
``TargetAwareAttention``, CAUM's ``DenseAttention`` and NPA's
``PersonalizedAttention``).

Masked logits are REPLACED by the finite -1e30, never ``-inf``: a fully
masked row (the padding article, row 0 of every news table) then gets a
uniform softmax and finite values, which ``masked_softmax`` zeroes and the
MHSA output multiplication by the query mask zeroes.  With ``-inf`` those
rows are 0/0 = NaN, and NaN * 0 stays NaN.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from newsreclib_tpu_torch.models.components.linear import Dense, uniform
from newsreclib_tpu_torch.ops import mhsa

_MASK_MIN = -1e30


def masked_softmax(logits: torch.Tensor, mask: Optional[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Softmax with an optional boolean mask (True = keep); fully masked
    rows come out as zeros."""
    if mask is None:
        return torch.softmax(logits, dim=dim)
    out = torch.softmax(torch.where(mask, logits, _MASK_MIN), dim=dim)
    return torch.where(mask, out, 0.0)


def use_plain_attention(model: nn.Module) -> nn.Module:
    """Set every ``MultiHeadSelfAttention`` of ``model`` to ``mhsa_plain``,
    in place, and return ``model``: the plain route the kernel route is
    held against."""
    for m in model.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.attention = mhsa.mhsa_plain
    return model


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
    ``ops.mhsa.fused_small_mhsa``: the CUDA kernel on the card (any L, head
    dims up to 1,024, float32 or bfloat16: ``ops.mhsa.kernel_supports``),
    and the plain version on the CPU; leading dims are flattened into its
    sequence axis.  Assigning ``ops.mhsa.mhsa_plain`` runs the plain version
    on any device, which is how the kernel is held against it end to end.
    """

    def __init__(self, dim: int, num_heads: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} is not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, generator)
        self.out = Dense(dim, dim, generator)
        self.attention = mhsa.fused_small_mhsa

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


class DenseAttention(nn.Module):
    """CAUM's 3-layer tanh MLP scorer: ``(..., D)`` -> ``(..., 1)``."""

    def __init__(self, in_dim: int, hidden_dim1: int, hidden_dim2: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(in_dim, hidden_dim1, generator)
        self.fc2 = Dense(hidden_dim1, hidden_dim2, generator)
        self.fc3 = Dense(hidden_dim2, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc3(torch.tanh(self.fc2(torch.tanh(self.fc1(x)))))


class PolyAttention(nn.Module):
    """MINER's user encoder: K context codes attend over the history, K
    interest vectors out.  ``(B, L, D)`` + mask ``(B, L)`` -> ``(B, K, D)``;
    ``bias`` ``(B, L, C)`` (the category bias) is averaged over the
    candidates and added to every code's logit at each position."""

    def __init__(self, in_dim: int, num_context_codes: int, context_code_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Dense(in_dim, context_code_dim, generator, use_bias=False)
        codes = nn.init.xavier_uniform_(torch.empty(num_context_codes, context_code_dim),
                                        generator=generator)
        self.context_codes = nn.Parameter(codes)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        logits = self.context_codes @ torch.tanh(self.proj(x)).transpose(1, 2)  # (B, K, L)
        if bias is not None:
            logits = logits + bias.mean(dim=-1)[:, None, :]
        weights = masked_softmax(logits, None if mask is None else mask[:, None, :])
        return weights @ x


class TargetAwareAttention(nn.Module):
    """MINER's weighted score: query ``(B, K, D)`` (the interests), key
    ``(B, C, D)`` (the candidates), value ``(B, C, K)`` (their raw scores)
    -> ``(B, C)``.  flax's ``nn.gelu`` is the tanh approximation."""

    def __init__(self, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Dense(dim, dim, generator, use_bias=False)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor) -> torch.Tensor:
        proj = F.gelu(self.proj(query), approximate="tanh")
        weights = torch.softmax(key @ proj.transpose(1, 2), dim=-1)  # (B, C, K)
        return (weights * value).sum(dim=-1)


class PersonalizedAttention(nn.Module):
    """NPA's attention with a per-row query: query ``(B, Dq)``, keys
    ``(B, L, F)`` + mask ``(B, L)`` -> ``(B, F)``."""

    def __init__(self, query_dim: int, num_filters: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.query_proj = Dense(query_dim, num_filters, generator)

    def forward(self, query: torch.Tensor, keys: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = torch.tanh(self.query_proj(query))  # (B, F)
        weights = masked_softmax((keys @ q.unsqueeze(-1)).squeeze(-1), mask)  # (B, L)
        return (weights.unsqueeze(-2) @ keys).squeeze(-2)
