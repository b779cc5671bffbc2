"""NRMS user encoder (counterpart of
``newsreclib_tpu/models/components/user.py:36-47``): MHSA over the H = 50
history slots (through the attention kernel), then additive attention."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from newsreclib_tpu_torch.models.components.attention import (
    AdditiveAttention,
    MultiHeadSelfAttention,
)


class NRMSUserEncoder(nn.Module):
    def __init__(self, dim: int = 300, num_heads: int = 15, query_dim: int = 200,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mhsa = MultiHeadSelfAttention(dim, num_heads, generator)
        self.add_att = AdditiveAttention(dim, query_dim, generator)

    def forward(self, hist: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, D) clicked-news vectors + (B, H) mask -> (B, D)."""
        return self.add_att(self.mhsa(hist, mask), mask)
