"""NRMS title encoder (counterpart of
``newsreclib_tpu/models/components/text.py:33-92``, unpacked path).

The JAX package packs several titles into one attention sequence on the TPU
(``pack_to``); that is exact (``test_mhsa_packing_exact``) and the per-article
CUDA kernel has no use for it, so the port encodes each title on its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.models.components.attention import (
    AdditiveAttention,
    MultiHeadSelfAttention,
)
from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding


class MHSAAddAtt(nn.Module):
    """embed -> dropout -> MHSA -> dropout -> additive attention:
    ``(U, L)`` token ids -> ``(U, D)`` article vectors."""

    def __init__(self, vocab_size: int, embed_dim: int = 300, num_heads: int = 15,
                 query_dim: int = 200, dropout: float = 0.2,
                 pretrained: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = TokenEmbedding(vocab_size, embed_dim, pretrained, generator=generator)
        self.dropout = Dropout(dropout)
        self.mhsa = MultiHeadSelfAttention(embed_dim, num_heads, generator)
        self.add_att = AdditiveAttention(embed_dim, query_dim, generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dropout is on when ``deterministic`` is False and then draws from
        ``generator`` (``components/dropout.py``)."""
        x = self.dropout(self.embedding(tokens), deterministic, generator)
        x = self.dropout(self.mhsa(x, mask), deterministic, generator)
        return self.add_att(x, mask)
