"""Category encoder (counterpart of
``newsreclib_tpu/models/components/category.py:19-41``)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding
from newsreclib_tpu_torch.models.components.linear import Dense


class LinearEncoder(nn.Module):
    """Category embedding (optionally from a pretrained matrix), optional
    dropout, optional ``relu(Dense)`` to ``output_dim``: ``(U,)`` ids ->
    ``(U, output_dim or embed_dim)``."""

    def __init__(self, num_categories: int, embed_dim: int,
                 pretrained: Optional[np.ndarray] = None, frozen: bool = False,
                 use_dropout: bool = True, dropout: float = 0.2,
                 linear_transform: bool = False, output_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = TokenEmbedding(num_categories, embed_dim, pretrained, generator, frozen)
        self.dropout = Dropout(dropout) if use_dropout else None
        self.linear = Dense(embed_dim, output_dim, generator) if linear_transform else None
        self.output_dim = output_dim if linear_transform else embed_dim

    def forward(self, category: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.embedding(category)
        if self.dropout is not None:
            x = self.dropout(x, deterministic, generator)
        if self.linear is not None:
            x = torch.relu(self.linear(x))
        return x
