"""Token embedding (counterpart of
``newsreclib_tpu/models/components/embedding.py:36-56``).

Padding semantics: the output is multiplied by ``ids != 0``, which zeroes
the padding vector whatever row 0 of the table holds (and blocks its
gradient).  torch's ``padding_idx`` alone only blocks the gradient.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from newsreclib_tpu_torch.models.components.linear import normal


class TokenEmbedding(nn.Module):
    """Trainable token table, optionally from a pretrained matrix."""

    def __init__(self, vocab_size: int, embed_dim: int,
                 pretrained: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pretrained is not None:
            table = torch.tensor(np.asarray(pretrained, dtype=np.float32))
            if tuple(table.shape) != (vocab_size, embed_dim):
                raise ValueError(f"pretrained table {tuple(table.shape)} is not "
                                 f"{(vocab_size, embed_dim)}")
        else:
            table = normal((vocab_size, embed_dim), 0.02, generator)
        self.weight = nn.Parameter(table)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = F.embedding(ids, self.weight)
        return out * (ids != 0).unsqueeze(-1).to(out.dtype)
