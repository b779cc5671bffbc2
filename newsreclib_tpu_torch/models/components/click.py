"""Click predictors (counterpart of
``newsreclib_tpu/models/components/click.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from newsreclib_tpu_torch.models.components.linear import Dense


def dot_product_scores(user_vec: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
    """user (B, D) x candidates (B, C, D) -> scores (B, C)."""
    return (cand_vecs @ user_vec.unsqueeze(-1)).squeeze(-1)


class DNNPredictor(nn.Module):
    """DKN's click predictor: ``concat(candidate, user)`` -> relu(Dense) ->
    Dense: per-candidate user vectors (..., C, D) and candidates (..., C, D)
    -> scores (..., C)."""

    def __init__(self, dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(2 * dim, hidden_dim, generator)
        self.fc2 = Dense(hidden_dim, 1, generator)

    def forward(self, user_vecs: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.fc1(torch.cat([cand_vecs, user_vecs], dim=-1)))
        return self.fc2(h)[..., 0]
