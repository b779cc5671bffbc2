"""User-id projections of NPA (counterpart of
``newsreclib_tpu/models/components/projection.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.linear import Dense, uniform


class UserProjection(nn.Module):
    """User id -> a row of the ``user_embed`` table (uniform [0, 1), as the
    JAX package's and the reference's ``torch.rand``) -> dropout."""

    def __init__(self, num_users: int, user_embed_dim: int, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.user_embed = nn.Parameter(uniform((num_users, user_embed_dim), 0.0, 1.0, generator))
        self.dropout = Dropout(dropout, over_rows=True)

    def forward(self, users: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.dropout(self.user_embed[users], deterministic, generator)


class UserPreferenceQueryProjection(nn.Module):
    """Projected user -> preference query: ``relu(Dense)`` -> dropout."""

    def __init__(self, in_dim: int, preference_query_dim: int, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.proj = Dense(in_dim, preference_query_dim, generator)
        self.dropout = Dropout(dropout, over_rows=True)

    def forward(self, projected_users: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.dropout(torch.relu(self.proj(projected_users)), deterministic, generator)
