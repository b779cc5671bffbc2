"""Click predictor (counterpart of
``newsreclib_tpu/models/components/click.py:15-17``)."""

from __future__ import annotations

import torch


def dot_product_scores(user_vec: torch.Tensor, cand_vecs: torch.Tensor) -> torch.Tensor:
    """user (B, D) x candidates (B, C, D) -> scores (B, C)."""
    return (cand_vecs @ user_vec.unsqueeze(-1)).squeeze(-1)
