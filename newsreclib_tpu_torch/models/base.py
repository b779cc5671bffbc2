"""Shared glue of the recommenders (counterpart of
``newsreclib_tpu/models/base.py:28-95``): gathering per-article vectors into
history/candidate slots, encoding a (possibly length-split) unique news
table, late-fusion users and score masking."""

from __future__ import annotations

from typing import Callable

import torch

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch


def gather_news(news_vecs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather unique-news vectors (U, D) into slots (B, X) -> (B, X, D)."""
    return news_vecs.index_select(0, idx.reshape(-1)).reshape(*idx.shape, news_vecs.shape[-1])


def encode_all_news(encode_fn: Callable[[NewsFeatures], torch.Tensor], batch: RecBatch) -> torch.Tensor:
    """Encode the batch's unique news table -> (U_total, D); a split table
    (``batch.news2``) is encoded per segment and the rows concatenated."""
    vecs = encode_fn(batch.news)
    if batch.news2 is not None:
        vecs = torch.cat([vecs, encode_fn(batch.news2)], dim=0)
    return vecs


def late_fusion_user(hist_vecs: torch.Tensor, hist_mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid clicked-news vectors."""
    m = hist_mask.to(hist_vecs.dtype)
    total = (hist_vecs * m.unsqueeze(-1)).sum(dim=1)
    count = m.sum(dim=1, keepdim=True).clamp_min(1.0)
    return total / count


def mask_scores(scores: torch.Tensor, cand_mask: torch.Tensor) -> torch.Tensor:
    """Push padded candidate scores to -1e30 so they never rank."""
    return torch.where(cand_mask, scores, -1e30)
