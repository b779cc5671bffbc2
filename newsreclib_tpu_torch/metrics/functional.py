"""Masked ranking and beyond-accuracy metrics on dense ``(B, C)`` slates
(counterpart of ``newsreclib_tpu/metrics/functional.py``; the functions the
serving path uses).

Conventions, as the JAX package's: AUC is pooled over every valid
(score, label) pair of the epoch, with tie-averaged ranks; MRR and nDCG@k
are per impression, 0 for an impression with no positive; diversity@k is the
entropy of the top-k class histogram over log(num_classes); personalization@k
is the generalized Jaccard of the top-k and history class counts.  Sorting is
stable, so ties rank in candidate order as in ``jnp.argsort``.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30
_EPS = 1e-12


def _masked_sort_desc(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Indices sorting each row by score desc, masked entries last."""
    s = torch.where(mask, scores.float(), _NEG_INF)
    return torch.argsort(-s, dim=-1, stable=True)


def binary_auc_weighted(preds: torch.Tensor, targets: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """Pooled binary AUROC over the entries of weight 1 (0 = masked).

    Masked entries go to -inf, so every valid entry's rank among all
    entries exceeds its rank among the valid ones by the masked count.
    """
    w = weights.float()
    preds = torch.where(w > 0, preds.float(), -math.inf)
    targets = targets.float() * w
    n_masked = (1.0 - w).sum()
    sorted_preds = torch.sort(preds).values
    left = torch.searchsorted(sorted_preds, preds, side="left")
    right = torch.searchsorted(sorted_preds, preds, side="right")
    avg_rank = (left + right + 1).float() / 2.0 - n_masked
    n_pos = targets.sum()
    n_neg = w.sum() - n_pos
    u = (avg_rank * targets).sum() - n_pos * (n_pos + 1.0) / 2.0
    ok = (n_pos > 0) & (n_neg > 0)
    return torch.where(ok, u / torch.clamp(n_pos * n_neg, min=1.0), 0.0)


def mrr(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B,) reciprocal rank of the first relevant candidate."""
    order = _masked_sort_desc(scores, mask)
    sorted_labels = torch.take_along_dim(labels * mask, order, dim=-1)
    positions = torch.arange(scores.shape[-1], dtype=torch.float32, device=scores.device)
    first_pos = torch.where(sorted_labels > 0, positions, math.inf).amin(dim=-1)
    has_pos = ((labels > 0) & mask).any(dim=-1)
    return torch.where(has_pos, 1.0 / (first_pos + 1.0), 0.0).float()


def ndcg_at_k(scores: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """(B,) nDCG@k with binary gains and log2(rank + 2) discount."""
    c = scores.shape[-1]
    labels = (labels * mask).float()
    order = _masked_sort_desc(scores, mask)
    sorted_by_pred = torch.take_along_dim(labels, order, dim=-1)
    sorted_by_rel = torch.sort(labels, dim=-1, descending=True).values
    positions = torch.arange(c, dtype=torch.float32, device=scores.device)
    discount = 1.0 / torch.log2(positions + 2.0)
    topk = (positions < k).float()
    dcg = (sorted_by_pred * discount * topk).sum(dim=-1)
    idcg = (sorted_by_rel * discount * topk).sum(dim=-1)
    return torch.where(idcg > 0, dcg / idcg.clamp_min(_EPS), 0.0)


def _onehot_counts(aspects: torch.Tensor, take: torch.Tensor, num_classes: int) -> torch.Tensor:
    classes = torch.arange(num_classes, device=aspects.device)
    onehot = (aspects.unsqueeze(-1) == classes).float()
    return (onehot * take.unsqueeze(-1).float()).sum(dim=1)


def topk_class_histogram(scores: torch.Tensor, aspects: torch.Tensor, mask: torch.Tensor,
                         k: int, num_classes: int) -> torch.Tensor:
    """(B, num_classes) class counts among each row's top-k valid candidates."""
    order = _masked_sort_desc(scores, mask)
    sorted_aspects = torch.take_along_dim(aspects, order, dim=-1)
    sorted_valid = torch.take_along_dim(mask, order, dim=-1)
    positions = torch.arange(scores.shape[-1], device=scores.device)
    return _onehot_counts(sorted_aspects, sorted_valid & (positions < k), num_classes)


def masked_class_histogram(aspects: torch.Tensor, mask: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, num_classes) class counts among the valid entries."""
    return _onehot_counts(aspects, mask, num_classes)


def diversity_at_k(scores: torch.Tensor, aspects: torch.Tensor, mask: torch.Tensor,
                   k: int, num_classes: int) -> torch.Tensor:
    """(B,) normalized entropy of the top-k class histogram; 0 where every
    candidate aspect is the padding class."""
    counts = topk_class_histogram(scores, aspects, mask, k, num_classes)
    p = counts / counts.sum(dim=-1, keepdim=True).clamp_min(1.0)
    entropy = -torch.where(p > 0, p * torch.log(p), 0.0).sum(dim=-1)
    div = entropy / math.log(float(num_classes))
    nonempty = (aspects * mask).sum(dim=-1) > 0
    return torch.where(nonempty, div, 0.0).float()


def generalized_jaccard(pred_counts: torch.Tensor, target_counts: torch.Tensor) -> torch.Tensor:
    """sum(min) / sum(max) over the last axis, on raw counts."""
    num = torch.minimum(pred_counts, target_counts).sum(dim=-1)
    den = torch.maximum(pred_counts, target_counts).sum(dim=-1)
    return num / den.clamp_min(_EPS)


def personalization_at_k(scores: torch.Tensor, cand_aspects: torch.Tensor,
                         cand_mask: torch.Tensor, hist_aspects: torch.Tensor,
                         hist_mask: torch.Tensor, k: int, num_classes: int) -> torch.Tensor:
    """(B,) generalized Jaccard between top-k candidate and history class
    counts; 0 where every candidate aspect is the padding class."""
    pred_counts = topk_class_histogram(scores, cand_aspects, cand_mask, k, num_classes)
    hist_counts = masked_class_histogram(hist_aspects, hist_mask, num_classes)
    pers = generalized_jaccard(pred_counts, hist_counts)
    nonempty = (cand_aspects * cand_mask).sum(dim=-1) > 0
    return torch.where(nonempty, pers, 0.0).float()
