"""Losses on score slates (counterpart of
``newsreclib_tpu/models/components/losses.py``): masked soft-target
cross-entropy and supervised contrastive loss over fixed-shape ``(B, C)``
slates, and their mix.

As the JAX package: masked entries take the finite -1e30, and the
logsumexp subtracts the row maximum with the maximum detached from the
graph (``stop_gradient``).
"""

from __future__ import annotations

from typing import Optional

import torch

_MASK_MIN = -1e30
_EPS = 1e-8


def _masked_logsumexp(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    x = torch.where(mask, x, _MASK_MIN)
    m = x.amax(dim=-1, keepdim=True).detach()
    return m.squeeze(-1) + torch.log(torch.where(mask, torch.exp(x - m), 0.0).sum(dim=-1))


def cross_entropy_loss(scores: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-target CE over candidate slates, mean over (valid) impressions;
    the target vector is not renormalized."""
    scores = scores.float()
    if mask is None:
        mask = torch.ones_like(scores, dtype=torch.bool)
    lse = _masked_logsumexp(scores, mask)
    log_prob = torch.where(mask, scores, 0.0) - lse.unsqueeze(-1)
    # a select, as JAX's product with a boolean mask: an all-masked padding
    # row has an infinite log_prob, and 0 * inf would make its loss NaN
    per_row = -torch.where(mask, labels * log_prob, 0.0).sum(dim=-1)
    if valid is None:
        return per_row.mean()
    v = valid.float()
    return (per_row * v).sum() / v.sum().clamp_min(1.0)


# a mean over the valid rows: weighted by their count, the sum of the losses
# of a batch's parts is the whole batch's (metrics/collector.py::loss_and_weight)
cross_entropy_loss.mean_over_valid = True


def supcon_loss(scores: torch.Tensor, labels: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                temperature: float = 0.1) -> torch.Tensor:
    """Supervised contrastive loss on the score matrix: per impression,
    -mean over positives of log softmax(s / T); averaged over the
    impressions with a nonzero loss (AvgNonZero), each needing at least one
    positive and one negative."""
    scores = scores.float() / temperature
    if mask is None:
        mask = torch.ones_like(scores, dtype=torch.bool)
    pos = (labels > 0) & mask
    neg = (labels <= 0) & mask
    log_prob = scores - _masked_logsumexp(scores, mask).unsqueeze(-1)
    n_pos = pos.sum(dim=-1).float()
    n_neg = neg.sum(dim=-1).float()
    mean_log_prob_pos = torch.where(pos, log_prob, 0.0).sum(dim=-1) / (n_pos + _EPS)
    per_row = torch.where((n_pos > 0) & (n_neg > 0), -mean_log_prob_pos, 0.0)
    if valid is not None:
        per_row = per_row * valid.float()
    nonzero = (per_row != 0.0).float()
    return per_row.sum() / nonzero.sum().clamp_min(1.0)


def dual_loss(scores: torch.Tensor, labels: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              valid: Optional[torch.Tensor] = None,
              temperature: float = 0.1, dual_loss_coef: float = 0.5) -> torch.Tensor:
    """(1 - c) * CE + c * SupCon."""
    ce = cross_entropy_loss(scores, labels, mask, valid)
    scl = supcon_loss(scores, labels, mask, valid, temperature)
    return (1.0 - dual_loss_coef) * ce + dual_loss_coef * scl


def get_loss_fn(name: str, **kwargs):
    """Loss by its config name: ``cross_entropy_loss``, ``sup_con_loss``
    (``temperature``) or ``dual_loss`` (``temperature``,
    ``dual_loss_coef``)."""
    if name == "cross_entropy_loss":
        return cross_entropy_loss
    if name == "sup_con_loss":
        t = kwargs.get("temperature", 0.1)
        return lambda s, l, m=None, v=None: supcon_loss(s, l, m, v, t)
    if name == "dual_loss":
        t = kwargs.get("temperature", 0.1)
        c = kwargs.get("dual_loss_coef", 0.5)
        return lambda s, l, m=None, v=None: dual_loss(s, l, m, v, t, c)
    raise ValueError(f"Loss not defined: {name}")
