"""Train and eval steps (counterpart of ``newsreclib_tpu/training/steps.py``).

The train step is forward, loss, backward and one optimizer update, run
eagerly; the eval step gives scores and per-impression metrics on the
device.  Neither synchronises with the host: the loss comes back as a device
tensor.  The JAX package's global-row mode (``u_bucket`` / ``corpus``,
on-device dedup for multi-host runs) is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from newsreclib_tpu_torch.data.batch import RecBatch
from newsreclib_tpu_torch.metrics.collector import RankingMetrics
from newsreclib_tpu_torch.models.base import mask_scores, news_field
from newsreclib_tpu_torch.training.state import TrainState

DType = Union[str, torch.dtype, None]


def as_dtype(compute_dtype: DType) -> Optional[torch.dtype]:
    """A compute type given by name ("bfloat16") or as a dtype; None stays."""
    return getattr(torch, compute_dtype) if isinstance(compute_dtype, str) else compute_dtype


def apply_in_dtype(model, cdtype: Optional[torch.dtype], *args, **kwargs):
    """``model(*args, **kwargs)``, with the floating parameters cast to
    ``cdtype`` when one is given.  The cast is part of the graph, so the
    gradients land in float32 on the master parameters."""
    if cdtype is None:
        return model(*args, **kwargs)
    params = {n: p.to(cdtype) if p.is_floating_point() else p
              for n, p in model.named_parameters()}
    return functional_call(model, params, args, kwargs)


def make_train_step(loss_fn: Callable, compute_dtype: DType = None):
    """Build ``train_step(state, batch) -> (state, {"loss": ..., "aux/<k>": ...})``.

    ``loss_fn(scores, labels, cand_mask, valid) -> scalar``; the model's aux
    losses (already weighted) are added to it.  ``compute_dtype="bfloat16"``:
    mixed precision as the JAX step's: the master parameters and Adam's
    state stay float32, the forward and backward run on bf16 casts of the
    parameters, and the scores and the loss are float32.  Dropout draws from
    the state's generator seeded by (dropout seed, step).  The state is
    updated in place and returned.
    """
    cdtype = as_dtype(compute_dtype)

    def train_step(state: TrainState, batch: RecBatch) -> Tuple[TrainState, Dict]:
        generator = state.dropout_generator()
        scores, aux = apply_in_dtype(state.model, cdtype, batch, deterministic=False,
                             generator=generator)
        scores = scores.float()
        loss = loss_fn(scores, batch.labels, batch.cand_mask, batch.impression_valid)
        for v in aux.values():
            loss = loss + v.float()
        loss.backward()
        state.apply_gradients()
        metrics = {"loss": loss.detach(), **{f"aux/{k}": v.detach() for k, v in aux.items()}}
        return state, metrics

    return train_step


def make_eval_step(loss_fn: Optional[Callable] = None, ranking: Optional[RankingMetrics] = None,
                   with_aspects: bool = True, compute_dtype: DType = None):
    """Build ``eval_step(state, batch) -> (scores, per_impression, valid, loss)``:
    float32 scores with padded candidates at -1e30, the ranking metrics per
    impression (with the category and sentiment aspects when the batch's
    news carry them and ``with_aspects``), the (B,) valid-row mask and the
    loss (None without ``loss_fn``).  No dropout."""
    ranking = ranking or RankingMetrics()
    cdtype = as_dtype(compute_dtype)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: RecBatch):
        scores, _ = apply_in_dtype(state.model, cdtype, batch, deterministic=True)
        scores = mask_scores(scores.float(), batch.cand_mask)
        valid = batch.impression_valid
        if valid is None:
            valid = torch.ones(scores.shape[0], dtype=torch.bool, device=scores.device)
        kwargs = {}
        if with_aspects and batch.news.category is not None:
            categ = news_field(batch, "category")
            kwargs["cand_categories"] = categ[batch.cand_idx]
            kwargs["hist_categories"] = categ[batch.hist_idx]
        if with_aspects and batch.news.sentiment is not None:
            sent = news_field(batch, "sentiment")
            kwargs["cand_sentiments"] = sent[batch.cand_idx]
            kwargs["hist_sentiments"] = sent[batch.hist_idx]
        if kwargs:
            kwargs["hist_mask"] = batch.hist_mask
        per_imp = ranking.per_impression(scores, batch.labels, batch.cand_mask, **kwargs)
        loss = None if loss_fn is None else loss_fn(scores, batch.labels, batch.cand_mask, valid)
        return scores, per_imp, valid, loss

    return eval_step
