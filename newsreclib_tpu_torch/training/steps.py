"""Train and eval steps (counterpart of ``newsreclib_tpu/training/steps.py``).

The train step is forward, loss, backward and one optimizer update, run
eagerly; the eval step gives scores and per-impression metrics on the
device.  Neither synchronises with the host: the loss comes back as a device
tensor.

With ``u_bucket`` the train step takes global-row batches and a ``corpus``
(the store's features on the device) and dedups on the device
(``data/batch.py::densify``); an overflowing bucket poisons the loss with
NaN.  On a sharded state (``state.grid``, ``parallel/mesh.py``) the step is
one rank's part of a data-parallel step: a multi-host rank first gathers
the global batch's rows (``gather_batch``), every rank dedups the global
batch and keeps its rows (``shard_batch``); the loss is the loss function of
the global batch (the scores gathered with their gradient, so cross-entropy
divides by the global valid count and SupCon compares all rows), the
models' aux losses enter as their mean over the data ranks, and the
gradients are summed over the data group after ``backward``, before the
update.  Every rank draws dropout from a generator in the same state, over
the global batch (``models/components/dropout.py``): the ranks apply the
masks of a one-device step on the global batch.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch.func import functional_call

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch
from newsreclib_tpu_torch.metrics.collector import RankingMetrics
from newsreclib_tpu_torch.models.base import mask_scores, news_field
from newsreclib_tpu_torch.models.components.dropout import global_batch_rows
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


def global_loss(loss_fn: Callable, scores: torch.Tensor, batch: RecBatch, aux: Dict,
                grid=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(objective to differentiate, loss to report)`` of one rank's scores:
    ``loss_fn`` plus the aux losses.  Without ``grid`` both are that sum.
    With one, ``loss_fn`` sees the scores, labels, masks and valid rows of
    every data rank (the scores with their gradient,
    ``parallel/collectives.py::GatherRows``), each aux loss (a mean over the
    replicated news table or the rank's rows) enters the objective divided
    by the data size, and the reported loss adds the aux losses' mean over
    the data ranks: the one-device loss of the global batch."""
    valid = batch.impression_valid
    if grid is None:
        loss = loss_fn(scores, batch.labels, batch.cand_mask, valid)
        for v in aux.values():
            loss = loss + v.float()
        return loss, loss.detach()
    from newsreclib_tpu_torch.parallel.collectives import gather_rows, gather_rows_with_grad

    g, n, i = grid.data_group, grid.data_size, grid.data_index
    if valid is None:
        valid = torch.ones(scores.shape[0], dtype=torch.bool, device=scores.device)
    main = loss_fn(gather_rows_with_grad(scores, g, n, i),
                   *(gather_rows(t, g, n, i, "gather_loss_inputs")
                     for t in (batch.labels, batch.cand_mask, valid)))
    if not aux:
        return main, main.detach()
    aux_sum = sum(v.float() for v in aux.values())
    return main + aux_sum / n, main.detach() + data_mean(aux_sum.detach(), grid)


def data_mean(x: torch.Tensor, grid=None) -> torch.Tensor:
    """The mean of the scalar ``x`` over the data ranks (``x`` itself
    without ``grid``)."""
    if grid is None:
        return x
    from newsreclib_tpu_torch.parallel.collectives import all_reduce_

    return all_reduce_(x.reshape(1), grid.data_group, "aux_mean")[0] / grid.data_size


def local_rows(batch: RecBatch, grid=None, corpus=None, u_bucket: Optional[int] = None):
    """``(this rank's batch, overflow)``: a global-row batch (with ``corpus``)
    densified over the global batch, the rows of the rank kept (see the
    module doc); ``overflow`` None without ``corpus``."""
    overflow = None
    if corpus is not None:
        from newsreclib_tpu_torch.data.batch import densify

        if grid is not None and not grid.replicated_batches:
            from newsreclib_tpu_torch.parallel.mesh import gather_batch

            batch = gather_batch(batch, grid)
        batch, overflow = densify(batch, corpus, u_bucket)
        if grid is not None:
            from newsreclib_tpu_torch.parallel.mesh import shard_batch

            batch = shard_batch(batch, grid)
    return batch, overflow


def rows_of(grid):
    """The context of a forward on one data rank's rows of the global batch
    (``dropout.global_batch_rows``); nothing without ``grid``."""
    return nullcontext() if grid is None else global_batch_rows(grid.data_size, grid.data_index)


def reduce_gradients(state: TrainState) -> None:
    """Sum the gradients of a sharded state over its data group (nothing on
    one device)."""
    if state.grid is not None:
        from newsreclib_tpu_torch.parallel.collectives import all_reduce_gradients

        all_reduce_gradients(state.model.parameters(), state.grid.data_group)


def make_train_step(loss_fn: Callable, compute_dtype: DType = None,
                    u_bucket: Optional[int] = None):
    """Build ``train_step(state, batch) -> (state, {"loss": ..., "aux/<k>": ...})``.

    ``loss_fn(scores, labels, cand_mask, valid) -> scalar``; the model's aux
    losses (already weighted) are added to it.  ``compute_dtype="bfloat16"``:
    mixed precision as the JAX step's: the master parameters and Adam's
    state stay float32, the forward and backward run on bf16 casts of the
    parameters, and the scores and the loss are float32.  Dropout draws from
    the state's generator seeded by (dropout seed, step).  The state is
    updated in place and returned.

    ``u_bucket``: the global-row mode, ``train_step(state, batch, corpus)``
    (module doc).  On a sharded state every rank draws the one-device masks:
    those of the replicated news table whole, those over batch rows at the
    global batch's shape, keeping the rank's rows.
    """
    cdtype = as_dtype(compute_dtype)

    def train_step(state: TrainState, batch: RecBatch,
                   corpus: Optional[NewsFeatures] = None) -> Tuple[TrainState, Dict]:
        batch, overflow = local_rows(batch, state.grid, corpus, u_bucket)
        generator = state.dropout_generator()
        with rows_of(state.grid):
            scores, aux = apply_in_dtype(state.model, cdtype, batch, deterministic=False,
                                         generator=generator)
        objective, loss = global_loss(loss_fn, scores.float(), batch, aux, state.grid)
        if overflow is not None:
            poison = torch.zeros((), device=loss.device).masked_fill(overflow, float("nan"))
            objective, loss = objective + poison, loss + poison
        objective.backward()
        reduce_gradients(state)
        state.apply_gradients()
        metrics = {"loss": loss, **{f"aux/{k}": v.detach() for k, v in aux.items()}}
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
