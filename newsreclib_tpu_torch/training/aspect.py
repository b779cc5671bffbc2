"""MANNeR A-module training: SupCon on aspect-labelled news batches
(counterpart of ``newsreclib_tpu/training/aspect.py``).

``run_aspect_training`` is the CLI's ``model.name == manner_a`` route: m
articles per class a batch (``MPerClassNewsBatcher``), early stopping on
the validation SupCon loss, best / last checkpoints, and the kNN label
purity of the learned space over a sample of validation articles, and a
t-SNE scatter of that sample (``tsne_plot``) saved as
``<out_dir>/tsne_<aspect>.png``.  The plot imports matplotlib and
scikit-learn when it is made; where either is missing, or the plot fails,
the run logs that it was skipped and why, and goes on: the report must not
fail a run, as in the JAX package.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from newsreclib_tpu_torch.data.batch import NewsBatch, to_device
from newsreclib_tpu_torch.data.news_batching import MPerClassNewsBatcher
from newsreclib_tpu_torch.models.fair_rec.manner import supcon_embedding_loss
from newsreclib_tpu_torch.training.state import TrainState

log = logging.getLogger("newsreclib_tpu_torch")

KNN_SAMPLE = 2048  # validation articles embedded for the kNN purity


def make_aspect_train_step(temperature: float = 0.1):
    """``step(state, batch) -> (state, {"loss"})``: SupCon of the A-module's
    embeddings (dropout from the state's generator) and one Adam step, the
    state updated in place; ``batch`` is a ``NewsBatch`` on the model's
    device."""

    def step(state: TrainState, batch: NewsBatch):
        emb = state.model(batch.news, deterministic=False, generator=state.dropout_generator())
        loss = supcon_embedding_loss(emb, batch.labels, batch.valid, temperature)
        loss.backward()
        state.apply_gradients()
        return state, {"loss": loss.detach()}

    return step


def make_aspect_eval_loss(temperature: float = 0.1):
    """``eval_loss(state, batch)``: the SupCon loss without dropout, a
    device scalar."""

    @torch.no_grad()
    def eval_loss(state: TrainState, batch: NewsBatch) -> torch.Tensor:
        emb = state.model(batch.news, deterministic=True)
        return supcon_embedding_loss(emb, batch.labels, batch.valid, temperature)

    return eval_loss


def _device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def train_aspect_module(state: TrainState, batcher: MPerClassNewsBatcher, epochs: int = 1,
                        temperature: float = 0.1, limit_batches: Optional[int] = None,
                        loggers=()) -> TrainState:
    """``epochs`` epochs of ``make_aspect_train_step`` over ``batcher``,
    logging ``aspect/loss`` every 20 steps."""
    step = make_aspect_train_step(temperature)
    device = _device(state)
    gstep = 0
    for epoch in range(epochs):
        for i, batch in enumerate(batcher.epoch(epoch)):
            if limit_batches and i >= limit_batches:
                break
            state, metrics = step(state, to_device(batch, device))
            gstep += 1
            if i % 20 == 0:
                for lg in loggers:
                    lg.log_metrics({"aspect/loss": float(metrics["loss"]), "epoch": epoch}, gstep)
    return state


def knn_label_purity(embeddings: np.ndarray, labels: np.ndarray, k: int = 10) -> float:
    """Mean share of each point's k nearest neighbours (cosine, itself
    excluded) that carry its label."""
    x = embeddings / np.maximum(np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-12)
    sim = x @ x.T
    np.fill_diagonal(sim, -np.inf)
    nn = np.argsort(-sim, axis=1)[:, :k]
    return float((labels[nn] == labels[:, None]).mean())


def run_aspect_training(cfg: Dict, mind, info, loggers, out_dir: str,
                        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """The A-module CLI flow (``newsreclib_tpu/training/aspect.py:82-199``):
    SupCon over m-per-class batches of the train split's articles on
    ``model.aspect``, the validation loss over the test split's articles
    after every epoch, early stopping on it (``trainer.patience``), best /
    last checkpoints under ``<out_dir>/checkpoints``, then the kNN label
    purity of the validation embeddings.  Returns ``train/loss``,
    ``val/loss``, ``best_loss`` and ``val/knn_purity``."""
    from newsreclib_tpu_torch.models.factory import build_manner_a
    from newsreclib_tpu_torch.training.checkpoint import Checkpointer
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer

    mc, dc, tc = cfg["model"], cfg["data"], cfg["trainer"]
    aspect = mc.get("aspect", "category")
    temperature = mc.get("temperature") or 0.1
    seed = cfg.get("seed", 0)
    batch_size = mc.get("news_batch_size", dc.get("batch_size", 64))
    m = mc.get("m_per_class", 8)
    train_batcher = MPerClassNewsBatcher(mind.news_store("train"), aspect,
                                         batch_size=batch_size, m_per_class=m, seed=seed)
    # dev / test articles for the validation loss
    val_batcher = MPerClassNewsBatcher(mind.news_store("test"), aspect, batch_size=batch_size,
                                       m_per_class=m, seed=seed + 1)

    model = build_manner_a(mc, info, device=device, seed=seed)
    state = create_train_state(model, make_optimizer(mc.get("optimizer", {}).get("lr", 1e-4)),
                               dropout_seed=seed)
    ckpt = Checkpointer(os.path.join(out_dir, "checkpoints"))
    train_step = make_aspect_train_step(temperature)
    val_loss_of = make_aspect_eval_loss(temperature)
    limit = tc.get("limit_train_batches")
    limit_val = tc.get("limit_eval_batches")
    log_every = tc.get("log_every_n_steps", 50)
    best, bad, gstep = None, 0, 0
    history: Dict[str, float] = {}
    for epoch in range(tc.get("max_epochs", 20)):
        t0 = time.time()
        losses = []
        for i, nb in enumerate(train_batcher.epoch(epoch)):
            if limit and i >= limit:
                break
            state, metrics = train_step(state, to_device(nb, device))
            losses.append(metrics["loss"])
            gstep += 1
            if i % log_every == 0:
                log.info("aspect step %d: epoch=%d train/loss=%.4f", gstep, epoch,
                         float(metrics["loss"]))
        t1 = time.time()
        val_losses = []
        for i, nb in enumerate(val_batcher.epoch(epoch)):
            if limit_val and i >= limit_val:
                break
            val_losses.append(val_loss_of(state, to_device(nb, device)))
        train_loss = float(torch.stack(losses).double().mean()) if losses else float("nan")
        val_loss = float(torch.stack(val_losses).double().mean()) if val_losses else float("nan")
        if not (np.isfinite(train_loss) and np.isfinite(val_loss)):
            raise FloatingPointError(f"non-finite aspect loss in epoch {epoch}: train "
                                     f"{train_loss}, val {val_loss}")
        log.info("epoch %d: %.3f s training, %.3f s validation", epoch, t1 - t0,
                 time.time() - t1)
        history = {"train/loss": train_loss, "val/loss": val_loss}
        for lg in loggers:
            lg.log_metrics({**history, "epoch": epoch}, gstep)
        ckpt.save(state, gstep, metric=val_loss, extra={"epoch": epoch})
        if best is None or val_loss < best:
            best, bad = val_loss, 0
        else:
            bad += 1
            if bad >= tc.get("patience", 5):
                log.info("aspect early stopping at epoch %d (best val/loss=%.5f)", epoch, best)
                break
    history["best_loss"] = best if best is not None else float("nan")

    # the learned space's quality: kNN label purity over validation articles
    embs, labs = [], []
    with torch.no_grad():
        for nb in val_batcher.epoch(0):
            if len(embs) * batch_size >= KNN_SAMPLE:
                break
            e = state.model(to_device(nb.news, device), deterministic=True).float().cpu().numpy()
            embs.append(e[nb.valid])
            labs.append(np.asarray(nb.labels)[nb.valid])
    emb, lab = np.concatenate(embs), np.concatenate(labs)
    history["val/knn_purity"] = knn_label_purity(emb, lab)
    log.info("aspect kNN label purity (k=10, n=%d): %.4f", len(emb), history["val/knn_purity"])
    for lg in loggers:
        lg.log_metrics({"val/knn_purity": history["val/knn_purity"]}, gstep)
    try:
        tsne_plot(emb, lab, os.path.join(out_dir, f"tsne_{aspect}.png"))
    except Exception as e:  # noqa: BLE001 -- the picture must not fail a run
        log.warning("t-SNE plot of the %s space skipped: %s: %s", aspect, type(e).__name__, e)
    return history


def tsne_embedding(embeddings: np.ndarray, labels: np.ndarray, max_points: int = 2000,
                   seed: int = 0):
    """``(xy, labels, sel)``: at most ``max_points`` rows of ``embeddings``
    drawn without replacement by ``default_rng(seed)`` (``sel``, None when
    all are kept) and their scikit-learn t-SNE coordinates (PCA init,
    ``random_state=seed``, perplexity a tenth of the points within [5,
    30])."""
    from sklearn.manifold import TSNE

    sel = None
    if len(embeddings) > max_points:
        sel = np.random.default_rng(seed).choice(len(embeddings), max_points, replace=False)
        embeddings, labels = embeddings[sel], labels[sel]
    xy = TSNE(n_components=2, random_state=seed, init="pca",
              perplexity=min(30, max(5, len(embeddings) // 10))).fit_transform(embeddings)
    return xy, labels, sel


def tsne_plot(embeddings: np.ndarray, labels: np.ndarray, fpath: str, max_points: int = 2000,
              seed: int = 0) -> str:
    """t-SNE scatter of an aspect embedding space (``tsne_embedding``),
    coloured by class, saved as a PNG at ``fpath``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xy, labels, _ = tsne_embedding(embeddings, labels, max_points, seed)
    fig, ax = plt.subplots(figsize=(7, 6))
    scatter = ax.scatter(xy[:, 0], xy[:, 1], c=labels, s=6, cmap="tab20", alpha=0.7)
    ax.set_title("A-module embedding space (t-SNE)")
    fig.colorbar(scatter, ax=ax, label="aspect class")
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    fig.savefig(fpath, dpi=120, bbox_inches="tight")
    plt.close(fig)
    log.info("t-SNE plot saved to %s", fpath)
    return fpath
