"""Training loop: epochs, validation, early stopping, checkpoints (counterpart
of ``newsreclib_tpu/training/trainer.py``).

Fit-time evaluation uses the cached serving path (``serving.CachedScorer``:
encode the corpus once per parameter version, then gather and score)
whenever the model has ``encode_news`` / ``score_with_vectors`` and
``limit_eval_batches`` is unset; otherwise it streams ``EvalBatcher``
batches through the eval step (``StreamingEval``).

Multi-rank (``mesh``, ``parallel/mesh.py``): the state is cut to this rank's
shards (``place_state``), every batch to this rank's rows (a host-dedup
batch here, a global-row batch inside the step), and the step sums the
gradients over the data group.  ``corpus`` + ``u_bucket`` select global-row
training (``data/batch.py::densify``), which multi-host mode requires.
Evaluation: every rank joins the gather of a sharded state into a
one-device copy of the model.  In single-node mode (``trainer.devices=N``,
``mesh.replicated_batches``) every rank then scores its share, as the JAX
package's one-host mesh does: the cached path through
``CachedScorer(mesh=...)``, the streaming path on the rank's rows of each
batch (``shard_batch``, JAX's ``self._shard``) with ``StreamingEval``'s sums
reduced over the data group, so every rank returns the same metrics.  In
multi-host mode the JAX package's rule holds (``trainer.py:243-297``):
rank 0 scores the full set on its own device, so its metrics are one
device's, and the other ranks return {}.  The monitored value is broadcast
from rank 0, rank 0 alone writes the (gathered, full) checkpoints, and a
restore cuts them back to the shards.
"""

from __future__ import annotations

import copy
import logging
import time
from collections import deque
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from newsreclib_tpu_torch.data.batch import to_device
from newsreclib_tpu_torch.data.batching import EvalBatcher, TrainBatcher
from newsreclib_tpu_torch.metrics.collector import (
    RankingMetrics,
    StreamingEval,
    loss_and_weight,
)
from newsreclib_tpu_torch.training.checkpoint import Checkpointer
from newsreclib_tpu_torch.training.state import TrainState
from newsreclib_tpu_torch.training.steps import make_eval_step, make_train_step

log = logging.getLogger("newsreclib_tpu_torch")


@dataclass
class TrainerConfig:
    max_epochs: int = 20
    patience: int = 5  # early stopping on monitor
    monitor: str = "loss"  # metric of the val set
    mode: str = "min"
    log_every_n_steps: int = 50
    check_finite: bool = True
    ckpt_dir: Optional[str] = None
    limit_train_batches: Optional[int] = None
    limit_eval_batches: Optional[int] = None
    cached_eval: bool = True  # fit-time eval from the news-vector cache
    row_shard_embeddings: bool = True  # over the mesh's model axis, if > 1
    # Megatron tensor parallelism of the PLM tower over the model axis
    # (parallel/mesh.py): q/k/v/ff1 column-, attn_out/ff2 row-parallel
    tp_transformer: bool = False
    # "bfloat16": bf16 compute on float32 master parameters; None: float32
    compute_dtype: Optional[str] = None
    # the finite check reads each step's loss this many steps later, so the
    # host never waits for the step it has just launched
    async_check_depth: int = 8
    # debug: replay the same first N train batches every epoch
    overfit_batches: Optional[int] = None


class _ReplayBatcher:
    """Fixed-batch replay for ``TrainerConfig.overfit_batches``."""

    def __init__(self, batches, batch_size):
        self._batches = batches
        self.batch_size = batch_size

    def __len__(self):
        return len(self._batches)

    def epoch(self, _epoch_idx):
        return iter(self._batches)


class Trainer:
    """``state.model`` trains in place; its device is the trainer's."""

    def __init__(
        self,
        state: TrainState,
        loss_fn: Callable,
        cfg: TrainerConfig,
        ranking: Optional[RankingMetrics] = None,
        loggers: Iterable = (),
        collect_auc_inputs: bool = True,
        mesh=None,
        corpus=None,
        u_bucket: Optional[int] = None,
    ):
        """``mesh``: this rank's ``parallel/mesh.py::Mesh`` (None: one
        device); ``state`` holds the full model, which the trainer cuts to
        the rank's shards.  ``corpus`` (the store's ``NewsFeatures``,
        numpy) and ``u_bucket``: global-row training (module doc)."""
        self.cfg = cfg
        self.mesh = mesh
        self.device = next(state.model.parameters()).device
        # a sharded run evaluates on a one-device copy of the model: every
        # rank's in single-node mode, rank 0's in multi-host mode
        self._eval_model = state.model
        self._eval_mesh = mesh if mesh is not None and mesh.replicated_batches else None
        if mesh is not None:
            from newsreclib_tpu_torch.parallel.mesh import place_state, shard_specs

            specs = shard_specs({n: tuple(p.shape) for n, p in state.model.named_parameters()},
                                mesh.model_axis, cfg.row_shard_embeddings, cfg.tp_transformer)
            if specs:  # the full model before it is cut to this rank's shards
                evaluates = mesh.rank == 0 or self._eval_mesh is not None
                self._eval_model = copy.deepcopy(state.model) if evaluates else None
            state = place_state(state, mesh, cfg.row_shard_embeddings, cfg.tp_transformer)
        self.state = state
        self.model = state.model
        self.loggers = list(loggers)
        self.ranking = ranking or RankingMetrics()
        self.loss_fn = loss_fn
        self.train_step = make_train_step(loss_fn, compute_dtype=cfg.compute_dtype,
                                          u_bucket=u_bucket)
        # the streaming eval takes the loss from loss_and_weight
        self.eval_step = make_eval_step(ranking=self.ranking,
                                        compute_dtype=cfg.compute_dtype)
        self.corpus = None if corpus is None else to_device(corpus, self.device)
        self.collect_auc_inputs = collect_auc_inputs
        self.ckpt = Checkpointer(cfg.ckpt_dir, mode=cfg.mode) if cfg.ckpt_dir else None
        self.global_step = 0
        self._cached_scorer = None
        if (cfg.cached_eval and self._eval_model is not None
                and hasattr(type(self.model), "encode_news")
                and hasattr(type(self.model), "score_with_vectors")):
            from newsreclib_tpu_torch.serving import CachedScorer

            self._cached_scorer = CachedScorer(
                self._eval_model, ranking=self.ranking, compute_dtype=cfg.compute_dtype,
                device=self.device, loss_fn=loss_fn, mesh=self._eval_mesh,
            )

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def _prepare(self, batch):
        """A host batch on this rank's device: a host-dedup batch cut to the
        rank's rows here; a global-row batch goes whole (the step densifies
        and cuts it)."""
        if self.mesh is not None and batch.news is not None:
            # several multi-host data ranks: a rank's dedup table is not the
            # global batch's
            if not self.mesh.replicated_batches and self.mesh.data_size > 1:
                raise ValueError(
                    "multi-host shard_batch requires global-row batches (news=None): use "
                    "TrainBatcher(global_rows=True) + Trainer(corpus=..., u_bucket=...)")
            from newsreclib_tpu_torch.parallel.mesh import shard_batch

            batch = shard_batch(batch, self.mesh)
        return to_device(batch, self.device)

    def _step(self, batch):
        if self.corpus is not None:
            return self.train_step(self.state, self._prepare(batch), self.corpus)
        return self.train_step(self.state, self._prepare(batch))

    def _full_state(self, with_opt: bool = True) -> Optional[Dict]:
        """The full state tree of a sharded state (a collective: every rank
        calls it), None otherwise; ``with_opt=False``: the parameters
        alone."""
        if not self.state.sharded:
            return None
        from newsreclib_tpu_torch.parallel.mesh import gather_state

        return gather_state(self.state, with_opt)

    # ---------- loops ----------

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def train_epoch(self, batcher: TrainBatcher, epoch: int) -> Dict[str, float]:
        t0 = time.time()
        n = 0
        losses: list = []
        pending: deque = deque()  # (step index, loss on the device)

        def drain(force: bool = False) -> None:
            # every step's loss is checked, each once the device has long
            # finished it, so the check never stalls the launch queue
            while pending and (force or len(pending) > self.cfg.async_check_depth):
                i, dl = pending.popleft()
                v = float(dl)
                if self.cfg.check_finite and not np.isfinite(v):
                    raise FloatingPointError(f"non-finite train loss at step {i}")
                losses.append(v)

        for i, batch in enumerate(batcher.epoch(epoch)):
            if self.cfg.limit_train_batches and i >= self.cfg.limit_train_batches:
                break
            self.state, metrics = self._step(batch)
            loss = metrics["loss"]
            pending.append((i, loss))
            n += 1
            drain()
            if (i + 1) % self.cfg.log_every_n_steps == 0 or i == 0:
                logged = {k: float(v) for k, v in metrics.items() if k != "loss"}
                logged["train/loss"] = float(loss)
                logged["epoch"] = epoch
                self._log(logged, self.global_step + i)
        drain(force=True)
        self.global_step += n
        dt = time.time() - t0
        return {
            "train/loss": float(np.mean(losses)) if losses else float("nan"),
            "train/steps_per_sec": n / max(dt, 1e-9),
            "train/impressions_per_sec": n * batcher.batch_size / max(dt, 1e-9),
        }

    def evaluate(self, batcher: EvalBatcher, prefix: str = "val") -> Dict[str, float]:
        """The metrics of ``batcher``'s impressions under ``prefix``, after
        every rank joined the gather of a sharded state: in single-node mode
        every rank scores its share and returns the same metrics; in
        multi-host mode rank 0 returns them and the other ranks {} (module
        doc)."""
        model = self.model
        if self.mesh is not None:
            tree = self._full_state(with_opt=False)  # before the rank gate: a collective
            if self._eval_mesh is None and self.rank != 0:
                return {}
            model = self._eval_model
            if tree is not None:
                model.load_state_dict(tree["params"])
        # the cached path unless the batches are limited (debug configs must
        # see the limit honoured) or the model cannot split
        if (self._cached_scorer is not None and not self.cfg.limit_eval_batches
                and isinstance(batcher, EvalBatcher)):
            metrics = self._cached_scorer.evaluate(
                batcher.store, batcher.imp,
                max_history_len=batcher.max_history_len,
                target_cells=batcher.target_cells,
                collect_auc=self.collect_auc_inputs,
            )
            return {f"{prefix}/{k}": v for k, v in metrics.items()}

        mesh = self._eval_mesh
        stream = StreamingEval(collect_auc=self.collect_auc_inputs)
        for i, batch in enumerate(batcher):
            if self.cfg.limit_eval_batches and i >= self.cfg.limit_eval_batches:
                break
            if mesh is not None:
                from newsreclib_tpu_torch.parallel.mesh import shard_batch

                batch = shard_batch(batch, mesh)
            batch = to_device(batch, self.device)
            scores, per_imp, valid, _ = self.eval_step(SimpleNamespace(model=model), batch)
            loss = weight = None
            if self.loss_fn is not None:
                loss, weight = loss_and_weight(self.loss_fn, scores, batch.labels,
                                               batch.cand_mask, valid, mesh)
            stream.update(
                scores, per_imp, valid,
                batch.labels if self.collect_auc_inputs else None,
                batch.cand_mask if self.collect_auc_inputs else None,
                loss, weight,
            )
        return {f"{prefix}/{k}": v for k, v in stream.finalize(mesh).items()}

    def fit(self, train_batcher: TrainBatcher, val_batcher: Optional[EvalBatcher] = None,
            resume: bool = False) -> Dict[str, float]:
        """Train up to ``max_epochs``, stopping after ``patience`` epochs
        without improvement of ``val/<monitor>`` (of ``train/loss`` without a
        val set).  ``resume=True`` restores the 'last' checkpoint (parameters,
        optimizer state, epoch, best metric) and goes on from the next epoch."""
        best = None
        bad_epochs = 0
        start_epoch = 0
        if self.cfg.overfit_batches:
            batches = []
            for i, b in enumerate(train_batcher.epoch(0)):
                if i >= self.cfg.overfit_batches:
                    break
                batches.append(b)
            train_batcher = _ReplayBatcher(batches, train_batcher.batch_size)
        if resume and self.ckpt and self.ckpt.has("last"):
            self.state = self.ckpt.restore(self.state, "last")
            meta = self.ckpt.meta("last")
            start_epoch = int(meta.get("epoch", -1)) + 1
            self.global_step = int(meta.get("step", 0))
            best = self.ckpt.best_metric
            log.info("resumed from last checkpoint: epoch %d, step %d, best %s",
                     start_epoch, self.global_step, best)
        history: Dict[str, float] = {}
        for epoch in range(start_epoch, self.cfg.max_epochs):
            t0 = time.time()
            train_metrics = self.train_epoch(train_batcher, epoch)
            t1 = time.time()
            metrics = dict(train_metrics)
            if val_batcher is not None:
                val_metrics = self.evaluate(val_batcher, "val")
                metrics.update(val_metrics)
                monitored = val_metrics.get(f"val/{self.cfg.monitor}")
            else:
                monitored = train_metrics["train/loss"]
            tree = self._full_state() if self.ckpt else None  # a collective
            log.info("epoch %d: %.3f s training, %.3f s validation", epoch, t1 - t0,
                     time.time() - t1)
            self._log(metrics, self.global_step)
            history = metrics
            if self.ckpt and self.rank == 0:  # rank 0 alone writes the full state
                self.ckpt.save(self.state, self.global_step, metric=monitored,
                               extra={"epoch": epoch}, tree=tree)
            if self.mesh is not None:
                # every rank decides on rank 0's value, once rank 0 has saved
                from newsreclib_tpu_torch.parallel.collectives import broadcast_value

                monitored = broadcast_value(monitored, self.device)
            improved = best is None or (
                monitored < best if self.cfg.mode == "min" else monitored > best
            )
            if improved:
                best = monitored
                bad_epochs = 0
            else:
                bad_epochs += 1
                if bad_epochs >= self.cfg.patience:
                    log.info("early stopping at epoch %d (best %s=%.5f)", epoch,
                             self.cfg.monitor, best)
                    break
        history["best_" + self.cfg.monitor] = best if best is not None else float("nan")
        return history

    def test(self, test_batcher: EvalBatcher, restore_best: bool = True) -> Dict[str, float]:
        if restore_best and self.ckpt and self.ckpt.has("best"):
            self.state = self.ckpt.restore(self.state, "best")
        t0 = time.time()
        metrics = self.evaluate(test_batcher, "test")
        log.info("test: %.3f s", time.time() - t0)
        self._log(metrics, self.global_step)
        return metrics
