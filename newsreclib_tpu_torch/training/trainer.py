"""Training loop: epochs, validation, early stopping, checkpoints (counterpart
of ``newsreclib_tpu/training/trainer.py``), on one device.

Fit-time evaluation uses the cached serving path (``serving.CachedScorer``:
encode the corpus once per parameter version, then gather and score)
whenever the model has ``encode_news`` / ``score_with_vectors`` and
``limit_eval_batches`` is unset; otherwise it streams ``EvalBatcher``
batches through the eval step (``StreamingEval``).  The JAX package's mesh,
multi-host and global-row branches are not ported (ROADMAP queue 1, "Multi-GPU")
and raise if asked for.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np

from newsreclib_tpu_torch.data.batch import to_device
from newsreclib_tpu_torch.data.batching import EvalBatcher, TrainBatcher
from newsreclib_tpu_torch.metrics.collector import RankingMetrics, StreamingEval
from newsreclib_tpu_torch.training.checkpoint import Checkpointer
from newsreclib_tpu_torch.training.state import TrainState
from newsreclib_tpu_torch.training.steps import make_eval_step, make_train_step

log = logging.getLogger("newsreclib_tpu_torch")

_MULTI_DEVICE = ('is not ported yet (ROADMAP queue 1, "Multi-GPU"); the port trains on one '
                 "device")


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
        if mesh is not None:
            raise NotImplementedError(f"training over a device mesh {_MULTI_DEVICE}")
        if corpus is not None or u_bucket is not None:
            raise NotImplementedError(f"global-row training {_MULTI_DEVICE}")
        self.cfg = cfg
        self.state = state
        self.model = state.model
        self.device = next(state.model.parameters()).device
        self.loggers = list(loggers)
        self.ranking = ranking or RankingMetrics()
        self.train_step = make_train_step(loss_fn, compute_dtype=cfg.compute_dtype)
        self.eval_step = make_eval_step(loss_fn=loss_fn, ranking=self.ranking,
                                        compute_dtype=cfg.compute_dtype)
        self.collect_auc_inputs = collect_auc_inputs
        self.ckpt = Checkpointer(cfg.ckpt_dir, mode=cfg.mode) if cfg.ckpt_dir else None
        self.global_step = 0
        self._cached_scorer = None
        if (cfg.cached_eval and hasattr(type(self.model), "encode_news")
                and hasattr(type(self.model), "score_with_vectors")):
            from newsreclib_tpu_torch.serving import CachedScorer

            self._cached_scorer = CachedScorer(
                self.model, ranking=self.ranking, compute_dtype=cfg.compute_dtype,
                device=self.device, loss_fn=loss_fn,
            )

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
            self.state, metrics = self.train_step(self.state, to_device(batch, self.device))
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

        stream = StreamingEval(collect_auc=self.collect_auc_inputs)
        for i, batch in enumerate(batcher):
            if self.cfg.limit_eval_batches and i >= self.cfg.limit_eval_batches:
                break
            batch = to_device(batch, self.device)
            scores, per_imp, valid, loss = self.eval_step(self.state, batch)
            stream.update(
                scores, per_imp, valid,
                batch.labels if self.collect_auc_inputs else None,
                batch.cand_mask if self.collect_auc_inputs else None,
                loss,
            )
        return {f"{prefix}/{k}": v for k, v in stream.finalize().items()}

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
            log.info("epoch %d: %.3f s training, %.3f s validation", epoch, t1 - t0,
                     time.time() - t1)
            self._log(metrics, self.global_step)
            history = metrics
            improved = best is None or (
                monitored < best if self.cfg.mode == "min" else monitored > best
            )
            if self.ckpt:
                self.ckpt.save(self.state, self.global_step, metric=monitored,
                               extra={"epoch": epoch})
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
