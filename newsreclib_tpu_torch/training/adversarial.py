"""The adversarial (two-optimizer) training loop of SentiDebias (counterpart
of ``newsreclib_tpu/training/adversarial.py``): it drives
``make_sentidebias_train_step`` over the train batches and reuses the
standard ``Trainer`` on the generator for validation, test and the
generator's best / last checkpoints.  The discriminator has its own 'last'
checkpoint under ``<ckpt_dir>/disc``, so a resume restores both networks
and both optimizer states.

``mesh``: single-node data parallelism (``newsreclib_tpu/training/
adversarial.py:39-54``): both networks are placed on the grid, each rank
trains on its rows of the global batch, and each network sums its own
gradients over the data group; evaluation, the broadcast of the monitored
value and the checkpoints follow ``Trainer``'s multi-rank rules.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from newsreclib_tpu_torch.data.batching import EvalBatcher, TrainBatcher
from newsreclib_tpu_torch.metrics.collector import RankingMetrics
from newsreclib_tpu_torch.models.fair_rec.senti_debias import (
    SentiDebiasState,
    make_sentidebias_train_step,
)
from newsreclib_tpu_torch.training.checkpoint import Checkpointer
from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

log = logging.getLogger("newsreclib_tpu_torch")


class AdversarialTrainer:
    """``fit`` / ``test`` as ``Trainer``'s, over a ``SentiDebiasState``;
    ``loss_fn`` is the evaluation's loss (``val/loss``)."""

    def __init__(self, state: SentiDebiasState, loss_fn, cfg: TrainerConfig,
                 alpha: float = 0.15, beta: float = 10.0,
                 ranking: Optional[RankingMetrics] = None, loggers=(), mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.step_fn = make_sentidebias_train_step(alpha, beta, cfg.compute_dtype)
        # the standard trainer over the generator places it on the mesh
        self._eval_trainer = Trainer(state.g, loss_fn, cfg, ranking=ranking, loggers=loggers,
                                     mesh=mesh)
        if mesh is not None:
            from newsreclib_tpu_torch.parallel.mesh import place_state

            place_state(state.d, mesh, cfg.row_shard_embeddings)
        self.state = state
        self.device = self._eval_trainer.device
        self.loggers = list(loggers)
        self.global_step = 0
        self._d_ckpt = Checkpointer(os.path.join(cfg.ckpt_dir, "disc")) if cfg.ckpt_dir else None

    def _log(self, metrics: Dict[str, float], step: int) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step)

    def fit(self, train_batcher: TrainBatcher, val_batcher: Optional[EvalBatcher] = None,
            resume: bool = False) -> Dict[str, float]:
        """Alternating G / D steps for up to ``max_epochs``, every step's
        G and D losses checked finite (a few steps late, never stalling the
        launch queue); early stopping on ``val/<monitor>`` (the mean G loss
        without a val set); G's checkpoints through the standard trainer,
        D's 'last' beside them."""
        best = None
        bad = 0
        start_epoch = 0
        ckpt = self._eval_trainer.ckpt
        if resume and ckpt and ckpt.has("last"):
            ckpt.restore(self.state.g, "last")
            if self._d_ckpt and self._d_ckpt.has("last"):
                self._d_ckpt.restore(self.state.d, "last")
            meta = ckpt.meta("last")
            start_epoch = int(meta.get("epoch", -1)) + 1
            self.global_step = int(meta.get("step", 0))
            best = ckpt.best_metric
            log.info("resumed adversarial training: epoch %d, step %d", start_epoch,
                     self.global_step)
        history: Dict[str, float] = {}
        for epoch in range(start_epoch, self.cfg.max_epochs):
            t0 = time.time()
            g_losses, d_losses = [], []
            pending: deque = deque()

            def drain(force: bool = False) -> None:
                while pending and (force or len(pending) > self.cfg.async_check_depth):
                    j, dg, dd = pending.popleft()
                    g, d = float(dg), float(dd)
                    if self.cfg.check_finite and not (np.isfinite(g) and np.isfinite(d)):
                        raise FloatingPointError(
                            f"non-finite adversarial loss at step {j} (g={g}, d={d})")
                    g_losses.append(g)
                    d_losses.append(d)

            for i, batch in enumerate(train_batcher.epoch(epoch)):
                if self.cfg.limit_train_batches and i >= self.cfg.limit_train_batches:
                    break
                self.state, metrics = self.step_fn(self.state,
                                                   self._eval_trainer._prepare(batch))
                self.global_step += 1
                pending.append((i, metrics["g_loss"], metrics["d_loss"]))
                drain()
                if (i + 1) % self.cfg.log_every_n_steps == 0 or i == 0:
                    self._log({"train/g_loss": float(metrics["g_loss"]),
                               "train/d_loss": float(metrics["d_loss"]), "epoch": epoch},
                              self.global_step)
            drain(force=True)
            metrics = {
                "train/g_loss": float(np.mean(g_losses)) if g_losses else float("nan"),
                "train/d_loss": float(np.mean(d_losses)) if d_losses else float("nan"),
            }
            monitored = metrics["train/g_loss"]
            t1 = time.time()
            if val_batcher is not None:
                val_metrics = self._eval_trainer.evaluate(val_batcher, "val")
                metrics.update(val_metrics)
                monitored = val_metrics.get(f"val/{self.cfg.monitor}", monitored)
            log.info("epoch %d: %.3f s training, %.3f s validation", epoch, t1 - t0,
                     time.time() - t1)
            self._log(metrics, self.global_step)
            history = metrics
            if ckpt:
                trees = [None, None]
                if self.mesh is not None:  # collectives: every rank gathers
                    from newsreclib_tpu_torch.parallel.mesh import gather_state

                    trees = [gather_state(s) if s.sharded else None
                             for s in (self.state.g, self.state.d)]
                if self._eval_trainer.rank == 0:
                    ckpt.save(self.state.g, self.global_step, metric=monitored,
                              extra={"epoch": epoch}, tree=trees[0])
                    if self._d_ckpt:
                        self._d_ckpt.save(self.state.d, self.global_step, tree=trees[1])
            if self.mesh is not None:
                from newsreclib_tpu_torch.parallel.collectives import broadcast_value

                monitored = broadcast_value(monitored, self.device)
            improved = best is None or (
                monitored < best if self.cfg.mode == "min" else monitored > best)
            if improved:
                best, bad = monitored, 0
            else:
                bad += 1
                if bad >= self.cfg.patience:
                    log.info("early stopping at epoch %d", epoch)
                    break
        history["best_" + self.cfg.monitor] = best if best is not None else float("nan")
        return history

    def test(self, test_batcher: EvalBatcher, restore_best: bool = True) -> Dict[str, float]:
        """The generator's bias-free test metrics, from its best checkpoint."""
        return self._eval_trainer.test(test_batcher, restore_best=restore_best)
