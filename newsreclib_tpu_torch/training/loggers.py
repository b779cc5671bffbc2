"""Metric loggers (counterpart of ``newsreclib_tpu/training/loggers.py``):
``metrics.csv`` with one row per logged step and a header that grows with
new metric names, ``hparams.json`` beside it, the stdout logger, and
TensorBoard (raises where the tensorboard package is missing) and
Weights & Biases (a logged no-op without the wandb package, as the JAX
package's).
"""

from __future__ import annotations

import csv
import logging
import os
import time
from typing import Dict, List, Optional

log = logging.getLogger("newsreclib_tpu_torch")


class CSVLogger:
    def __init__(self, out_dir: str, filename: str = "metrics.csv"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._fieldnames: List[str] = []
        if os.path.exists(self.path):  # resume: adopt the existing header
            with open(self.path) as f:
                header = f.readline().strip()
            if header:
                self._fieldnames = header.split(",")

    def log_hparams(self, hparams: Dict) -> None:
        """Persist the composed hyperparameters next to the metrics (the
        reference pushes cfg + param counts to every logger,
        ``utils/logging_utils.py:10-54``)."""
        import json

        with open(os.path.join(os.path.dirname(self.path), "hparams.json"), "w") as f:
            json.dump(hparams, f, indent=2, default=str)

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        row = {"step": step, "time": round(time.time(), 3), **metrics}
        new_fields = [k for k in row if k not in self._fieldnames]
        if new_fields or not os.path.exists(self.path):
            self._fieldnames += [k for k in new_fields]
            rows = []
            if os.path.exists(self.path):
                with open(self.path) as f:
                    rows = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fieldnames)
                w.writeheader()
                for r in rows:
                    w.writerow(r)
                w.writerow(row)
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fieldnames).writerow(row)


class StdoutLogger:
    def log_hparams(self, hparams: Dict) -> None:
        log.info("hparams: %s", {k: v for k, v in hparams.items() if k != "cfg"})

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        parts = " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(metrics.items())
        )
        log.info("step %d: %s", step, parts)


class TensorBoardLogger:
    def __init__(self, out_dir: str):
        from torch.utils.tensorboard import SummaryWriter  # needs the tensorboard package

        self._writer = SummaryWriter(log_dir=out_dir)

    def log_hparams(self, hparams: Dict) -> None:
        import json

        self._writer.add_text("hparams", json.dumps(hparams, indent=2, default=str))

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                self._writer.add_scalar(k, v, step)


class WandbLogger:
    """Import-guarded Weights & Biases adapter (reference
    ``configs/logger/many_loggers.yaml:3-6``, ``wandb.yaml``).

    Without the wandb package, construction degrades to a logged no-op
    instead of failing the run (the reference's
    task_wrapper likewise tolerates a missing/broken wandb by closing it
    only ``if wandb.run``, ``utils/utils.py:68-96``)."""

    def __init__(self, out_dir: str, project: str = "newsreclib_tpu_torch",
                 name: Optional[str] = None, offline: bool = True):
        self._run = None
        try:
            import wandb  # noqa: F401
        except ImportError:
            log.warning("wandb not installed; WandbLogger is a no-op")
            return
        os.makedirs(out_dir, exist_ok=True)
        self._run = wandb.init(
            project=project, name=name or os.path.basename(out_dir),
            dir=out_dir, mode="offline" if offline else "online",
        )

    def log_hparams(self, hparams: Dict) -> None:
        if self._run is not None:
            self._run.config.update(
                {k: v for k, v in hparams.items() if k != "cfg"},
                allow_val_change=True,
            )

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None


def make_loggers(out_dir: str, names) -> list:
    out = []
    for name in names:
        if name == "csv":
            out.append(CSVLogger(out_dir))
        elif name == "stdout":
            out.append(StdoutLogger())
        elif name == "tensorboard":
            out.append(TensorBoardLogger(os.path.join(out_dir, "tb")))
        elif name == "wandb":
            out.append(WandbLogger(os.path.join(out_dir, "wandb")))
        else:
            log.warning("unknown logger %r skipped", name)
    return out
