"""Train state: the model with its float32 master parameters, Adam, the
learning-rate schedule and a dropout seed (counterpart of
``newsreclib_tpu/training/state.py``).

``make_optimizer`` gives the update rule of the JAX package's optax chain,
step for step:

* the learning rate at update ``t`` (counted from 0) is optax's schedule
  at ``t``: ``warmup_cosine_decay_schedule(0, lr, warmup,
  max(total, warmup + 1))`` or ``linear_schedule(0, lr, max(warmup, 1))``,
  so with a warmup the first update has learning rate 0;
* the global-norm clip is optax's ``clip_by_global_norm``:
  ``g * min(1, c / ||g||)``, with no epsilon
  (``torch.nn.utils.clip_grad_norm_`` divides by ``||g|| + 1e-6``);
* Adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root) as
  ``optax.adam``; with weight decay, AdamW, whose ``p * (1 - lr * wd)``
  before the Adam step equals optax's ``- lr * (adam + wd * p)``;
* parameters labelled ``"freeze"`` get no update and no weight decay
  (``optax.set_to_zero``) and do not enter the clip's norm; ``build`` also
  turns their ``requires_grad`` off, so autograd spends nothing on them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Mapping, Optional

import numpy as np
import torch
from torch import nn


@dataclass
class Optimizer:
    """The update rule ``make_optimizer`` describes; ``build`` makes the
    torch optimizer over a model's trainable parameters and ``update``
    applies one step."""

    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    scheduler: Optional[str] = None  # None, "cosine" or "linear_warmup"
    warmup_steps: int = 0
    total_steps: int = 0
    grad_clip_norm: Optional[float] = None
    freeze_labels: Optional[Mapping[str, str]] = None  # parameter name -> "train" / "freeze"

    def lr(self, step: int) -> float:
        """The learning rate of update ``step`` (0 for the first)."""
        peak = self.learning_rate
        if self.scheduler == "cosine":
            warmup = self.warmup_steps
            if step < warmup:
                return peak * step / warmup
            decay = max(self.total_steps, warmup + 1) - warmup
            t = min(step - warmup, decay)
            return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))
        if self.scheduler == "linear_warmup":
            warmup = max(self.warmup_steps, 1)
            return peak * min(step, warmup) / warmup
        if self.scheduler is not None:
            raise ValueError(f"unknown scheduler {self.scheduler!r}")
        return peak

    def trainable(self, model: nn.Module) -> List[torch.nn.Parameter]:
        """The parameters the optimizer updates, in ``named_parameters`` order."""
        labels = self.freeze_labels
        out = []
        for name, p in model.named_parameters():
            label = "train" if labels is None else labels[name]
            if label not in ("train", "freeze"):
                raise ValueError(f"label {label!r} of {name} is neither 'train' nor 'freeze'")
            if label == "train":
                out.append(p)
        return out

    def build(self, model: nn.Module) -> torch.optim.Optimizer:
        params = self.trainable(model)
        if self.freeze_labels is not None:
            train = {id(p) for p in params}
            for p in model.parameters():
                p.requires_grad_(id(p) in train)
        # one fused kernel per step on the card; the reference loop on the CPU
        fused = bool(params) and params[0].is_cuda
        kw = dict(lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8, fused=fused or None)
        if self.weight_decay:
            return torch.optim.AdamW(params, weight_decay=self.weight_decay, **kw)
        return torch.optim.Adam(params, **kw)

    def update(self, opt: torch.optim.Optimizer, step: int) -> None:
        """Clip the gradients, set the learning rate of update ``step`` and
        step; no host synchronisation."""
        params = [p for g in opt.param_groups for p in g["params"]]
        grads = [p.grad for p in params if p.grad is not None]
        if self.grad_clip_norm and grads:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            torch._foreach_mul_(grads, (self.grad_clip_norm / norm).clamp(max=1.0))
        for g in opt.param_groups:
            g["lr"] = self.lr(step)
        opt.step()


def make_optimizer(learning_rate: float = 1e-4, weight_decay: float = 0.0,
                   scheduler: Optional[str] = None, warmup_steps: int = 0,
                   total_steps: int = 0, grad_clip_norm: Optional[float] = None,
                   freeze_labels: Optional[Mapping[str, str]] = None) -> Optimizer:
    """Adam (the reference default, ``configs/model/nrms.yaml``) with an
    optional cosine or linear-warmup schedule, gradient clipping and
    parameter freezing; see the module doc for the rule."""
    return Optimizer(learning_rate, weight_decay, scheduler, warmup_steps, total_steps,
                     grad_clip_norm, None if freeze_labels is None else dict(freeze_labels))


@dataclass
class TrainState:
    """The model (its parameters are the float32 masters), the update rule
    and its torch optimizer, the number of updates taken and the dropout
    seed.  Dropout of update ``step`` draws from ``generator`` reseeded
    with ``(dropout_seed, step)`` (the JAX ``fold_in(dropout_rng, step)``)."""

    model: nn.Module
    tx: Optimizer
    opt: torch.optim.Optimizer
    dropout_seed: int
    generator: torch.Generator
    step: int = 0

    def dropout_generator(self) -> torch.Generator:
        """The generator of this step's dropout, reseeded from (seed, step)
        mixed into 64 bits (the CPU generator keeps only the low 32)."""
        mixed = np.random.SeedSequence((self.dropout_seed, self.step)).generate_state(1, np.uint64)
        return self.generator.manual_seed(int(mixed[0]))

    def apply_gradients(self) -> None:
        self.tx.update(self.opt, self.step)
        self.opt.zero_grad(set_to_none=True)
        self.step += 1


def create_train_state(model: nn.Module, optimizer: Optimizer,
                       dropout_seed: int = 0) -> TrainState:
    """The train state of ``model`` as it stands (the port's models draw
    their initial parameters when built), with a dropout generator on the
    model's device."""
    device = next(model.parameters()).device
    return TrainState(model=model, tx=optimizer, opt=optimizer.build(model),
                      dropout_seed=dropout_seed, generator=torch.Generator(device=device))


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
