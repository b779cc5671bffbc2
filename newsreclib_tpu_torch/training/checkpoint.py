"""Best and last checkpoints with ``torch.save`` (counterpart of
``newsreclib_tpu/training/checkpoint.py``, which uses orbax).

``<dir>/last.pt`` is written at every save and ``<dir>/best.pt`` when the
monitored metric improves (lower for ``mode="min"``, higher for ``"max"``).
Each holds the model's parameters, the optimizer's state and the step.
``last.json`` / ``best.json`` hold the loop's bookkeeping (step, metric,
epoch), as in the JAX package.

A sharded multi-rank run (``parallel/mesh.py``) writes the full state in
the same format: the trainer gathers it on every rank (a collective) and
rank 0 alone passes it to ``save`` as ``tree``; ``restore`` cuts a full
checkpoint back to the shards of a sharded state, so the port's one-device
``eval`` and a resumed run of either kind read the same files.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch


class Checkpointer:
    def __init__(self, directory: str, mode: str = "min"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.mode = mode
        self.best_metric: Optional[float] = None
        self.best_step: Optional[int] = None
        meta = self.meta("best")
        if meta:
            self.best_metric = meta.get("metric")
            self.best_step = meta.get("step")

    def _path(self, which: str) -> str:
        return os.path.join(self.directory, f"{which}.pt")

    def _write_json(self, which: str, meta: Dict[str, Any]) -> None:
        with open(os.path.join(self.directory, f"{which}.json"), "w") as f:
            json.dump(meta, f)

    def _save_tree(self, tree: Dict[str, Any], which: str) -> None:
        tmp = self._path(which) + ".tmp"
        torch.save(tree, tmp)
        os.replace(tmp, self._path(which))

    def save(self, state, step: int, metric: Optional[float] = None,
             extra: Optional[Dict[str, Any]] = None,
             tree: Optional[Dict[str, Any]] = None) -> bool:
        """Save 'last'; also 'best' when ``metric`` improves on the best so
        far.  Returns True if this became the best checkpoint.  ``tree``:
        the state to write when it is not ``state``'s own (the gathered full
        state of a sharded run, ``parallel/mesh.py::gather_state``)."""
        if tree is None:
            tree = {"params": state.model.state_dict(), "opt_state": state.opt.state_dict(),
                    "step": state.step}
        self._save_tree(tree, "last")
        self._write_json("last", {"step": step, "metric": metric, **(extra or {})})
        is_best = metric is not None and (
            self.best_metric is None
            or (metric < self.best_metric if self.mode == "min" else metric > self.best_metric)
        )
        if is_best:
            self._save_tree(tree, "best")
            self.best_metric = float(metric)
            self.best_step = step
            self._write_json("best", {"metric": self.best_metric, "step": step, **(extra or {})})
        return bool(is_best)

    def restore(self, state, which: str = "best"):
        """Load the parameters, optimizer state and step of ``which`` into
        ``state`` (in place; returned); a sharded state gets its shards."""
        device = next(state.model.parameters()).device
        tree = torch.load(self._path(which), map_location=device, weights_only=True)
        if getattr(state, "sharded", None):
            from newsreclib_tpu_torch.parallel.mesh import load_full_state

            load_full_state(state, tree)
            return state
        state.model.load_state_dict(tree["params"])
        state.opt.load_state_dict(tree["opt_state"])
        state.step = int(tree["step"])
        return state

    def restore_params(self, which: str = "best") -> Dict[str, torch.Tensor]:
        """The parameters of ``which`` alone, as a state dict on the CPU,
        without a train state to restore into (the optimizer a model was
        trained with need not be known): what evaluation loads with
        ``model.load_state_dict``."""
        path = self._path(which)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no {which!r} checkpoint in {self.directory}")
        return torch.load(path, map_location="cpu", weights_only=True)["params"]

    def has(self, which: str = "best") -> bool:
        return os.path.exists(self._path(which))

    def meta(self, which: str = "last") -> Dict[str, Any]:
        """The bookkeeping saved with ``which`` (epoch, global step, metric),
        what ``Trainer.fit(resume=True)`` needs; {} if there is none."""
        p = os.path.join(self.directory, f"{which}.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)
