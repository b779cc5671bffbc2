"""Console-script entry points of the port (counterpart of
``newsreclib_tpu/cli.py``): ``newsreclib-torch-train``,
``newsreclib-torch-eval`` and ``newsreclib-torch-sweep`` run the ``main`` of
the port's ``train``, ``eval`` and ``sweep`` modules with the command line's
overrides, on the card unless given ``platform=cpu``.

The port's entry points are modules of the package, so the scripts import
them by module path and work from any directory.  Under a launcher
(torchrun, or ``python -m newsreclib_tpu_torch.parallel.launch``) each
rank's entry point takes ``cuda:<LOCAL_RANK>`` (``train.py::select_device``).
"""

from __future__ import annotations

import importlib

COMMANDS = {"train_command": "newsreclib_tpu_torch.train",
            "eval_command": "newsreclib_tpu_torch.eval",
            "sweep_command": "newsreclib_tpu_torch.sweep"}


def _run(module_name: str) -> None:
    importlib.import_module(module_name).main()


def train_command() -> None:
    _run(COMMANDS["train_command"])


def eval_command() -> None:
    _run(COMMANDS["eval_command"])


def sweep_command() -> None:
    _run(COMMANDS["sweep_command"])
