"""Device choice for the port's entry points.

Entry points take an explicit ``device`` whose default is ``"cuda"``.  When
no card is present they raise rather than run on the CPU unasked; the CPU is
used only when the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
