"""Dropout from an explicit random generator (counterpart of flax
``nn.Dropout``, which draws from the ``dropout`` rng the step passes in).

The keep-mask is drawn with ``torch.rand`` from the ``torch.Generator`` the
caller hands over, on the tensor's device (a CUDA generator on the card), so
that a train step is reproducible from its seed and step number and never
touches torch's global random state.  Kept values are scaled by
1 / (1 - rate), as flax does.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def dropout(x: torch.Tensor, rate: float, deterministic: bool = True,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``x`` unchanged when ``deterministic`` or ``rate`` is 0 (no generator
    is touched); else each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate)."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a generator")
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, 0.0)


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, deterministic, generator)
