"""Parameter initialisers that match flax's defaults, drawn from an explicit
``torch.Generator`` on the CPU (so a seed gives the same weights on every
device), and the flax-initialised ``Dense`` layer.

flax ``nn.Dense`` initialises its kernel lecun-normal (a normal truncated at
two standard deviations, rescaled to variance 1 / fan_in) and its bias with
zeros; torch ``nn.Linear`` does neither.  The JAX kernel of shape (in, out)
is this layer's ``weight`` of shape (out, in) (see ``convert.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# std of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal(shape, fan_in: int, generator: Optional[torch.Generator]) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(
        torch.empty(shape), 0.0, std, -2 * std, 2 * std, generator=generator
    )


def normal(shape, std: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(shape).normal_(0.0, std, generator=generator)


def uniform(shape, low: float, high: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(shape).uniform_(low, high, generator=generator)


def orthogonal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """A random orthogonal matrix (flax ``initializers.orthogonal``'s
    distribution, not its numbers)."""
    return nn.init.orthogonal_(torch.empty(shape), generator=generator)


class Dense(nn.Module):
    """``y = x W^T + b`` with flax ``nn.Dense`` initialisation (``use_bias``
    False: no bias, as flax's ``use_bias=False``)."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((out_features, in_features), in_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)
