"""Masked GRU over left-aligned padded sequences (counterpart of
``newsreclib_tpu/models/components/rnn.py:20-61``).

The cell is flax's ``nn.GRUCell``, not ``torch.nn.GRU`` (whose reset gate
multiplies ``W_hn h + b_hn`` the same way but which keeps two biases per
gate and initialises otherwise):

    r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h)),
    n = tanh(in(x) + r * hn(h)),  h' = (1 - z) * n + z * h,

with biases on ``ir``, ``iz``, ``in`` and ``hn`` only, lecun-normal input
kernels and orthogonal recurrent ones.  The carry advances only at valid
steps, so the final carry is the last valid step's hidden state.  The
submodule and layer names are flax's (``GRUCell_0``, ``ir`` ... ``hn``), so
``convert.flax_to_state_dict`` maps the JAX parameters as they are.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from newsreclib_tpu_torch.models.components.linear import Dense, orthogonal


class GRUCell(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, Dense(input_dim, hidden_dim, generator))
        for name in ("hr", "hz", "hn"):
            layer = Dense(hidden_dim, hidden_dim, generator, use_bias=name == "hn")
            with torch.no_grad():
                layer.weight.copy_(orthogonal((hidden_dim, hidden_dim), generator))
            self.add_module(name, layer)

    def _stacked(self, names):
        """The layers ``names`` as one (3 H, in) weight and (3 H,) bias."""
        layers = [self._modules[n] for n in names]
        bias = [l.bias if l.bias is not None else torch.zeros_like(l.weight[:, 0])
                for l in layers]
        return torch.cat([l.weight for l in layers]), torch.cat(bias)

    def input_projections(self, x: torch.Tensor) -> torch.Tensor:
        """``ir(x)``, ``iz(x)``, ``in(x)`` of every step at once: (..., 3 H)."""
        return F.linear(x, *self._stacked(("ir", "iz", "in")))

    def recurrent(self):
        """``hr``, ``hz``, ``hn`` as one layer, for ``step``."""
        return self._stacked(("hr", "hz", "hn"))

    def step(self, xp: torch.Tensor, h: torch.Tensor, recurrent) -> torch.Tensor:
        """One step from the step's input projections ``xp`` (B, 3 H): the
        three recurrent products are one (the step runs 50 times a forward,
        so its kernel count sets MINS's step time on the card)."""
        hp = F.linear(h, *recurrent)
        rz = torch.sigmoid(xp[:, :2 * h.shape[1]] + hp[:, :2 * h.shape[1]])
        r, z = rz.chunk(2, dim=1)
        n = torch.tanh(xp[:, 2 * h.shape[1]:] + r * hp[:, 2 * h.shape[1]:])
        return (1.0 - z) * n + z * h


class MaskedGRU(nn.Module):
    """GRU returning the last valid hidden state: x (B, T, D), mask (B, T)
    (True = valid, left-aligned), init_h optional (B, H) -> (B, H).  A
    Python loop over the T <= 50 steps."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.GRUCell_0 = GRUCell(input_dim, hidden_dim, generator)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                init_h: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, t = x.shape[:2]
        h = x.new_zeros((b, self.hidden_dim)) if init_h is None else init_h
        xp = self.GRUCell_0.input_projections(x)  # (B, T, 3 H)
        recurrent = self.GRUCell_0.recurrent()
        for i in range(t):
            new_h = self.GRUCell_0.step(xp[:, i], h, recurrent)
            h = new_h if mask is None else torch.where(mask[:, i, None], new_h, h)
        return h
