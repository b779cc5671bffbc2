"""Dropout from an explicit random generator (counterpart of flax
``nn.Dropout``, which draws from the ``dropout`` rng the step passes in).

The keep-mask is drawn with ``torch.rand`` from the ``torch.Generator`` the
caller hands over, on the tensor's device (a CUDA generator on the card), so
that a train step is reproducible from its seed and step number and never
touches torch's global random state.  Kept values are scaled by
1 / (1 - rate), as flax does.

Ranks that hold parts of one tensor draw its whole mask and keep their part
(``part``), as the JAX package's mesh draws one replicated key's masks over
the global arrays: every rank draws from a generator in the same state, so
the ranks' masks are one device's.  A data-parallel train step opens
``global_batch_rows``; inside it the modules over batch rows
(``Dropout(rate, over_rows=True)``) draw over the global batch and keep the
rank's block of rows.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

# (data size, data index) while a data-parallel train step runs
_batch_rows: Optional[Tuple[int, int]] = None


@contextmanager
def global_batch_rows(size: int, index: int) -> Iterator[None]:
    """Within it, the tensors over batch rows are block ``index`` of ``size``
    equal blocks of the global batch's (rows in rank order)."""
    global _batch_rows
    prev, _batch_rows = _batch_rows, (size, index)
    try:
        yield
    finally:
        _batch_rows = prev


def batch_rows_part() -> Optional[Tuple[int, int, int]]:
    """``part`` of a tensor over batch rows (leading dimension) in the
    current step: None outside a data-parallel step."""
    return None if _batch_rows is None else (0, *_batch_rows)


def keep_mask(shape: Sequence[int], keep_prob: float, generator: torch.Generator,
              device, part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """A boolean mask of ``shape``, each element True with probability
    ``keep_prob``.  ``part=(dim, size, index)``: the tensor is block
    ``index`` of ``size`` equal blocks along ``dim`` of a whole tensor; the
    whole mask is drawn and the block kept."""
    if part is None:
        return torch.rand(tuple(shape), generator=generator, device=device) < keep_prob
    dim, size, index = part
    whole = list(shape)
    n = whole[dim]
    whole[dim] = n * size
    draw = torch.rand(tuple(whole), generator=generator, device=device)
    return draw.narrow(dim, index * n, n) < keep_prob


def dropout(x: torch.Tensor, rate: float, deterministic: bool = True,
            generator: Optional[torch.Generator] = None,
            part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """``x`` unchanged when ``deterministic`` or ``rate`` is 0 (no generator
    is touched); else each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate).  ``part``: ``keep_mask``'s."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a generator")
    keep_prob = 1.0 - rate
    keep = keep_mask(x.shape, keep_prob, generator, x.device, part)
    return torch.where(keep, x / keep_prob, 0.0)


class Dropout(nn.Module):
    """``over_rows``: the inputs' leading dimension is the batch's rows (or
    the rows times a fixed number of slots, row-major), so a data-parallel
    step draws over the global batch (module doc)."""

    def __init__(self, rate: float, over_rows: bool = False):
        super().__init__()
        self.rate = rate
        self.over_rows = over_rows

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        part = batch_rows_part() if self.over_rows else None
        return dropout(x, self.rate, deterministic, generator, part)
