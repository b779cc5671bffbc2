"""Batch schemas of the port: NamedTuples of numpy arrays or tensors.

Counterpart of ``newsreclib_tpu/data/batch.py:28-90``, without JAX: the host
batchers fill these with numpy arrays, ``to_device`` turns every array into a
tensor on the model's device.

  * ``NewsFeatures`` holds the features of each unique news article of a
    batch (row 0 is the all-zero padding article).
  * ``RecBatch`` indexes into those rows with ``hist_idx (B, H)`` and
    ``cand_idx (B, C)`` plus boolean masks.  When ``news2`` is set, the
    unique table is split in two row segments (short titles at a narrow
    width, the long tail at full width); the indices address
    ``concat(rows(news), rows(news2))``.  A global-row batch (serving) has
    ``news=None`` and store rows in the index matrices.
  * ``NewsBatch`` holds articles and their aspect labels (MANNeR's
    A-module trains on it).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

Array = Any  # numpy array on the host, torch.Tensor on the device


class NewsFeatures(NamedTuple):
    """Features for U unique news articles (row 0 = padding article)."""

    title: Array  # (U, L_t) int32 token ids, 0 = pad
    title_mask: Array  # (U, L_t) bool
    abstract: Optional[Array] = None  # (U, L_a) int32
    abstract_mask: Optional[Array] = None  # (U, L_a) bool
    category: Optional[Array] = None  # (U,) int32, 0 = pad class
    subcategory: Optional[Array] = None  # (U,) int32
    sentiment: Optional[Array] = None  # (U,) int32 (0 pad, 1..S classes)
    sentiment_score: Optional[Array] = None  # (U,) float32 in [-1, 1]
    title_entities: Optional[Array] = None  # (U, L_te) int32
    title_entities_mask: Optional[Array] = None  # (U, L_te) bool
    abstract_entities: Optional[Array] = None  # (U, L_ae) int32
    abstract_entities_mask: Optional[Array] = None  # (U, L_ae) bool


class RecBatch(NamedTuple):
    """A dense, masked recommendation batch (see module doc)."""

    news: Optional[NewsFeatures]
    hist_idx: Array  # (B, H) int32 rows into news.*; 0 for padding
    hist_mask: Array  # (B, H) bool
    cand_idx: Array  # (B, C) int32
    cand_mask: Array  # (B, C) bool
    labels: Array  # (B, C) float32 {0, 1}; 0 on padded slots
    user_idx: Array  # (B,) int32
    impression_valid: Optional[Array] = None  # (B,) bool — row is real
    news2: Optional[NewsFeatures] = None  # long-title tail segment


class NewsBatch(NamedTuple):
    """A batch of articles with aspect labels, for A-module training."""

    news: NewsFeatures
    labels: Array  # (U,) int32 aspect class labels
    valid: Array  # (U,) bool


def _to_tensor(x, device: torch.device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def to_device(batch: Union[RecBatch, NewsFeatures, "NewsBatch"], device):
    """Every array of ``batch`` (and of its news segments) as a tensor on
    ``device``; dtypes are kept."""
    device = torch.device(device)
    fields = {}
    for name, value in batch._asdict().items():
        if isinstance(value, NewsFeatures):
            fields[name] = to_device(value, device)
        else:
            fields[name] = _to_tensor(value, device)
    return type(batch)(**fields)
