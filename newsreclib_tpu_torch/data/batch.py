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
    ``concat(rows(news), rows(news2))``.  A global-row batch (serving, and
    multi-rank training) has ``news=None`` and store rows in the index
    matrices; ``densify`` dedups one on the device.
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


def densify(batch: RecBatch, corpus: NewsFeatures, u_bucket: int):
    """On-device dedup of a global-row batch (``newsreclib_tpu/data/batch.py:92-142``):
    ``batch`` carries ``news=None`` and corpus rows in ``hist_idx`` /
    ``cand_idx``; the rows (with 0 first) map to a unique table of
    ``u_bucket`` rows in ascending order, 0-filled past the unique count
    (``jnp.unique(..., size=u_bucket, fill_value=0)``), whose features are
    gathered from ``corpus`` (tensors on the device), and the indices are
    remapped.  Static shapes and no host synchronisation: the dedup is a
    sort, a cumulative sum and a scatter.  Returns ``(batch, overflow)``,
    ``overflow`` a device bool set when the unique count exceeds
    ``u_bucket`` (callers poison the loss with NaN)."""
    hist = batch.hist_idx.to(torch.int64)
    cand = batch.cand_idx.to(torch.int64)
    b, h = hist.shape
    c = cand.shape[1]
    rows = torch.cat([hist.new_zeros(1), hist.reshape(-1), cand.reshape(-1)])
    srt, perm = torch.sort(rows, stable=True)
    first = torch.ones_like(srt, dtype=torch.bool)
    first[1:] = srt[1:] != srt[:-1]
    rank = torch.cumsum(first.to(torch.int64), 0) - 1
    overflow = rank[-1] + 1 > u_bucket
    # past the bucket (an overflow, whose loss is NaN) indices stay in range,
    # as JAX's gathers clamp them
    rank = rank.clamp(max=u_bucket - 1)
    inv = torch.empty_like(rank).scatter_(0, perm, rank)
    unique = srt.new_zeros(u_bucket).scatter_(0, rank, srt)
    news = NewsFeatures(*(None if t is None else t.index_select(0, unique) for t in corpus))
    return batch._replace(
        news=news,
        hist_idx=inv[1:1 + b * h].reshape(b, h).to(torch.int32),
        cand_idx=inv[1 + b * h:].reshape(b, c).to(torch.int32),
        hist_mask=batch.hist_mask if batch.hist_mask is not None else hist != 0,
        cand_mask=batch.cand_mask if batch.cand_mask is not None else cand != 0,
        labels=None if batch.labels is None else batch.labels.float(),
    ), overflow
