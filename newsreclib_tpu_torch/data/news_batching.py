"""News-level batching for MANNeR's A-module (counterpart of
``newsreclib_tpu/data/news_batching.py``): every batch holds ``m`` articles
of each of ``batch_size / m`` classes drawn at random, the sampling
SupCon needs to always have positives (pytorch-metric-learning's
``MPerClassSampler``).  The draws are the JAX package's, from
``np.random.default_rng((seed, epoch))``, so for a store and a seed both
yield the same rows batch for batch.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from newsreclib_tpu_torch.data.batch import NewsBatch
from newsreclib_tpu_torch.data.news_store import NewsStore


class MPerClassNewsBatcher:
    """Batches of ``m_per_class`` articles per class; ``aspect``
    ("category" or "sentiment") names the store's label field.  Articles of
    class 0 (the pad class) are left out."""

    def __init__(self, store: NewsStore, aspect: str = "category", batch_size: int = 64,
                 m_per_class: int = 4, seed: int = 0, rows: Optional[np.ndarray] = None):
        if batch_size % m_per_class:
            raise ValueError(f"batch_size {batch_size} is not a multiple of m_per_class "
                             f"{m_per_class}")
        self.store = store
        self.aspect = aspect
        self.batch_size = batch_size
        self.m = m_per_class
        self.seed = seed
        labels_all = getattr(store, aspect)
        rows = np.arange(1, store.title.shape[0], dtype=np.int32) if rows is None else rows
        labels = labels_all[rows]
        keep = labels > 0
        self.rows = rows[keep]
        self.labels = labels[keep]
        self.classes = np.unique(self.labels)
        self.by_class = {c: self.rows[self.labels == c] for c in self.classes}

    def __len__(self) -> int:
        return max(1, len(self.rows) // self.batch_size)

    def epoch(self, epoch_idx: int = 0) -> Iterator[NewsBatch]:
        rng = np.random.default_rng((self.seed, epoch_idx))
        classes_per_batch = self.batch_size // self.m
        for _ in range(len(self)):
            cls = rng.choice(self.classes, size=classes_per_batch,
                             replace=len(self.classes) < classes_per_batch)
            rows = np.concatenate([
                rng.choice(self.by_class[c], size=self.m, replace=len(self.by_class[c]) < self.m)
                for c in cls]).astype(np.int32)
            news = self.store.features_for(rows)
            labels = getattr(self.store, self.aspect)[rows].astype(np.int32)
            yield NewsBatch(news=news, labels=labels, valid=rows != 0)
