"""Dense tokenized news store (counterpart of
``newsreclib_tpu/data/news_store.py:23-67``).

Fixed-shape int32 numpy arrays built once (row 0 = padding article); a batch
is a gather of rows.  Saving and loading are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from newsreclib_tpu_torch.data.batch import NewsFeatures


@dataclass
class NewsStore:
    nid2row: Dict[str, int]  # news id -> row (1-based; 0 is padding)
    title: np.ndarray  # (N+1, Lt) int32
    abstract: Optional[np.ndarray] = None  # (N+1, La)
    category: Optional[np.ndarray] = None  # (N+1,)
    subcategory: Optional[np.ndarray] = None
    sentiment: Optional[np.ndarray] = None
    sentiment_score: Optional[np.ndarray] = None
    title_entities: Optional[np.ndarray] = None  # (N+1, Le)
    abstract_entities: Optional[np.ndarray] = None

    def features_for(self, rows: np.ndarray) -> NewsFeatures:
        """Gather a NewsFeatures table for the given row ids."""

        def take(arr):
            return None if arr is None else arr[rows]

        def mask(arr):
            return None if arr is None else arr[rows] != 0

        title = self.title[rows]
        return NewsFeatures(
            title=title,
            title_mask=title != 0,
            abstract=take(self.abstract),
            abstract_mask=mask(self.abstract),
            category=take(self.category),
            subcategory=take(self.subcategory),
            sentiment=take(self.sentiment),
            sentiment_score=take(self.sentiment_score),
            title_entities=take(self.title_entities),
            title_entities_mask=mask(self.title_entities),
            abstract_entities=take(self.abstract_entities),
            abstract_entities_mask=mask(self.abstract_entities),
        )
