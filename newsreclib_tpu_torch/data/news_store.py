"""Dense tokenized news store (counterpart of
``newsreclib_tpu/data/news_store.py``).

Fixed-shape int32 numpy arrays built once (row 0 = padding article); a batch
is a gather of rows.  ``save`` / ``load`` use the JAX package's files (a
compressed ``.npz`` of the arrays and ``<path>.nids.json``), so either
package reads the other's cache.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence

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

    @property
    def num_news(self) -> int:
        return self.title.shape[0] - 1

    def rows(self, nids: Sequence[str]) -> np.ndarray:
        """The store rows of ``nids`` (0 for an unknown id)."""
        return np.asarray([self.nid2row.get(n, 0) for n in nids], dtype=np.int32)

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

    def trim_titles(self, margin: int = 0, multiple: int = 8) -> "NewsStore":
        """The store with its title and abstract matrices cut to the longest
        one's token count (plus ``margin``) rounded up to ``multiple``.
        Exact: pad tokens embed to zeros and are masked keys."""

        def width(arr, extra):
            lens = (arr != 0).sum(axis=1)
            need = (int(lens.max()) if arr.shape[0] else 0) + extra
            w = max(multiple, -(-need // multiple) * multiple)
            return min(w, arr.shape[1])

        t_w = width(self.title, margin)
        a_w = None if self.abstract is None else width(self.abstract, 0)
        if t_w == self.title.shape[1] and (a_w is None or a_w == self.abstract.shape[1]):
            return self
        return replace(
            self,
            title=self.title[:, :t_w],
            abstract=None if self.abstract is None else self.abstract[:, :a_w],
        )

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {k: v for k, v in self.__dict__.items() if isinstance(v, np.ndarray)}
        np.savez_compressed(path, **arrays)
        with open(path + ".nids.json", "w") as f:
            json.dump(self.nid2row, f)

    @classmethod
    def load(cls, path: str) -> "NewsStore":
        path = path if path.endswith(".npz") else path + ".npz"
        data = dict(np.load(path))
        with open(path + ".nids.json") as f:
            nid2row = json.load(f)
        return cls(nid2row=nid2row, **data)


def pad_token_lists(lists: List[List[int]], max_len: int) -> np.ndarray:
    out = np.zeros((len(lists), max_len), dtype=np.int32)
    for i, toks in enumerate(lists):
        n = min(len(toks), max_len)
        out[i, :n] = toks[:n]
    return out


def build_news_store(
    nids: List[str],
    tokenized_titles: List[List[int]],
    max_title_len: int,
    tokenized_abstracts: Optional[List[List[int]]] = None,
    max_abstract_len: int = 50,
    categories: Optional[List[int]] = None,
    subcategories: Optional[List[int]] = None,
    sentiments: Optional[List[int]] = None,
    sentiment_scores: Optional[List[float]] = None,
    title_entities: Optional[List[List[int]]] = None,
    abstract_entities: Optional[List[List[int]]] = None,
    max_entities: int = 10,
) -> NewsStore:
    """A NewsStore with a zero padding row at index 0."""
    nid2row = {nid: i + 1 for i, nid in enumerate(nids)}

    def with_pad_row(arr):
        return np.concatenate([np.zeros((1,) + arr.shape[1:], dtype=arr.dtype), arr], axis=0)

    def vec(values, dtype):
        return None if values is None else with_pad_row(np.asarray(values, dtype=dtype))

    def padded(lists, width):
        return None if lists is None else with_pad_row(pad_token_lists(lists, width))

    return NewsStore(
        nid2row=nid2row,
        title=with_pad_row(pad_token_lists(tokenized_titles, max_title_len)),
        abstract=padded(tokenized_abstracts, max_abstract_len),
        category=vec(categories, np.int32),
        subcategory=vec(subcategories, np.int32),
        sentiment=vec(sentiments, np.int32),
        sentiment_score=vec(sentiment_scores, np.float32),
        title_entities=padded(title_entities, max_entities),
        abstract_entities=padded(abstract_entities, max_entities),
    )
