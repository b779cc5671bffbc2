"""Cached serving: encode every article of the corpus once per parameter
version into an ``(N+1, D)`` table on the device, then score impressions
with gathers, the user encoder and dot products, and reduce the ranking
metrics on the device (counterpart of ``newsreclib_tpu/serving.py:120-429``).

The model must expose ``encode_news(news)`` and
``score_with_vectors(batch, news_vecs)`` (NRMS does).  Differences from the
JAX package: the transfer-narrowing ``lean`` / ``hydrate`` wire format of its
remote TPU link is dropped, the ``lax.scan`` over stacked batches is a
Python loop over batches kept on the device, and ``GlobalEvalBatcher`` is
``data/batching.py::BucketedAssembler`` used directly.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.data.batching import BucketedAssembler, Impressions
from newsreclib_tpu_torch.data.news_store import NewsStore
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.metrics import functional as F
from newsreclib_tpu_torch.metrics.collector import RankingMetrics
from newsreclib_tpu_torch.models.base import mask_scores

# cached device copies per scorer: a run's val and test sets, corpus and batches
_CACHE_MAX_ENTRIES = 4
SPLIT_TITLE_LEN = 16  # title width of the short-title bucket of the corpus encode


def corpus_segments(store: NewsStore, split_title_len: Optional[int] = SPLIT_TITLE_LEN,
                    batch_size: int = 4096, margin: int = 0) -> List[Tuple[np.ndarray, int]]:
    """``[(rows, title_width), ...]``: the length-bucketed corpus encode.

    Rows whose title has at most ``split_title_len - margin`` tokens are
    encoded at width ``split_title_len``, the others at full width, when the
    short rows fill at least one chunk and a quarter of the corpus (the rule
    of ``newsreclib_tpu/serving.py:152,181-186``); otherwise all rows at full
    width.  Exact: pad tokens embed to hard zeros and are masked keys.
    ``margin`` is the model's ``TITLE_SPLIT_MARGIN``, the headroom its text
    encoder needs past the last token (0 for NRMS).
    """
    n, l_full = store.title.shape
    if split_title_len is not None and l_full > split_title_len:
        lens = (store.title != 0).sum(axis=1)
        short_rows = np.nonzero(lens <= split_title_len - margin)[0]
        long_rows = np.nonzero(lens > split_title_len - margin)[0]
        if len(short_rows) >= batch_size and len(short_rows) >= n // 4:
            parts = [(short_rows, split_title_len)]
            if len(long_rows):
                parts.append((long_rows, l_full))
            return parts
    return [(np.arange(n), l_full)]


def _corpus_on_device(store: NewsStore, batch_size: int, split_title_len: Optional[int],
                      margin: int, device: torch.device) -> list:
    """``[(rows, [title chunk, ...]), ...]``: the segments' title tokens on
    ``device`` in chunks of at most ``batch_size`` rows."""
    parts = []
    for rows, width in corpus_segments(store, split_title_len, batch_size, margin):
        title = torch.from_numpy(np.ascontiguousarray(store.title[rows, :width])).to(device)
        parts.append((torch.from_numpy(rows).to(device), title.split(batch_size)))
    return parts


def _encode_corpus(model, n_rows: int, parts: list, dtype: Optional[torch.dtype]) -> torch.Tensor:
    table = None
    for rows, chunks in parts:
        vecs = torch.cat([model.encode_news(NewsFeatures(title=t, title_mask=t != 0))
                          for t in chunks])
        if table is None:
            table = torch.zeros((n_rows, vecs.shape[-1]), dtype=dtype or vecs.dtype,
                                device=vecs.device)
        table[rows] = vecs.to(table.dtype)
    table[0] = 0.0
    return table


def _split_margin(model) -> int:
    return getattr(model, "TITLE_SPLIT_MARGIN", 0)


@torch.inference_mode()
def build_news_vector_table(
    model,
    store: NewsStore,
    batch_size: int = 4096,
    dtype: Optional[torch.dtype] = None,
    split_title_len: Optional[int] = SPLIT_TITLE_LEN,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Encode the whole corpus once -> ``(N+1, D)`` table on ``device``,
    rows in store order, row 0 (padding) zero, in ``dtype`` (default: the
    encoder's output type).

    ``model`` must already lie on ``device``.  Short and long titles are
    encoded in separate chunks of at most ``batch_size`` rows (see
    ``corpus_segments``, with the model's ``TITLE_SPLIT_MARGIN``) and
    scattered back into row order.
    """
    parts = _corpus_on_device(store, batch_size, split_title_len, _split_margin(model),
                              resolve_device(device))
    return _encode_corpus(model, store.title.shape[0], parts, dtype)


class CachedScorer:
    """Epoch-level cached evaluation: build the vector table once, then
    stream global-row batches through gather + score + metrics on the device
    and fetch the epoch's sums once at the end.

    ``compute_dtype`` (e.g. ``"bfloat16"``): parameters and the news-vector
    table in that type, metrics in float32, as the JAX scorer's.
    ``split_title_len``: the width of the short-title bucket of the corpus
    encode, or None for one bucket at full width (``corpus_segments``).
    """

    def __init__(self, model, ranking: Optional[RankingMetrics] = None,
                 compute_dtype: Optional[Union[str, torch.dtype]] = None,
                 device: Union[str, torch.device] = "cuda",
                 split_title_len: Optional[int] = SPLIT_TITLE_LEN):
        self.device = resolve_device(device)
        self.model = model
        self.ranking = ranking or RankingMetrics()
        self.split_title_len = split_title_len
        if isinstance(compute_dtype, str):
            compute_dtype = getattr(torch, compute_dtype)
        self.compute_dtype = compute_dtype
        # device copies of corpus tokens and of batched impressions, which do
        # not change with the parameters: key -> (source object, value)
        self._cache: Dict[tuple, tuple] = {}

    def _cached(self, key: tuple, source, make):
        hit = self._cache.get(key)
        if hit is None or hit[0] is not source:
            while len(self._cache) >= _CACHE_MAX_ENTRIES:
                self._cache.pop(next(iter(self._cache)))
            hit = self._cache[key] = (source, make())
        return hit[1]

    def _on_device(self, arr: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        return None if arr is None else torch.from_numpy(arr).to(self.device)

    def _serving_model(self):
        """The model in eval mode, cast to ``compute_dtype`` if one is set."""
        model = self.model
        if self.compute_dtype is not None and any(
            p.dtype != self.compute_dtype for p in model.parameters() if p.is_floating_point()
        ):
            model = copy.deepcopy(model).to(self.compute_dtype)
        return model

    @torch.inference_mode()
    def evaluate(self, store: NewsStore, impressions: Impressions, max_history_len: int = 50,
                 target_cells: int = 16384, encode_batch: int = 4096,
                 collect_auc: bool = True) -> Dict[str, float]:
        model = self._serving_model()
        was_training = model.training
        model.eval()
        try:
            split, margin = self.split_title_len, _split_margin(model)
            parts, categ, sent = self._cached(
                ("corpus", id(store), encode_batch, split, margin), store, lambda: (
                    _corpus_on_device(store, encode_batch, split, margin, self.device),
                    self._on_device(store.category), self._on_device(store.sentiment),
                ),
            )
            table = _encode_corpus(model, store.title.shape[0], parts, self.compute_dtype)
            return self._run(model, impressions, table, categ, sent, max_history_len,
                             target_cells, collect_auc)
        finally:
            model.train(was_training)

    def _batches(self, impressions: Impressions, max_history_len: int,
                 target_cells: int) -> List[RecBatch]:
        return self._cached(
            ("batches", id(impressions), max_history_len, target_cells), impressions,
            lambda: [to_device(b, self.device)
                     for b in BucketedAssembler(impressions, max_history_len, target_cells)],
        )

    def _run(self, model, impressions, table, categ, sent, max_history_len,
             target_cells, collect_auc) -> Dict[str, float]:
        names = self.ranking.metric_names(categ is not None, sent is not None)
        sums = torch.zeros(len(names), dtype=torch.float32, device=self.device)
        count = torch.zeros((), dtype=torch.float32, device=self.device)
        auc_parts = []
        for b in self._batches(impressions, max_history_len, target_cells):
            scores = model.score_with_vectors(b, table).float()
            scores = mask_scores(scores, b.cand_mask)
            kwargs = {}
            if categ is not None:
                kwargs["cand_categories"] = categ[b.cand_idx]
                kwargs["hist_categories"] = categ[b.hist_idx]
            if sent is not None:
                kwargs["cand_sentiments"] = sent[b.cand_idx]
                kwargs["hist_sentiments"] = sent[b.hist_idx]
            if kwargs:
                kwargs["hist_mask"] = b.hist_mask
            per_imp = self.ranking.per_impression(scores, b.labels, b.cand_mask, **kwargs)
            v = b.impression_valid.float()
            sums += torch.stack([per_imp[k] for k in names]) @ v
            count += v.sum()
            if collect_auc:
                w = (b.cand_mask & b.impression_valid[:, None]).float()
                auc_parts.append((scores.reshape(-1), (b.labels * w).reshape(-1), w.reshape(-1)))
        fetch = [count.reshape(1), sums]
        if auc_parts:
            fetch.append(F.binary_auc_weighted(
                *(torch.cat([p[i] for p in auc_parts]) for i in range(3))
            ).reshape(1))
        vals = torch.cat(fetch).cpu().numpy().astype(np.float64)  # one device sync
        n = max(float(vals[0]), 1.0)
        out = {k: float(vals[1 + i]) / n for i, k in enumerate(names)}
        if auc_parts:
            out["auc"] = float(vals[-1])
        return out
