"""Cached serving: encode every article of the corpus once per parameter
version into an ``(N+1, D)`` table on the device, then score impressions
with gathers, the user encoder and dot products, and reduce the ranking
metrics on the device (counterpart of ``newsreclib_tpu/serving.py:120-511``);
``CachedScorer.export_recommendations`` writes every user's candidate
scores as JSON (the CLI's ``save_recs``).

The model must expose ``encode_news(news)`` and
``score_with_vectors(batch, news_vecs)`` (NRMS, MINS, CenNewsRec and CAUM
do); the corpus encode hands it every field of the store.  Differences from the
JAX package: the transfer-narrowing ``lean`` / ``hydrate`` wire format of its
remote TPU link is dropped, the ``lax.scan`` over stacked batches is a
Python loop over batches kept on the device, and ``GlobalEvalBatcher`` is
``data/batching.py::BucketedAssembler`` used directly.

``mesh`` (a ``parallel/mesh.py::Mesh``; every rank of it calls the same
methods): the work is split over the data ranks as the JAX package splits
it over its mesh's ``data`` axis.  Each data rank encodes its piece of
every corpus chunk (``corpus_pieces``) and the rows are all-gathered into
the whole table on every rank; each rank scores its contiguous rows of
every impression batch (batches rounded to a multiple of the data ranks);
the epoch's metric sums go into one all-reduce and the AUC is computed on
every rank from the gathered ``(scores, labels, weights)``; the export
gathers ``(position, row, score)`` and rank 0 writes the JSON.  Ranks that
share a data index (``model_axis`` > 1) score the same share with the whole
model, and every collective runs over the data group.
"""

from __future__ import annotations

import copy
import json
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.data.batching import BucketedAssembler, Impressions
from newsreclib_tpu_torch.data.news_store import NewsStore
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.metrics import functional as F
from newsreclib_tpu_torch.metrics.collector import (
    RankingMetrics,
    loss_and_weight,
    reduce_over_data,
)
from newsreclib_tpu_torch.models.base import mask_scores

# cached device copies per scorer: a run's val and test sets, corpus and batches
_CACHE_MAX_ENTRIES = 4
SPLIT_TITLE_LEN = 16  # title width of the short-title bucket of the corpus encode
TARGET_CELLS = 16384  # cells per impression batch: evaluate's default, export_recommendations'


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


def corpus_pieces(n: int, batch_size: int, size: int = 1,
                  index: int = 0) -> List[Tuple[int, int]]:
    """``[(lo, hi), ...]``: the non-empty row ranges of a segment of ``n``
    rows that data rank ``index`` of ``size`` encodes, one encode call each.
    The segment is cut into chunks of ``batch_size`` rows (rounded up to a
    multiple of ``size``) and each chunk into ``size`` equal pieces, cut at
    the segment's end, so a rank may have a piece fewer than another: the
    JAX package's ``P(None, "data")`` over its stacked chunks
    (``newsreclib_tpu/serving.py:148-151,189-197``) without its padding
    rows.  ``size`` 1: the chunks themselves."""
    bs = -(-batch_size // size) * size
    per = bs // size
    out = []
    for start in range(0, n, bs):
        lo = start + index * per
        hi = min(lo + per, n)
        if lo < hi:
            out.append((lo, hi))
    return out


def _data_share(mesh) -> Tuple[int, int]:
    return (1, 0) if mesh is None else (mesh.data_size, mesh.data_index)


def _corpus_on_device(store: NewsStore, batch_size: int, split_title_len: Optional[int],
                      margin: int, device: torch.device, mesh=None) -> tuple:
    """``(chunks, rows)``: ``chunks`` is ``[NewsFeatures, ...]``, this data
    rank's rows of the store (``features_for``: every field the store has,
    title and its mask cut to the segment's width, as
    ``newsreclib_tpu/serving.py:160-170``) on ``device``, one chunk per
    ``corpus_pieces`` range of each segment; ``rows`` the store rows of every
    rank's chunks in rank order (one rank: its own), the order of the
    gathered encode, on ``device``."""
    size, index = _data_share(mesh)
    batch_size = -(-batch_size // size) * size
    chunks, order = [], [[] for _ in range(size)]
    for rows, width in corpus_segments(store, split_title_len, batch_size, margin):
        for r in range(size):
            order[r] += [rows[lo:hi] for lo, hi in corpus_pieces(len(rows), batch_size, size, r)]
        pieces = corpus_pieces(len(rows), batch_size, size, index)
        if not pieces:
            continue
        feats = store.features_for(np.concatenate([rows[lo:hi] for lo, hi in pieces]))
        feats = to_device(feats._replace(title=feats.title[:, :width],
                                         title_mask=feats.title_mask[:, :width]), device)
        at = 0
        for lo, hi in pieces:
            chunks.append(NewsFeatures(*(None if v is None else v[at:at + hi - lo]
                                         for v in feats)))
            at += hi - lo
    rows = np.concatenate([r for o in order for r in o]).astype(np.int64)
    return chunks, torch.from_numpy(rows).to(device)


def _encode_corpus(model, n_rows: int, chunks: list, rows: torch.Tensor,
                   dtype: Optional[torch.dtype], mesh=None) -> torch.Tensor:
    """The ``(n_rows, D)`` table: this data rank's ``chunks`` encoded, with a
    ``mesh`` every rank's vectors all-gathered (``gather_table``), scattered
    once to ``rows``; row 0 zero."""
    vecs = [model.encode_news(news).reshape(-1) for news in chunks]
    flat = (torch.cat(vecs) if vecs else
            torch.zeros(0, dtype=dtype or torch.float32, device=rows.device))
    if mesh is not None:
        from newsreclib_tpu_torch.parallel.collectives import all_gather_varlen

        flat = torch.cat(all_gather_varlen(flat, mesh.data_group, mesh.data_size,
                                           mesh.data_index, "gather_table"))
    d = flat.numel() // max(rows.numel(), 1)
    table = torch.zeros((n_rows, d), dtype=dtype or flat.dtype, device=rows.device)
    table[rows] = flat.view(-1, d).to(table.dtype)
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
    mesh=None,
) -> torch.Tensor:
    """Encode the whole corpus once -> ``(N+1, D)`` table on ``device``,
    rows in store order, row 0 (padding) zero, in ``dtype`` (default: the
    encoder's output type).

    ``model`` must already lie on ``device``.  Short and long titles are
    encoded in separate chunks of at most ``batch_size`` rows (see
    ``corpus_segments``, with the model's ``TITLE_SPLIT_MARGIN``) and
    scattered back into row order.  ``mesh``: each data rank encodes its
    pieces of the chunks and every rank gets the whole table (module doc).
    """
    chunks, rows = _corpus_on_device(store, batch_size, split_title_len, _split_margin(model),
                                     resolve_device(device), mesh)
    return _encode_corpus(model, store.title.shape[0], chunks, rows, dtype, mesh)


class CachedScorer:
    """Epoch-level cached evaluation: build the vector table once, then
    stream global-row batches through gather + score + metrics on the device
    and fetch the epoch's sums once at the end.

    ``compute_dtype`` (e.g. ``"bfloat16"``): parameters and the news-vector
    table in that type, metrics in float32, as the JAX scorer's.
    ``split_title_len``: the width of the short-title bucket of the corpus
    encode, or None for one bucket at full width (``corpus_segments``).
    ``loss_fn(scores, labels, cand_mask, valid)``: when given, the metrics
    carry ``loss``, the batches' losses weighted by their valid impressions.
    ``mesh``: the work split over the data ranks (module doc); every rank
    returns the same metrics.
    """

    def __init__(self, model, ranking: Optional[RankingMetrics] = None,
                 compute_dtype: Optional[Union[str, torch.dtype]] = None,
                 device: Union[str, torch.device] = "cuda",
                 split_title_len: Optional[int] = SPLIT_TITLE_LEN,
                 loss_fn: Optional[Callable] = None, mesh=None):
        self.device = resolve_device(device)
        self.model = model
        self.ranking = ranking or RankingMetrics()
        self.loss_fn = loss_fn
        self.split_title_len = split_title_len
        self.mesh = mesh
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

    def _assembler(self, impressions: Impressions, max_history_len: int,
                   target_cells: int) -> BucketedAssembler:
        return BucketedAssembler(impressions, max_history_len, target_cells,
                                 batch_multiple=_data_share(self.mesh)[0])

    def _rows(self, batch: RecBatch) -> RecBatch:
        """This data rank's rows of a global batch (all of them on one device)."""
        if self.mesh is None:
            return batch
        from newsreclib_tpu_torch.parallel.mesh import shard_batch

        return shard_batch(batch, self.mesh)

    @torch.inference_mode()
    def evaluate(self, store: NewsStore, impressions: Impressions, max_history_len: int = 50,
                 target_cells: int = TARGET_CELLS, encode_batch: int = 4096,
                 collect_auc: bool = True) -> Dict[str, float]:
        model = self._serving_model()
        was_training = model.training
        model.eval()
        try:
            split, margin = self.split_title_len, _split_margin(model)
            (chunks, rows), categ, sent = self._cached(
                ("corpus", id(store), encode_batch, split, margin), store, lambda: (
                    _corpus_on_device(store, encode_batch, split, margin, self.device, self.mesh),
                    self._on_device(store.category), self._on_device(store.sentiment),
                ),
            )
            table = _encode_corpus(model, store.title.shape[0], chunks, rows,
                                   self.compute_dtype, self.mesh)
            return self._run(model, impressions, table, categ, sent, max_history_len,
                             target_cells, collect_auc)
        finally:
            model.train(was_training)

    def _batches(self, impressions: Impressions, max_history_len: int,
                 target_cells: int) -> List[RecBatch]:
        return self._cached(
            ("batches", id(impressions), max_history_len, target_cells), impressions,
            lambda: [to_device(self._rows(b), self.device)
                     for b in self._assembler(impressions, max_history_len, target_cells)],
        )

    def _run(self, model, impressions, table, categ, sent, max_history_len,
             target_cells, collect_auc) -> Dict[str, float]:
        names = self.ranking.metric_names(categ is not None, sent is not None)
        sums = torch.zeros(len(names), dtype=torch.float32, device=self.device)
        count = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_acc = torch.zeros(2, dtype=torch.float32, device=self.device)  # sum, weight
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
            if self.loss_fn is not None:
                # weighted by the valid impressions: the loss_fn is a mean over them
                loss, nv = loss_and_weight(self.loss_fn, scores, b.labels, b.cand_mask,
                                           b.impression_valid, self.mesh)
                loss_acc += torch.stack([loss * nv, nv])
            if collect_auc:
                w = (b.cand_mask & b.impression_valid[:, None]).float()
                auc_parts.append((scores.reshape(-1), (b.labels * w).reshape(-1), w.reshape(-1)))
        totals = torch.cat([count.reshape(1), sums, loss_acc])
        auc_inputs = [torch.cat([p[i] for p in auc_parts]) for i in range(3)] if auc_parts else []
        if self.mesh is not None:
            totals, auc_inputs = reduce_over_data(self.mesh, totals, auc_inputs)
        fetch = [totals]
        if auc_inputs:
            fetch.append(F.binary_auc_weighted(*auc_inputs).reshape(1))
        vals = torch.cat(fetch).cpu().numpy().astype(np.float64)  # one device sync
        n = max(float(vals[0]), 1.0)
        out = {k: float(vals[1 + i]) / n for i, k in enumerate(names)}
        loss_sum, loss_w = vals[1 + len(names):3 + len(names)]
        if self.loss_fn is not None and loss_w > 0:
            out["loss"] = float(loss_sum) / float(loss_w)
        if auc_inputs:
            out["auc"] = float(vals[-1])
        return out

    @torch.inference_mode()
    def export_recommendations(self, store: NewsStore, impressions: Impressions, fpath: str,
                               max_history_len: int = 50, encode_batch: int = 4096
                               ) -> Dict[str, Dict[str, float]]:
        """Every impression's candidate scores as JSON,
        ``{"U<id>": {"N<id>": score}}`` (``user_ids``, else ``user_idx``;
        a later impression of a user overwrites an earlier score of the same
        candidate), written to ``fpath`` and returned; scores in float32
        from the model in ``compute_dtype``.  Batches come from the
        ``BucketedAssembler`` in its bucket order, which tells the
        impression of each batch row (``newsreclib_tpu/serving.py:431-511``;
        reference ``abstract_recommender.py:159-193``).  With a ``mesh`` each
        data rank scores its rows of every batch, the ``(position, row,
        score)`` triples are gathered in the one-device order, every rank
        returns the same dict and rank 0 alone writes it."""
        model = self._serving_model()
        was_training = model.training
        model.eval()
        try:
            table = build_news_vector_table(model, store, encode_batch, self.compute_dtype,
                                            self.split_title_len, self.device, self.mesh)
            assembler = self._assembler(impressions, max_history_len, TARGET_CELLS)
            order = np.asarray([i for _, idxs in sorted(assembler.buckets.items())
                                for i in idxs], dtype=np.int64)
            all_pos, all_rows, all_scores = [], [], []
            cursor = 0
            for batch in assembler:
                n_valid = int(np.sum(batch.impression_valid))  # of the whole batch
                mine = self._rows(batch)
                lo = 0 if self.mesh is None else (
                    self.mesh.data_index * batch.hist_idx.shape[0] // self.mesh.data_size)
                scores = model.score_with_vectors(to_device(mine, self.device), table)
                scores = scores.float().cpu().numpy()
                k = min(max(n_valid - lo, 0), mine.hist_idx.shape[0])  # this rank's valid rows
                cand = mine.cand_idx[:k]
                valid = cand != 0  # (k, C)
                all_pos.append(np.repeat(cursor + lo + np.arange(k), valid.sum(axis=1)))
                all_rows.append(cand[valid])
                all_scores.append(scores[:k][valid])
                cursor += n_valid
        finally:
            model.train(was_training)
        pos = np.concatenate(all_pos) if all_pos else np.zeros(0, np.int64)
        rows = np.concatenate(all_rows) if all_rows else np.zeros(0, np.int32)
        svals = np.concatenate(all_scores) if all_scores else np.zeros(0, np.float32)
        if self.mesh is not None:
            pos, rows, svals = self._gather_recs(pos, rows, svals)
        uids = (impressions.user_ids if impressions.user_ids is not None
                else impressions.user_idx)[order[pos]]
        row2nid = {v: k for k, v in store.nid2row.items()}
        recs: Dict[str, Dict[str, float]] = {}
        for uid, r, v in zip(uids.tolist(), rows.tolist(), svals.tolist()):
            recs.setdefault(f"U{uid}", {})[str(row2nid.get(r, r))] = float(v)
        if self.mesh is None or self.mesh.rank == 0:
            with open(fpath, "w") as f:
                json.dump(recs, f)
        return recs

    def _gather_recs(self, pos, rows, svals):
        """Every data rank's ``(position, row, score)`` triples (one
        ``gather_recs``, as float64: exact for each), in the one-device
        order: by position, a rank's candidates of an impression in order."""
        from newsreclib_tpu_torch.parallel.collectives import all_gather_varlen

        mesh = self.mesh
        local = torch.from_numpy(np.stack([pos.astype(np.float64), rows.astype(np.float64),
                                           svals.astype(np.float64)]).reshape(-1))
        every = all_gather_varlen(local.to(self.device), mesh.data_group, mesh.data_size,
                                  mesh.data_index, "gather_recs")
        triples = np.concatenate([t.cpu().numpy().reshape(3, -1) for t in every], axis=1)
        keep = np.argsort(triples[0], kind="stable")
        return (triples[0, keep].astype(np.int64), triples[1, keep].astype(np.int32),
                triples[2, keep].astype(np.float32))

