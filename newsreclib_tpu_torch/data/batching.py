"""Host-side batching with static shapes (counterpart of
``newsreclib_tpu/data/batching.py``), plain numpy, batch for batch equal to
the JAX package's at the same seed.

* Training (``TrainBatcher``): one sample per positive, 1 positive + K
  sampled negatives, shuffled per epoch; histories truncated to the first
  ``max_history_len`` clicks.
* Eval (``EvalBatcher``, and ``BucketedAssembler`` in global-row mode for
  cached serving): impressions bucketed by candidate count into powers of
  two; partial batches padded with invalid rows.
* Dedup (``_dedup``): each batch carries a unique-news table (row 0 =
  padding), its size rounded up to a power-of-two bucket, and index
  matrices into it; ``split_news_by_length`` splits the table into a
  short-title and a full-width segment.

Not ported: the multi-host global-row training mode (``global_rows``,
``num_steps``, ``global_u_bucket``), ``batch_multiple`` of sharded eval and
the ``lean`` wire format of the JAX package's remote TPU link.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from newsreclib_tpu_torch.data.batch import RecBatch
from newsreclib_tpu_torch.data.news_store import NewsStore


def next_bucket(n: int, minimum: int = 128) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class Impressions:
    """CSR impression storage (news referenced by store row id)."""

    hist_flat: np.ndarray  # int32
    hist_offsets: np.ndarray  # (N+1,) int64
    cand_flat: np.ndarray  # int32
    cand_offsets: np.ndarray  # (N+1,)
    labels_flat: np.ndarray  # int8
    user_idx: np.ndarray  # (N,) int32
    user_ids: Optional[np.ndarray] = None  # raw uid strings/ints for exports

    def __len__(self) -> int:
        return len(self.user_idx)

    def hist(self, i: int) -> np.ndarray:
        return self.hist_flat[self.hist_offsets[i] : self.hist_offsets[i + 1]]

    def cands(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.cand_offsets[i], self.cand_offsets[i + 1]
        return self.cand_flat[s:e], self.labels_flat[s:e]

    @classmethod
    def from_lists(
        cls,
        histories: Sequence[Sequence[int]],
        candidates: Sequence[Sequence[int]],
        labels: Sequence[Sequence[int]],
        user_idx: Sequence[int],
        user_ids=None,
    ) -> "Impressions":
        def csr(lists, dtype):
            offsets = np.zeros(len(lists) + 1, dtype=np.int64)
            np.cumsum([len(x) for x in lists], out=offsets[1:])
            if not len(lists):
                return np.zeros(0, dtype=dtype), offsets
            flat = np.concatenate([np.asarray(x, dtype=dtype) for x in lists])
            return flat.astype(dtype), offsets

        hist_flat, hist_off = csr(histories, np.int32)
        cand_flat, cand_off = csr(candidates, np.int32)
        labels_flat, _ = csr(labels, np.int8)
        return cls(
            hist_flat, hist_off, cand_flat, cand_off, labels_flat,
            np.asarray(user_idx, dtype=np.int32),
            None if user_ids is None else np.asarray(user_ids),
        )

    @classmethod
    def from_padded(
        cls,
        hist_rows: np.ndarray,  # (N, caph) int32, 0-padded
        hist_lens: np.ndarray,
        cand_rows: np.ndarray,  # (N, capc)
        cand_labels: np.ndarray,
        cand_lens: np.ndarray,
        user_idx: np.ndarray,
        user_ids=None,
    ) -> "Impressions":
        """CSR storage from padded rows and their lengths."""
        n, caph = hist_rows.shape
        capc = cand_rows.shape[1]
        hist_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(hist_lens, out=hist_off[1:])
        cand_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(cand_lens, out=cand_off[1:])
        hmask = np.arange(caph)[None, :] < hist_lens[:, None]
        cmask = np.arange(capc)[None, :] < cand_lens[:, None]
        return cls(
            hist_rows[hmask].astype(np.int32), hist_off,
            cand_rows[cmask].astype(np.int32), cand_off,
            cand_labels[cmask].astype(np.int8),
            np.asarray(user_idx, dtype=np.int32),
            None if user_ids is None else np.asarray(user_ids),
        )

    def subset(self, n: int) -> "Impressions":
        """The first ``n`` impressions."""
        h_end, c_end = self.hist_offsets[n], self.cand_offsets[n]
        return Impressions(
            self.hist_flat[:h_end], self.hist_offsets[: n + 1],
            self.cand_flat[:c_end], self.cand_offsets[: n + 1],
            self.labels_flat[:c_end], self.user_idx[:n],
            None if self.user_ids is None else self.user_ids[:n],
        )

    def padded_history(self, max_len: int) -> np.ndarray:
        """(N, max_len) histories, truncated to the first ``max_len`` clicks."""
        n = len(self)
        lens = np.minimum(np.diff(self.hist_offsets), max_len)
        out = np.zeros((n, max_len), dtype=np.int32)
        pos = np.arange(max_len)[None, :]
        take = pos < lens[:, None]
        out[take] = self.hist_flat[(self.hist_offsets[:-1, None] + pos)[take]]
        return out

    def padded_candidates(self, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
        """(N, max_len) candidates and float32 labels, truncated and padded."""
        n = len(self)
        lens = np.minimum(np.diff(self.cand_offsets), max_len)
        cands = np.zeros((n, max_len), dtype=np.int32)
        labels = np.zeros((n, max_len), dtype=np.float32)
        pos = np.arange(max_len)[None, :]
        take = pos < lens[:, None]
        flat_idx = (self.cand_offsets[:-1, None] + pos)[take]
        cands[take] = self.cand_flat[flat_idx]
        labels[take] = self.labels_flat[flat_idx]
        return cands, labels


def split_news_by_length(news, hist_local: np.ndarray, cand_local: np.ndarray,
                         split_title_len: int, min_tail: int = 64, margin: int = 0) -> Tuple:
    """Reorder a per-batch unique news table by title length and split it
    into (short at ``split_title_len``, long at full width) row segments of
    bucketed sizes, remapping the index matrices.

    Returns ``(news, news2, hist_local, cand_local)``; ``news2`` is None when
    the split buys nothing (at most ``split_title_len`` columns, or more
    than half the rows long).  Exact: pad tokens embed to zeros and are
    masked keys.  The tail holds {u/8 (at least ``min_tail``), u/4, u/2}
    rows, the smallest that takes the long titles.  Rows count as short when
    ``len <= split_title_len - margin``.
    """
    title = news.title
    u, l_full = title.shape
    if l_full <= split_title_len:
        return news, None, hist_local, cand_local
    lens = news.title_mask.sum(axis=1)
    n_long = int(np.sum(lens > split_title_len - margin))
    if n_long > u // 2:
        return news, None, hist_local, cand_local
    order = np.argsort(lens, kind="stable")  # the pad article (length 0) stays row 0
    rank = np.empty(u, dtype=np.int32)
    rank[order] = np.arange(u, dtype=np.int32)
    news = type(news)(**{k: (None if v is None else v[order]) for k, v in news._asdict().items()})
    hist_local = rank[hist_local]
    cand_local = rank[cand_local]
    if n_long == 0:
        return (news._replace(title=news.title[:, :split_title_len],
                              title_mask=news.title_mask[:, :split_title_len]),
                None, hist_local, cand_local)
    choices = sorted({max(min_tail, u // 8), u // 4, u // 2})
    u2 = next(c for c in choices if c >= n_long)
    u1 = u - u2

    def rows(seg_slice, trim):
        d = {}
        for k, v in news._asdict().items():
            if v is None:
                d[k] = None
            elif trim and k in ("title", "title_mask"):
                d[k] = v[seg_slice, :split_title_len]
            else:
                d[k] = v[seg_slice]
        return type(news)(**d)

    return rows(slice(0, u1), True), rows(slice(u1, u), False), hist_local, cand_local


def _dedup(store: NewsStore, hist_idx: np.ndarray, cand_idx: np.ndarray,
           u_bucket_min: int = 128, split_title_len: Optional[int] = None,
           split_margin: int = 0) -> Tuple:
    """Map store rows ``hist_idx (B, H)`` / ``cand_idx (B, C)`` to a per-batch
    unique table (row 0 = pad) of ``next_bucket`` rows.  Returns ``(news,
    news2, hist_local, cand_local)``, split by ``split_news_by_length`` when
    ``split_title_len`` is set."""
    unique = np.unique(np.concatenate([hist_idx.ravel(), cand_idx.ravel()]))
    if unique.size == 0 or unique[0] != 0:
        unique = np.concatenate([[0], unique])
    u = next_bucket(len(unique), u_bucket_min)
    padded_unique = np.zeros(u, dtype=np.int32)
    padded_unique[: len(unique)] = unique
    hist_local = np.searchsorted(unique, hist_idx).astype(np.int32)
    cand_local = np.searchsorted(unique, cand_idx).astype(np.int32)
    news = store.features_for(padded_unique)
    if split_title_len is not None:
        return split_news_by_length(news, hist_local, cand_local, split_title_len,
                                    margin=split_margin)
    return news, None, hist_local, cand_local


class TrainBatcher:
    """Per-epoch shuffled K+1-candidate training batches with a per-batch
    deduplicated (and optionally length-split) news table."""

    def __init__(
        self,
        store: NewsStore,
        impressions: Impressions,
        batch_size: int = 64,
        max_history_len: int = 50,
        neg_sampling_ratio: int = 4,
        seed: int = 0,
        u_bucket_min: int = 512,
        drop_last: bool = True,
        split_title_len: Optional[int] = None,
        split_margin: int = 0,
    ):
        self.store = store
        self.imp = impressions
        self.batch_size = batch_size
        self.max_history_len = max_history_len
        self.k = int(neg_sampling_ratio)
        self.seed = seed
        self.u_bucket_min = u_bucket_min
        self.drop_last = drop_last
        self.split_title_len = split_title_len
        self.split_margin = split_margin
        # one training sample per positive
        pos_flat = np.nonzero(impressions.labels_flat)[0]
        self.sample_imp = (
            np.searchsorted(impressions.cand_offsets, pos_flat, side="right") - 1
        ).astype(np.int64)
        self.sample_pos = impressions.cand_flat[pos_flat].astype(np.int32)

        self._hist_pad = impressions.padded_history(max_history_len)
        max_c = int(np.max(np.diff(impressions.cand_offsets))) if len(impressions) else 1
        cand_pad, label_pad = impressions.padded_candidates(max_c)
        neg_mask = (label_pad == 0) & (cand_pad != 0)
        self._neg_counts = neg_mask.sum(axis=1).astype(np.int32)
        order = np.argsort(~neg_mask, axis=1, kind="stable")  # negatives first
        self._negs_pad = np.take_along_axis(cand_pad, order, axis=1)
        self._max_c = max_c

    def __len__(self) -> int:
        n = len(self.sample_imp)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def num_samples(self) -> int:
        return len(self.sample_imp)

    def epoch(self, epoch_idx: int = 0) -> Iterator[RecBatch]:
        """The batches of one epoch, drawn from ``default_rng((seed,
        epoch_idx))``: K distinct negatives per row by a random-key argsort
        over that row's negatives (wrapping around, with replacement, when
        it has fewer than K), and the slate shuffled."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(len(self.sample_imp))
        b, h, c = self.batch_size, self.max_history_len, self.k + 1
        for bi in range(len(self)):
            sel = order[bi * b : (bi + 1) * b]
            nsel = len(sel)
            if nsel < b and self.drop_last:
                break
            imp_ids = self.sample_imp[sel]
            hist_idx = np.zeros((b, h), dtype=np.int32)
            hist_idx[:nsel] = self._hist_pad[imp_ids]

            n_negs = self._neg_counts[imp_ids]
            keys = rng.random((nsel, self._max_c))
            keys[np.arange(self._max_c)[None, :] >= n_negs[:, None]] = np.inf
            pick = np.argsort(keys, axis=1)[:, : self.k]
            safe_n = np.maximum(n_negs, 1)[:, None]
            pick = np.where(np.arange(self.k)[None, :] < n_negs[:, None], pick, pick % safe_n)
            negs = np.take_along_axis(self._negs_pad[imp_ids], pick, axis=1)
            negs[n_negs == 0] = 0

            slate = np.concatenate([self.sample_pos[sel][:, None], negs], axis=1)
            lab = np.zeros((nsel, c), dtype=np.float32)
            lab[:, 0] = 1.0
            perm = np.argsort(rng.random((nsel, c)), axis=1)
            cand_idx = np.zeros((b, c), dtype=np.int32)
            labels = np.zeros((b, c), dtype=np.float32)
            cand_idx[:nsel] = np.take_along_axis(slate, perm, axis=1)
            labels[:nsel] = np.take_along_axis(lab, perm, axis=1)

            user_idx = np.zeros(b, dtype=np.int32)
            user_idx[:nsel] = self.imp.user_idx[imp_ids]
            valid = np.zeros(b, dtype=bool)
            valid[:nsel] = True

            news, news2, hist_local, cand_local = _dedup(
                self.store, hist_idx, cand_idx, self.u_bucket_min,
                self.split_title_len, self.split_margin,
            )
            yield RecBatch(
                news=news,
                hist_idx=hist_local,
                hist_mask=hist_idx != 0,
                cand_idx=cand_local,
                cand_mask=cand_idx != 0,
                labels=labels,
                user_idx=user_idx,
                impression_valid=valid,
                news2=news2,
            )


class BucketedAssembler:
    """Eval batches with GLOBAL store rows in ``hist_idx``/``cand_idx`` and
    ``news=None``: the JAX package's ``_BucketedAssembler``, which its
    ``serving.py::GlobalEvalBatcher`` uses as it is and ``EvalBatcher``
    turns into locally deduplicated batches.

    Impressions are bucketed by candidate count (powers of two between
    ``min_cand_bucket`` and ``max_cand_bucket``); a bucket's batches hold
    ``target_cells // C`` rows, the last one padded with invalid rows.
    """

    def __init__(
        self,
        impressions: Impressions,
        max_history_len: int,
        target_cells: int,
        min_cand_bucket: int = 8,
        max_cand_bucket: int = 512,
    ):
        self.imp = impressions
        self.max_history_len = max_history_len
        self.target_cells = target_cells
        sizes = np.diff(impressions.cand_offsets)
        n_trunc = int(np.sum(sizes > max_cand_bucket))
        if n_trunc:
            logging.getLogger("newsreclib_tpu_torch").warning(
                "%d/%d impressions have more than max_cand_bucket=%d candidates; "
                "their tails will be TRUNCATED in evaluation (max seen: %d). "
                "Raise max_cand_bucket to score them fully.",
                n_trunc, len(sizes), max_cand_bucket, int(sizes.max()),
            )
        caps = np.minimum(
            2 ** np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64),
            max_cand_bucket,
        )
        caps = np.maximum(caps, min_cand_bucket)
        self.buckets = {int(cb): np.nonzero(caps == cb)[0] for cb in np.unique(caps)}
        self._hist_pad = impressions.padded_history(max_history_len)

    def __iter__(self) -> Iterator[RecBatch]:
        h = self.max_history_len
        for c, idxs in sorted(self.buckets.items()):
            b = max(1, self.target_cells // c)
            lens = np.minimum(np.diff(self.imp.cand_offsets)[idxs], c)
            cand_pad = np.zeros((len(idxs), c), dtype=np.int32)
            label_pad = np.zeros((len(idxs), c), dtype=np.float32)
            pos = np.arange(c)[None, :]
            take = pos < lens[:, None]
            flat_idx = (self.imp.cand_offsets[idxs][:, None] + pos)[take]
            cand_pad[take] = self.imp.cand_flat[flat_idx]
            label_pad[take] = self.imp.labels_flat[flat_idx]

            for start in range(0, len(idxs), b):
                chunk = idxs[start : start + b]
                n = len(chunk)
                hist_idx = np.zeros((b, h), dtype=np.int32)
                hist_idx[:n] = self._hist_pad[chunk]
                cand_idx = np.zeros((b, c), dtype=np.int32)
                cand_idx[:n] = cand_pad[start : start + n]
                labels = np.zeros((b, c), dtype=np.float32)
                labels[:n] = label_pad[start : start + n]
                user_idx = np.zeros(b, dtype=np.int32)
                user_idx[:n] = self.imp.user_idx[chunk]
                valid = np.zeros(b, dtype=bool)
                valid[:n] = True
                yield RecBatch(
                    news=None,
                    hist_idx=hist_idx,
                    hist_mask=hist_idx != 0,
                    cand_idx=cand_idx,
                    cand_mask=cand_idx != 0,
                    labels=labels,
                    user_idx=user_idx,
                    impression_valid=valid,
                )


class EvalBatcher:
    """Full-impression eval batches, bucketed by candidate count, each with
    its deduplicated (and optionally length-split) news table: the
    ``BucketedAssembler`` batches passed through ``_dedup``."""

    def __init__(
        self,
        store: NewsStore,
        impressions: Impressions,
        max_history_len: int = 50,
        target_cells: int = 8192,
        min_cand_bucket: int = 8,
        max_cand_bucket: int = 512,
        u_bucket_min: int = 512,
        split_title_len: Optional[int] = None,
        split_margin: int = 0,
    ):
        self.store = store
        self.imp = impressions
        self.max_history_len = max_history_len
        self.target_cells = target_cells
        self.u_bucket_min = u_bucket_min
        self.split_title_len = split_title_len
        self.split_margin = split_margin
        self._assembler = BucketedAssembler(impressions, max_history_len, target_cells,
                                            min_cand_bucket, max_cand_bucket)

    def __iter__(self) -> Iterator[RecBatch]:
        for raw in self._assembler:
            news, news2, hist_local, cand_local = _dedup(
                self.store, raw.hist_idx, raw.cand_idx, self.u_bucket_min,
                self.split_title_len, self.split_margin,
            )
            yield raw._replace(news=news, hist_idx=hist_local, cand_idx=cand_local, news2=news2)

    def num_impressions(self) -> int:
        return len(self.imp)
