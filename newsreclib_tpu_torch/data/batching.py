"""Host-side batching with static shapes (counterpart of
``newsreclib_tpu/data/batching.py``).

Ported so far: ``next_bucket``, the CSR ``Impressions`` store and the
vectorized eval assembler in global-row mode, which the cached serving path
consumes.  Impressions are bucketed by candidate count into powers of two;
partial batches are padded with invalid rows.  The JAX package's ``lean``
wire format (narrow dtypes for a remote TPU link) is not ported.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from newsreclib_tpu_torch.data.batch import RecBatch


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


class BucketedAssembler:
    """Eval batches with GLOBAL store rows in ``hist_idx``/``cand_idx`` and
    ``news=None``: the JAX package's ``_BucketedAssembler`` in global-row
    mode, which its ``serving.py::GlobalEvalBatcher`` wraps.

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
