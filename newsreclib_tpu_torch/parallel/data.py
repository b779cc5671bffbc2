"""Strided sharding of the impressions over the data ranks of a multi-host
run (counterpart of ``newsreclib_tpu/parallel/data.py``): numpy, equal byte
for byte.  Data rank ``i`` of ``n`` keeps impressions ``i, i + n, ...``."""

from __future__ import annotations

import numpy as np

from newsreclib_tpu_torch.data.batching import Impressions


def shard_impressions(imp: Impressions, process_index: int, process_count: int) -> Impressions:
    """Deterministic strided shard of the impression set for one data rank."""
    if process_count <= 1:
        return imp
    sel = np.arange(process_index, len(imp), process_count)
    hist_lens = np.diff(imp.hist_offsets)[sel]
    cand_lens = np.diff(imp.cand_offsets)[sel]

    def gather_csr(flat, offsets, lens, idxs):
        out_off = np.zeros(len(idxs) + 1, dtype=np.int64)
        np.cumsum(lens, out=out_off[1:])
        pieces = [flat[offsets[i]: offsets[i + 1]] for i in idxs]
        out_flat = np.concatenate(pieces) if pieces else flat[:0]
        return out_flat, out_off

    hist_flat, hist_off = gather_csr(imp.hist_flat, imp.hist_offsets, hist_lens, sel)
    cand_flat, cand_off = gather_csr(imp.cand_flat, imp.cand_offsets, cand_lens, sel)
    # the labels share the candidates' offsets
    lab_pieces = [imp.labels_flat[imp.cand_offsets[i]: imp.cand_offsets[i + 1]] for i in sel]
    labels_flat = np.concatenate(lab_pieces) if lab_pieces else imp.labels_flat[:0]
    return Impressions(
        hist_flat, hist_off, cand_flat, cand_off, labels_flat,
        imp.user_idx[sel],
        None if imp.user_ids is None else imp.user_ids[sel],
    )
