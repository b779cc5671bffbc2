"""Per-impression metric suite and its streaming accumulation (counterpart
of ``newsreclib_tpu/metrics/collector.py``).  Names match the JAX
package's: ``mrr``, ``ndcg@k``, ``categ_div@k``, ``sent_div@k``,
``categ_pers@k``, ``sent_pers@k``; the pooled ``auc`` and the ``loss`` are
reduced over the epoch by ``StreamingEval`` or the cached scorer."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from newsreclib_tpu_torch.metrics import functional as F


class RankingMetrics:
    def __init__(self, top_k_list: Sequence[int] = (5, 10), num_categ_classes: int = 19,
                 num_sent_classes: int = 4):
        self.top_k_list = tuple(top_k_list)
        self.num_categ_classes = num_categ_classes
        self.num_sent_classes = num_sent_classes

    def metric_names(self, with_categ: bool = True, with_sent: bool = True,
                     with_hist: bool = True) -> List[str]:
        """Key list of ``per_impression``'s output when the aspects it names
        are given for the candidates and, with ``with_hist``, for the
        history (the personalization metrics need both)."""
        ks = self.top_k_list
        names = ["mrr"] + [f"ndcg@{k}" for k in ks]
        if with_categ:
            names += [f"categ_div@{k}" for k in ks]
        if with_sent:
            names += [f"sent_div@{k}" for k in ks]
        if with_categ and with_hist:
            names += [f"categ_pers@{k}" for k in ks]
        if with_sent and with_hist:
            names += [f"sent_pers@{k}" for k in ks]
        return names

    def per_impression(
        self,
        scores: torch.Tensor,  # (B, C)
        labels: torch.Tensor,  # (B, C)
        cand_mask: torch.Tensor,  # (B, C) bool
        cand_categories: Optional[torch.Tensor] = None,  # (B, C)
        cand_sentiments: Optional[torch.Tensor] = None,  # (B, C)
        hist_categories: Optional[torch.Tensor] = None,  # (B, H)
        hist_sentiments: Optional[torch.Tensor] = None,  # (B, H)
        hist_mask: Optional[torch.Tensor] = None,  # (B, H) bool
    ) -> Dict[str, torch.Tensor]:
        """{name: (B,) float32}; the caller masks out padding impressions."""
        out = {"mrr": F.mrr(scores, labels, cand_mask)}
        for k in self.top_k_list:
            out[f"ndcg@{k}"] = F.ndcg_at_k(scores, labels, cand_mask, k)
        aspects = []
        if cand_categories is not None:
            aspects.append(("categ", cand_categories, hist_categories, self.num_categ_classes))
        if cand_sentiments is not None:
            aspects.append(("sent", cand_sentiments, hist_sentiments, self.num_sent_classes))
        for name, cand, _, n in aspects:
            for k in self.top_k_list:
                out[f"{name}_div@{k}"] = F.diversity_at_k(scores, cand, cand_mask, k, n)
        for name, cand, hist, n in aspects:
            if hist is not None:
                for k in self.top_k_list:
                    out[f"{name}_pers@{k}"] = F.personalization_at_k(
                        scores, cand, cand_mask, hist, hist_mask, k, n
                    )
        return out


class StreamingEval:
    """The uncached eval path's accumulator: per batch it adds the valid
    impressions' metric sums, keeps the AUC inputs and the valid-impression
    weighted loss on the device, and ``finalize`` fetches everything once."""

    def __init__(self, collect_auc: bool = True):
        self.collect_auc = collect_auc
        self._sums: Optional[Dict[str, torch.Tensor]] = None
        self._count: Optional[torch.Tensor] = None
        self._loss_sum: Optional[torch.Tensor] = None
        self._loss_w: Optional[torch.Tensor] = None
        self._parts: List = []

    def update(self, scores, per_imp, valid, labels=None, cand_mask=None, loss=None) -> None:
        v = valid.float()
        if self._sums is None:
            self._sums = {k: torch.zeros((), dtype=torch.float32, device=v.device)
                          for k in per_imp}
            self._count = torch.zeros((), dtype=torch.float32, device=v.device)
        for k in self._sums:
            self._sums[k] = self._sums[k] + (per_imp[k].float() * v).sum()
        self._count = self._count + v.sum()
        if self.collect_auc and labels is not None:
            w = (cand_mask & valid[:, None]).float()
            self._parts.append((scores.reshape(-1), (labels * w).reshape(-1), w.reshape(-1)))
        if loss is not None:
            # weighted by the valid impressions, so the epoch loss does not
            # depend on how the impressions were cut into batches
            nv = v.sum()
            if self._loss_sum is None:
                self._loss_sum, self._loss_w = loss * nv, nv
            else:
                self._loss_sum = self._loss_sum + loss * nv
                self._loss_w = self._loss_w + nv

    def finalize(self) -> Dict[str, float]:
        if self._sums is None:
            return {}
        keys = sorted(self._sums)
        fetch = [self._count] + [self._sums[k] for k in keys]
        if self._parts:
            fetch.append(F.binary_auc_weighted(
                *(torch.cat([p[i] for p in self._parts]) for i in range(3))))
        if self._loss_sum is not None:
            fetch += [self._loss_sum, self._loss_w]
        vals = torch.stack([x.float() for x in fetch]).cpu().numpy().astype(np.float64)
        count = max(float(vals[0]), 1.0)
        out = {k: float(vals[1 + i]) / count for i, k in enumerate(keys)}
        cursor = 1 + len(keys)
        if self._parts:
            out["auc"] = float(vals[cursor])
            cursor += 1
        if self._loss_sum is not None:
            out["loss"] = float(vals[cursor]) / max(float(vals[cursor + 1]), 1.0)
        return out
