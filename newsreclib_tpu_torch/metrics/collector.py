"""Per-impression metric suite (counterpart of
``newsreclib_tpu/metrics/collector.py:24-98``).  Names match the JAX
package's: ``mrr``, ``ndcg@k``, ``categ_div@k``, ``sent_div@k``,
``categ_pers@k``, ``sent_pers@k``; the pooled ``auc`` is computed by the
caller over the epoch."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

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
