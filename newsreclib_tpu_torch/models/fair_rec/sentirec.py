"""SentiRec: NRMS with a sentiment-regression head and a sentiment-diversity
penalty (counterpart of ``newsreclib_tpu/models/fair_rec/sentirec.py``).

The aux losses, each already multiplied by its coefficient:

* ``sent_pred_loss``: the L1 between the head's prediction and the
  annotated ``sentiment_score`` over the batch's unique valid articles
  (each article once).  The reference computes it against the targets
  themselves, an always-zero loss; the JAX package, and so the port,
  computes the intended L1;
* ``sent_div_loss``: ``relu(user mean sentiment x candidate sentiment x
  score)`` averaged over the valid candidates.

The news tower is user-independent, so ``encode_news`` /
``score_with_vectors`` split the model for cached serving; the aux losses
exist on the fused training path only.  Both attentions (titles, user
history) go through the ``fused_small_mhsa`` kernel on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.models.base import (
    encode_all_news,
    gather_news,
    late_fusion_user,
    news_field,
    news_valid,
)
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.linear import Dense
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.user import NRMSUserEncoder


def masked_mean(values: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean of ``values`` where ``mask`` holds (a select, never a product),
    over ``dim`` (all elements when None); 0 where nothing is valid."""
    total = torch.where(mask, values, 0.0)
    count = mask.to(values.dtype)
    if dim is None:
        return total.sum() / count.sum().clamp_min(1.0)
    return total.sum(dim) / count.sum(dim).clamp_min(1.0)


class SentiRec(nn.Module):
    """Hyperparameters as the JAX ``SentiRec`` (embed 300, heads 15, query
    200, dropout 0.2, coefficients 0.4 and 10).  Weights are drawn on the CPU
    from ``generator`` (seed 0 when none is given) and moved to ``device``
    (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 300,
        num_heads: int = 15,
        query_dim: int = 200,
        dropout: float = 0.2,
        sent_pred_loss_coef: float = 0.4,
        sent_div_loss_coef: float = 10.0,
        late_fusion: bool = False,
        pretrained_embeddings: Optional[np.ndarray] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.late_fusion = late_fusion
        self.sent_pred_loss_coef = sent_pred_loss_coef
        self.sent_div_loss_coef = sent_div_loss_coef
        self.news_encoder = MHSAAddAtt(vocab_size, embed_dim, num_heads, query_dim, dropout,
                                       pretrained_embeddings, generator)
        self.user_encoder = (None if late_fusion
                             else NRMSUserEncoder(embed_dim, num_heads, query_dim, generator))
        self.sent_predictor = Dense(embed_dim, 1, generator)
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(U, L) unique news -> (U, D) vectors (cacheable)."""
        return self.news_encoder(news.title, news.title_mask, deterministic, generator)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor) -> torch.Tensor:
        hist = gather_news(news_vecs, batch.hist_idx)
        cand = gather_news(news_vecs, batch.cand_idx)
        if self.late_fusion:
            user = late_fusion_user(hist, batch.hist_mask)
        else:
            user = self.user_encoder(hist, batch.hist_mask)
        return dot_product_scores(user, cand)

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """``(scores (B, C), {"sent_pred_loss", "sent_div_loss"})``; the aux
        terms in float32."""
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        scores = self.score_with_vectors(batch, news_vecs)

        # sentiment regression over the unique news (each article once)
        pred_sent = self.sent_predictor(news_vecs)[..., 0].float()
        sent_score = news_field(batch, "sentiment_score").float()
        sent_pred_loss = masked_mean((pred_sent - sent_score).abs(), news_valid(batch))

        # sentiment-diversity regularisation
        user_mean_sent = masked_mean(sent_score[batch.hist_idx], batch.hist_mask, dim=1)
        cand_sent = sent_score[batch.cand_idx]
        div = torch.relu(user_mean_sent[:, None] * cand_sent * scores.float())
        sent_div_loss = masked_mean(div, batch.cand_mask)
        return scores, {
            "sent_pred_loss": self.sent_pred_loss_coef * sent_pred_loss,
            "sent_div_loss": self.sent_div_loss_coef * sent_div_loss,
        }
