"""TANR: topic-aware news recommendation (counterpart of
``newsreclib_tpu/models/general_rec/tanr.py``).

News encoder: ``CNNAddAtt`` over titles.  User encoder: NAML's additive
attention.  A Dense topic classifier over the batch's unique news vectors
adds ``topic_loss``: ``topic_pred_loss_coef`` x the cross-entropy against
the category, averaged over the valid rows (each article once, as the JAX
package; the reference counts each occurrence).  ``num_heads`` is accepted
and unused, as in the JAX package.  No attention kernel runs.  Defaults as
``configs/model/tanr.yaml`` and the JAX factory.
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
from newsreclib_tpu_torch.models.components.plm import share
from newsreclib_tpu_torch.models.components.text import CNNAddAtt
from newsreclib_tpu_torch.models.components.user import NAMLUserEncoder


class TANR(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        num_categories: int = 19,
        embed_dim: int = 300,
        num_heads: int = 15,
        num_filters: int = 400,
        window_size: int = 3,
        query_dim: int = 200,
        dropout: float = 0.2,
        topic_pred_loss_coef: float = 0.2,
        late_fusion: bool = False,
        pretrained_embeddings: Optional[np.ndarray] = None,
        text_encoder_module: Optional[nn.Module] = None,
        text_encoder_dim: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.late_fusion = late_fusion
        self.topic_pred_loss_coef = topic_pred_loss_coef
        if text_encoder_module is not None:  # a PLM tower of width text_encoder_dim
            self.text_encoder_module = text_encoder_module
            share(self, "news_encoder", text_encoder_module)
            num_filters = text_encoder_dim
        else:
            self.news_encoder = CNNAddAtt(vocab_size, embed_dim, num_filters, window_size,
                                          query_dim, dropout, pretrained_embeddings, generator)
        self.user_encoder = None if late_fusion else NAMLUserEncoder(num_filters, query_dim,
                                                                     generator)
        self.topic_predictor = Dense(num_filters, num_categories, generator)
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
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
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        scores = self.score_with_vectors(batch, news_vecs)
        log_probs = torch.log_softmax(self.topic_predictor(news_vecs), dim=-1)
        categ = news_field(batch, "category").long()
        ce = -log_probs.gather(-1, categ[:, None])[:, 0]
        valid = news_valid(batch)  # summed in float32, as JAX promotes ce * valid
        topic_loss = (torch.where(valid, ce.float(), 0.0).sum()
                      / valid.float().sum().clamp_min(1.0))
        return scores, {"topic_loss": self.topic_pred_loss_coef * topic_loss}
