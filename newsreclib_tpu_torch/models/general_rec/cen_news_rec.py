"""CenNewsRec: the centralized baseline of the privacy-preserving news
recommender (counterpart of
``newsreclib_tpu/models/general_rec/cen_news_rec.py``).

News encoder: ``CNNMHSAAddAtt`` over titles (its MHSA at (U, L, 400) with
20 heads of 20).  User encoder: long-term MHSA + additive attention and
short-term GRU over the last 20 clicks, fused by additive attention.
Defaults as ``configs/model/cen_news_rec.yaml`` and the JAX factory.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.models.base import encode_all_news, gather_news, late_fusion_user
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.plm import share
from newsreclib_tpu_torch.models.components.text import CNNMHSAAddAtt
from newsreclib_tpu_torch.models.components.user import CenNewsRecUserEncoder


class CenNewsRec(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 300,
        num_heads: int = 20,
        num_filters: int = 400,
        window_size: int = 3,
        query_dim: int = 200,
        dropout: float = 0.2,
        gru_hidden_dim: int = 400,
        num_recent_news: int = 20,
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
        if text_encoder_module is not None:  # a PLM tower of width text_encoder_dim
            self.text_encoder_module = text_encoder_module
            share(self, "news_encoder", text_encoder_module)
            num_filters = text_encoder_dim
        else:
            self.news_encoder = CNNMHSAAddAtt(vocab_size, embed_dim, num_filters, window_size,
                                              num_heads, query_dim, dropout,
                                              pretrained_embeddings, generator)
        self.user_encoder = None if late_fusion else CenNewsRecUserEncoder(
            num_filters, num_heads, query_dim, gru_hidden_dim, num_recent_news, dropout,
            generator)
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.news_encoder(news.title, news.title_mask, deterministic, generator)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hist = gather_news(news_vecs, batch.hist_idx)
        cand = gather_news(news_vecs, batch.cand_idx)
        if self.late_fusion:
            user = late_fusion_user(hist, batch.hist_mask)
        else:
            user = self.user_encoder(hist, batch.hist_mask, deterministic, generator)
        return dot_product_scores(user, cand)

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        return self.score_with_vectors(batch, news_vecs, deterministic, generator), {}
