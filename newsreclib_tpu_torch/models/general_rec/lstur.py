"""LSTUR: long- and short-term user representations (counterpart of
``newsreclib_tpu/models/general_rec/lstur.py``).

News encoder: ``CNNAddAtt`` shared by title and abstract and the category
embedding, concatenated.  User encoder: a long-term user-id embedding
(sized by the dataset's user count) with whole-vector user masking, and a
GRU over the history started from it (``ini``) or beside it (``con``).  No
attention kernel runs.  Defaults as ``configs/model/lstur.yaml`` and the
JAX factory.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.models.base import encode_all_news, gather_news, late_fusion_user
from newsreclib_tpu_torch.models.components.category import LinearEncoder
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.news import NewsEncoder
from newsreclib_tpu_torch.models.components.text import CNNAddAtt
from newsreclib_tpu_torch.models.components.user import LSTURUserEncoder


class LSTUR(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        num_users: int,
        num_categories: int = 19,
        attributes2encode: Sequence[str] = ("title", "abstract", "category"),
        text_embed_dim: int = 300,
        categ_embed_dim: int = 100,
        num_filters: int = 300,
        window_size: int = 3,
        query_dim: int = 200,
        dropout: float = 0.2,
        user_masking_probability: float = 0.5,
        long_short_term_method: str = "ini",
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
            self.text_encoder_module = text_encoder = text_encoder_module
            num_filters = text_encoder_dim
        else:
            text_encoder = CNNAddAtt(vocab_size, text_embed_dim, num_filters, window_size,
                                     query_dim, dropout, pretrained_embeddings, generator)
        category_encoder = LinearEncoder(num_categories, categ_embed_dim, use_dropout=False,
                                         generator=generator)
        self.news_encoder = NewsEncoder(
            attributes2encode, text_encoder, category_encoder, combine_type="concat",
            text_dim=num_filters, category_dim=categ_embed_dim, generator=generator,
            shared_text_encoder=text_encoder_module is not None)
        # the news width as lstur.py:75-88 computes it
        attrs = set(attributes2encode)
        news_dim = num_filters + categ_embed_dim * (("category" in attrs)
                                                    + ("subcategory" in attrs))
        if {"title", "abstract"} <= attrs:
            news_dim += num_filters
        self.user_encoder = None if late_fusion else LSTURUserEncoder(
            num_users, news_dim, user_masking_probability, long_short_term_method, generator)
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.news_encoder(news, deterministic, generator)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hist = gather_news(news_vecs, batch.hist_idx)
        cand = gather_news(news_vecs, batch.cand_idx)
        if self.late_fusion:
            user = late_fusion_user(hist, batch.hist_mask)
        else:
            user = self.user_encoder(batch.user_idx, hist, batch.hist_mask, deterministic,
                                     generator)
        return dot_product_scores(user, cand)

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        return self.score_with_vectors(batch, news_vecs, deterministic, generator), {}
