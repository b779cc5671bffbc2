"""CAUM: candidate-aware user modelling (counterpart of
``newsreclib_tpu/models/general_rec/caum.py``).

News encoder: the NRMS title encoder (20 heads of 15), the entity encoder
over title entities and the category embedding, combined by a linear
projection to ``news_embed_dim``.  User encoder: the candidate-aware
encoder, which returns the scores; its MHSA runs at (B C, 50, 400) with
``text_num_heads`` heads (20 heads of 20).  Defaults as
``configs/model/caum.yaml`` and the JAX factory.
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
from newsreclib_tpu_torch.models.components.news import EntityAddAtt, NewsEncoder
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.user import CAUMUserEncoder


class CAUM(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        entity_vocab_size: int = 1,
        num_categories: int = 19,
        attributes2encode: Sequence[str] = ("title", "category", "title_entities"),
        text_embed_dim: int = 300,
        text_num_heads: int = 20,
        categ_embed_dim: int = 100,
        news_embed_dim: int = 400,
        entity_embed_dim: int = 100,
        query_dim: int = 200,
        dropout: float = 0.2,
        user_vector_dim: int = 400,
        num_filters: int = 400,
        dense_att_hidden_dim1: int = 400,
        dense_att_hidden_dim2: int = 256,
        late_fusion: bool = False,
        pretrained_embeddings: Optional[np.ndarray] = None,
        pretrained_entity_embeddings: Optional[np.ndarray] = None,
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
            text_embed_dim = text_encoder_dim
        else:
            text_encoder = MHSAAddAtt(vocab_size, text_embed_dim, text_num_heads, query_dim,
                                      dropout, pretrained_embeddings, generator)
        entity_encoder = EntityAddAtt(entity_vocab_size, entity_embed_dim, query_dim, dropout,
                                      pretrained_entity_embeddings, generator)
        category_encoder = LinearEncoder(num_categories, categ_embed_dim, use_dropout=False,
                                         generator=generator)
        self.news_encoder = NewsEncoder(
            attributes2encode, text_encoder, category_encoder, entity_encoder,
            combine_type="linear", output_dim=news_embed_dim, text_dim=text_embed_dim,
            category_dim=categ_embed_dim, entity_dim=entity_embed_dim, generator=generator,
            shared_text_encoder=text_encoder_module is not None)
        self.user_encoder = None if late_fusion else CAUMUserEncoder(
            news_embed_dim, num_filters, dense_att_hidden_dim1, dense_att_hidden_dim2,
            user_vector_dim, text_num_heads, dropout, generator)
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
            return dot_product_scores(late_fusion_user(hist, batch.hist_mask), cand)
        return self.user_encoder(hist, cand, batch.hist_mask, deterministic, generator)

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        return self.score_with_vectors(batch, news_vecs, deterministic, generator), {}
