"""MINS: multi-interest news sequence modelling (counterpart of
``newsreclib_tpu/models/general_rec/mins.py``).

News encoder: the NRMS title encoder (``MHSAAddAtt``, shared by title and
abstract) and the category projected to the text width, combined by
additive attention.  User encoder: MHSA with ``num_gru_channels`` heads (6
heads of 50 at the config's widths, the attention kernel's wide instances),
a channel-shared GRU and additive attention.  Defaults as
``configs/model/mins.yaml`` and the JAX factory.
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
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.user import MINSUserEncoder


class MINS(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        num_categories: int = 19,
        attributes2encode: Sequence[str] = ("title", "abstract", "category"),
        text_embed_dim: int = 300,
        categ_embed_dim: int = 100,
        num_heads: int = 15,
        query_dim: int = 200,
        dropout: float = 0.2,
        num_filters: Optional[int] = None,
        num_gru_channels: int = 6,
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
            text_embed_dim = text_encoder_dim
        else:
            text_encoder = MHSAAddAtt(vocab_size, text_embed_dim, num_heads, query_dim, dropout,
                                      pretrained_embeddings, generator)
        category_encoder = LinearEncoder(num_categories, categ_embed_dim, use_dropout=False,
                                         linear_transform=True, output_dim=text_embed_dim,
                                         generator=generator)
        self.news_encoder = NewsEncoder(
            attributes2encode, text_encoder, category_encoder, combine_type="add_att",
            query_dim=query_dim, text_dim=text_embed_dim, category_dim=text_embed_dim,
            generator=generator, shared_text_encoder=text_encoder_module is not None)
        self.user_encoder = None if late_fusion else MINSUserEncoder(
            text_embed_dim, query_dim, num_filters or text_embed_dim, num_gru_channels, generator)
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.news_encoder(news, deterministic, generator)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor) -> torch.Tensor:
        """Score a batch whose hist/cand indices point into ``news_vecs``
        (the user encoder has no dropout)."""
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
        return self.score_with_vectors(batch, news_vecs), {}
