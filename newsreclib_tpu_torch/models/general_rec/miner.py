"""MINER: multi-interest matching network (counterpart of
``newsreclib_tpu/models/general_rec/miner.py``).

News encoder: the NRMS title encoder (``MHSAAddAtt``, 15 heads of 20: its
attention is ``fused_small_mhsa`` on the card), a Dense reduction to
``news_embed_dim`` and dropout.  User encoder: ``PolyAttention``, K context
codes over the history, biased by the pairwise cosine similarity of the
history's and the candidates' category embeddings.  Scores: the K interests
against each candidate, reduced by max, mean or ``TargetAwareAttention``
(``score_type``).  Aux loss ``disagreement_loss``: the mean pairwise
cosine similarity of the K interests (diagonal zeroed).

The category bias is added only when ``categ_vecs`` is passed or the batch
carries its news table, as ``miner.py:118-121`` does: the training forward
has it, cached serving (``serving.CachedScorer``, whose global-row batches
carry no news table) scores without it, as the JAX package's serving does.
Defaults as ``configs/model/miner.yaml`` and the JAX factory.
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
)
from newsreclib_tpu_torch.models.components.attention import PolyAttention, TargetAwareAttention
from newsreclib_tpu_torch.models.components.category import LinearEncoder
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.linear import Dense
from newsreclib_tpu_torch.models.components.plm import share
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.utils import pairwise_cosine_similarity

SCORE_TYPES = ("weighted", "mean", "max")


class MINER(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        num_categories: int = 19,
        text_embed_dim: int = 300,
        news_embed_dim: int = 256,
        num_heads: int = 15,
        query_dim: int = 200,
        dropout: float = 0.2,
        use_categ_bias: bool = True,
        categ_embed_dim: int = 100,
        num_context_codes: int = 32,
        context_code_dim: int = 200,
        score_type: str = "weighted",
        late_fusion: bool = False,
        pretrained_embeddings: Optional[np.ndarray] = None,
        pretrained_categ_embeddings: Optional[np.ndarray] = None,
        text_encoder_module: Optional[nn.Module] = None,
        text_encoder_dim: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if score_type not in SCORE_TYPES:
            raise ValueError(f"invalid score_type {score_type!r}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.late_fusion = late_fusion
        self.use_categ_bias = use_categ_bias
        self.score_type = score_type
        if text_encoder_module is not None:  # a PLM tower of width text_encoder_dim
            self.text_encoder_module = text_encoder_module
            share(self, "text_encoder", text_encoder_module)
            text_embed_dim = text_encoder_dim
        else:
            self.text_encoder = MHSAAddAtt(vocab_size, text_embed_dim, num_heads, query_dim,
                                           dropout, pretrained_embeddings, generator)
        self.reduce_dim = Dense(text_embed_dim, news_embed_dim, generator)
        self.reduce_dropout = Dropout(dropout)
        if not late_fusion:
            if use_categ_bias:
                self.categ_encoder = LinearEncoder(num_categories, categ_embed_dim,
                                                   pretrained_categ_embeddings, dropout=dropout,
                                                   generator=generator)
            self.user_encoder = PolyAttention(news_embed_dim, num_context_codes, context_code_dim,
                                              generator)
            if score_type == "weighted":
                self.target_aware_attn = TargetAwareAttention(news_embed_dim, generator)
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        text = self.text_encoder(news.title, news.title_mask, deterministic, generator)
        return self.reduce_dropout(self.reduce_dim(text), deterministic, generator)

    def encode_categories(self, categories: torch.Tensor, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.categ_encoder(categories, deterministic, generator)

    def _score_and_user(self, batch: RecBatch, news_vecs: torch.Tensor,
                        deterministic: bool = True, generator: Optional[torch.Generator] = None,
                        categ_vecs: Optional[torch.Tensor] = None):
        hist = gather_news(news_vecs, batch.hist_idx)
        cand = gather_news(news_vecs, batch.cand_idx)
        if self.late_fusion:
            user = late_fusion_user(hist, batch.hist_mask)
            return dot_product_scores(user, cand), user[:, None, :]
        bias = None
        if self.use_categ_bias:
            if categ_vecs is None and batch.news is not None:
                categ_vecs = self.encode_categories(news_field(batch, "category"), deterministic,
                                                    generator)
            if categ_vecs is not None:
                bias = pairwise_cosine_similarity(gather_news(categ_vecs, batch.hist_idx),
                                                  gather_news(categ_vecs, batch.cand_idx))
                bias = torch.where(batch.cand_mask[:, None, :], bias, 0.0)  # (B, H, C)
        user_k = self.user_encoder(hist, batch.hist_mask, bias)  # (B, K, D)
        raw = cand @ user_k.transpose(1, 2)  # (B, C, K)
        if self.score_type == "max":
            return raw.amax(dim=-1), user_k
        if self.score_type == "mean":
            return raw.mean(dim=-1), user_k
        return self.target_aware_attn(user_k, cand, raw), user_k

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor,
                           deterministic: bool = True,
                           generator: Optional[torch.Generator] = None,
                           categ_vecs: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._score_and_user(batch, news_vecs, deterministic, generator, categ_vecs)[0]

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        scores, user = self._score_and_user(batch, news_vecs, deterministic, generator)
        disagreement = pairwise_cosine_similarity(user, user, zero_diagonal=True).mean()
        return scores, {"disagreement_loss": disagreement}
