"""NRMS: neural news recommendation with multi-head self-attention
(counterpart of ``newsreclib_tpu/models/general_rec/nrms.py:35-85``).

The title encoder runs once over the batch's unique news table and the
history/candidate slots gather from it.  ``encode_news`` and
``score_with_vectors`` split the model so that serving can encode the whole
corpus once (``serving.py``).  Both attentions go through the
``fused_small_mhsa`` kernel when the model lies on the card.  With a PLM
tower (``text_encoder_module``, ``components/plm.py``) the tower is the news
encoder and the user encoder works at its width.
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
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.user import NRMSUserEncoder


class NRMS(nn.Module):
    """Hyperparameters as the JAX ``NRMS`` (embed 300, heads 15, query 200,
    dropout 0.2); ``text_encoder_module`` of width ``text_encoder_dim``
    replaces the GloVe title encoder.  Weights are drawn on the CPU from ``generator`` (seed 0
    when none is given) and moved to ``device``; ``device`` defaults to the
    card, and without one the constructor raises unless ``device="cpu"``."""

    def __init__(
        self,
        vocab_size: int,
        embed_dim: int = 300,
        num_heads: int = 15,
        query_dim: int = 200,
        dropout: float = 0.2,
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
        if text_encoder_module is not None:
            self.text_encoder_module = text_encoder_module
            share(self, "news_encoder", text_encoder_module)
            embed_dim = text_encoder_dim
        else:
            self.news_encoder = MHSAAddAtt(
                vocab_size, embed_dim, num_heads, query_dim, dropout,
                pretrained_embeddings, generator,
            )
        self.user_encoder = (
            None if late_fusion
            else NRMSUserEncoder(embed_dim, num_heads, query_dim, generator)
        )
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(U, L) unique news -> (U, D) vectors (cacheable)."""
        return self.news_encoder(news.title, news.title_mask, deterministic, generator)

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
        """``(scores (B, C), aux losses {})``.  As the JAX ``deterministic``
        / ``rngs``: dropout runs when ``deterministic`` is False, drawing
        from ``generator``; the default leaves every generator untouched."""
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        return self.score_with_vectors(batch, news_vecs), {}
