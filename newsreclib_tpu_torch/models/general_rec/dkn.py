"""DKN: deep knowledge-aware network (counterpart of
``newsreclib_tpu/models/general_rec/dkn.py``).

News encoder: ``KCNN`` (word, entity and context channels, VALID
convolutions of windows 1-4, max over positions).  User encoder: attention
of each candidate over the history, one user vector per candidate; the DNN
click predictor scores them, and padded candidates score 0.  Late fusion:
mean user and dot product.  No attention kernel runs.  Defaults as
``configs/model/dkn.yaml`` and the JAX factory.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.models.base import encode_all_news, gather_news, late_fusion_user
from newsreclib_tpu_torch.models.components.click import DNNPredictor, dot_product_scores
from newsreclib_tpu_torch.models.components.news import KCNN
from newsreclib_tpu_torch.models.components.user import DKNUserEncoder


class DKN(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``)."""

    def __init__(
        self,
        vocab_size: int,
        entity_vocab_size: int,
        text_embed_dim: int = 300,
        entity_embed_dim: int = 100,
        num_filters: int = 100,
        window_sizes: Sequence[int] = (1, 2, 3, 4),
        use_context: bool = True,
        use_entities: bool = True,
        hidden_dim_dnn: int = 16,
        late_fusion: bool = False,
        pretrained_embeddings: Optional[np.ndarray] = None,
        pretrained_entity_embeddings: Optional[np.ndarray] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.late_fusion = late_fusion
        self.window_sizes = tuple(int(w) for w in window_sizes)
        self.news_encoder = KCNN(vocab_size, entity_vocab_size, text_embed_dim, entity_embed_dim,
                                 num_filters, self.window_sizes, use_context, use_entities,
                                 pretrained_embeddings, pretrained_entity_embeddings, generator)
        dim = num_filters * len(self.window_sizes)
        if not late_fusion:
            self.user_encoder = DKNUserEncoder(dim, 100, generator)
            self.click_predictor = DNNPredictor(dim, hidden_dim_dnn, generator)
        self.to(device)

    @property
    def TITLE_SPLIT_MARGIN(self) -> int:
        """Title headroom past the last token that length trimming and
        splitting must leave: the widest window (the max over positions sees
        windows that reach past the title)."""
        return max(self.window_sizes)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.news_encoder(news.title, news.title_entities, news.title_mask,
                                 deterministic, generator)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor) -> torch.Tensor:
        hist = gather_news(news_vecs, batch.hist_idx)
        cand = gather_news(news_vecs, batch.cand_idx)
        if self.late_fusion:
            return dot_product_scores(late_fusion_user(hist, batch.hist_mask), cand)
        scores = self.click_predictor(self.user_encoder(hist, cand, batch.hist_mask), cand)
        return torch.where(batch.cand_mask, scores, 0.0)

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        return self.score_with_vectors(batch, news_vecs), {}
