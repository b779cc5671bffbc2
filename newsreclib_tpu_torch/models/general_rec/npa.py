"""NPA: news recommendation with personalized attention (counterpart of
``newsreclib_tpu/models/general_rec/npa.py``).

A user-id projection feeds personalized attention in the text encoder and
in the user encoder.  The word-level query is the projected user itself
(``user_embed_dim`` wide), as in the JAX package, not a preference
projection of it.  The news encoding depends on the user, so titles are
encoded per history and candidate slot, with no dedup, from one full-width
view of the batch's news table (``base.full_title_tokens``).  The model
has no ``encode_news`` / ``score_with_vectors``: the trainer evaluates it
through ``EvalBatcher`` batches and the eval step, as the JAX trainer does.
No attention kernel runs.  Defaults as ``configs/model/npa.yaml`` and the
JAX factory.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.data.batch import RecBatch
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.models.base import full_title_tokens, late_fusion_user
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.projection import UserProjection
from newsreclib_tpu_torch.models.components.text import CNNPersAtt
from newsreclib_tpu_torch.models.components.user import NPAUserEncoder


class NPA(nn.Module):
    """Weights are drawn on the CPU from ``generator`` (seed 0 when none is
    given) and moved to ``device`` (the card unless ``device="cpu"``).
    ``word_pref_query_dim`` is accepted and unused, as in the JAX package
    (see the module doc)."""

    def __init__(
        self,
        vocab_size: int,
        num_users: int,
        text_embed_dim: int = 300,
        user_embed_dim: int = 50,
        num_filters: int = 400,
        window_size: int = 3,
        word_pref_query_dim: int = 200,
        news_pref_query_dim: int = 200,
        dropout: float = 0.2,
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
        self.user_projection = UserProjection(num_users, user_embed_dim, dropout, generator)
        self.text_encoder = CNNPersAtt(vocab_size, user_embed_dim, text_embed_dim, num_filters,
                                       window_size, dropout, pretrained_embeddings, generator)
        self.user_encoder = None if late_fusion else NPAUserEncoder(
            user_embed_dim, news_pref_query_dim, num_filters, dropout, generator)
        self.to(device)

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        b = batch.hist_idx.shape[0]
        users = self.user_projection(batch.user_idx, deterministic, generator)  # (B, Du)
        titles, title_masks = full_title_tokens(batch)

        def encode_slots(idx):  # (B, X) slots -> (B, X, F)
            x = idx.shape[1]
            flat = idx.reshape(-1)
            vecs = self.text_encoder(titles[flat], users.repeat_interleave(x, dim=0),
                                     title_masks[flat], deterministic, generator)
            return vecs.reshape(b, x, -1)

        hist = encode_slots(batch.hist_idx)
        cand = encode_slots(batch.cand_idx)
        if self.late_fusion:
            user = late_fusion_user(hist, batch.hist_mask)
        else:
            user = self.user_encoder(hist, users, batch.hist_mask, deterministic, generator)
        return dot_product_scores(user, cand), {}
