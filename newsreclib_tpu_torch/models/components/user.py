"""User encoders (counterpart of
``newsreclib_tpu/models/components/user.py``): clicked-news vectors
``(B, H, D)`` with a left-aligned mask ``(B, H)`` -> a user representation.
Every MHSA goes through the attention kernel on the card: NRMS's at
(B, 50, 300) with 15 heads, MINS's with 6 heads of 50 (the kernel's wide
instances), CenNewsRec's at (B, 50, 400) and CAUM's at (B C, 50, 400) with
20 heads.  The NAML, LSTUR, NPA and DKN encoders have no MHSA."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from newsreclib_tpu_torch.models.components.attention import (
    AdditiveAttention,
    DenseAttention,
    MultiHeadSelfAttention,
    PersonalizedAttention,
    masked_softmax,
)
from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.linear import Dense, normal
from newsreclib_tpu_torch.models.components.projection import UserPreferenceQueryProjection
from newsreclib_tpu_torch.models.components.rnn import MaskedGRU


class NRMSUserEncoder(nn.Module):
    """MHSA over the history, then additive attention."""

    def __init__(self, dim: int = 300, num_heads: int = 15, query_dim: int = 200,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mhsa = MultiHeadSelfAttention(dim, num_heads, generator)
        self.add_att = AdditiveAttention(dim, query_dim, generator)

    def forward(self, hist: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, H, D) clicked-news vectors + (B, H) mask -> (B, D)."""
        return self.add_att(self.mhsa(hist, mask), mask)


class NAMLUserEncoder(nn.Module):
    """Additive attention over the history (NAML, TANR)."""

    def __init__(self, dim: int, query_dim: int = 200,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.add_att = AdditiveAttention(dim, query_dim, generator)

    def forward(self, hist: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.add_att(hist, mask)


class LSTURUserEncoder(nn.Module):
    """Long-term user-id embedding and a GRU over the history: ``ini`` starts
    the GRU from the long-term vector, ``con`` concatenates the GRU's last
    state with it (each half the width).  User 0 gets a zero long-term
    vector.  In training (``deterministic`` False) each row's long-term
    vector is dropped whole with probability ``user_masking_probability``
    and kept ones are scaled by 1 / (1 - p), one Bernoulli per row drawn
    from ``generator`` (the reference's ``Dropout2d``)."""

    def __init__(self, num_users: int, input_dim: int = 400,
                 user_masking_probability: float = 0.5, long_short_term_method: str = "ini",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if long_short_term_method not in ("ini", "con"):
            raise ValueError(f"long_short_term_method {long_short_term_method!r} is not "
                             "'ini' or 'con'")
        self.method = long_short_term_method
        self.user_masking_probability = user_masking_probability
        lt_dim = input_dim if long_short_term_method == "ini" else input_dim // 2
        self.long_term_user_embedding = nn.Parameter(normal((num_users, lt_dim), 0.02, generator))
        self.gru = MaskedGRU(input_dim, lt_dim, generator)

    def forward(self, user_idx: torch.Tensor, hist: torch.Tensor,
                mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lt = torch.where((user_idx != 0)[:, None], self.long_term_user_embedding[user_idx], 0.0)
        p = self.user_masking_probability
        if not deterministic and p > 0.0:
            if generator is None:
                raise ValueError("user masking with deterministic=False needs a generator")
            keep = torch.rand((lt.shape[0], 1), generator=generator, device=lt.device) < 1.0 - p
            lt = torch.where(keep, lt / (1.0 - p), 0.0)
        if self.method == "ini":
            return self.gru(hist, mask, init_h=lt)
        return torch.cat([self.gru(hist, mask), lt], dim=-1)


class NPAUserEncoder(nn.Module):
    """Personalized attention over the history, its query projected from
    the projected user ``(B, Du)``."""

    def __init__(self, user_embed_dim: int = 50, preference_query_dim: int = 200,
                 num_filters: int = 400, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.news_query_proj = UserPreferenceQueryProjection(user_embed_dim, preference_query_dim,
                                                             dropout, generator)
        self.pers_att = PersonalizedAttention(preference_query_dim, num_filters, generator)

    def forward(self, hist: torch.Tensor, projected_users: torch.Tensor,
                mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        query = self.news_query_proj(projected_users, deterministic, generator)
        return self.pers_att(query, hist, mask)


class DKNUserEncoder(nn.Module):
    """Candidate-attentive history pooling: hist (B, H, D), cand (B, C, D)
    -> one user vector per candidate (B, C, D).  The attention scorer is two
    Dense layers with no activation between them, as the reference's."""

    def __init__(self, dim: int, hidden_dim: int = 100,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = Dense(2 * dim, hidden_dim, generator)
        self.fc2 = Dense(hidden_dim, 1, generator)

    def forward(self, hist: torch.Tensor, cand: torch.Tensor,
                hist_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, h, d = hist.shape
        c = cand.shape[1]
        x = torch.cat([cand[:, :, None, :].expand(b, c, h, d),
                       hist[:, None].expand(b, c, h, d)], dim=-1)
        logits = self.fc2(self.fc1(x))[..., 0]  # (B, C, H)
        key_mask = None if hist_mask is None else hist_mask[:, None].expand(b, c, h)
        return masked_softmax(logits, key_mask) @ hist


class MINSUserEncoder(nn.Module):
    """MHSA with ``num_gru_channels`` heads, then the output split into that
    many channels, each through the same GRU (one weight set, as the JAX
    package's), then additive attention over the one concatenated vector.
    The channels run as one GRU over a batch of C B sequences, which is the
    same arithmetic."""

    def __init__(self, news_embed_dim: int = 400, query_dim: int = 200, num_filters: int = 400,
                 num_gru_channels: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_filters % num_gru_channels or news_embed_dim % num_gru_channels:
            raise ValueError(f"{num_gru_channels} channels do not divide {news_embed_dim} / "
                             f"{num_filters}")
        self.channels = num_gru_channels
        self.mhsa = MultiHeadSelfAttention(news_embed_dim, num_gru_channels, generator)
        self.gru = MaskedGRU(news_embed_dim // num_gru_channels,
                             num_filters // num_gru_channels, generator)
        self.add_att = AdditiveAttention(num_filters, query_dim, generator)

    def forward(self, hist: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = hist.shape[0]
        x = self.mhsa(hist, mask)
        chunks = torch.cat(x.chunk(self.channels, dim=-1), dim=0)  # (C B, H, D / C)
        m = None if mask is None else mask.repeat(self.channels, 1)
        h = self.gru(chunks, m)  # (C B, F / C)
        multi = torch.cat(h.split(b, dim=0), dim=-1)  # (B, F)
        return self.add_att(multi[:, None, :])


class CenNewsRecUserEncoder(nn.Module):
    """Long-term interest (MHSA, dropout, additive attention over the whole
    history) and short-term interest (the GRU's last valid state over the
    last ``num_recent_news`` history slots), fused by additive attention."""

    def __init__(self, num_filters: int = 300, num_heads: int = 15, query_dim: int = 200,
                 gru_hidden_dim: int = 300, num_recent_news: int = 20, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if gru_hidden_dim != num_filters:
            raise ValueError(f"the GRU's {gru_hidden_dim} must equal the news width "
                             f"{num_filters}: the two interests are stacked")
        self.num_recent_news = num_recent_news
        self.mhsa = MultiHeadSelfAttention(num_filters, num_heads, generator)
        self.dropout = Dropout(dropout)
        self.add_att = AdditiveAttention(num_filters, query_dim, generator)
        self.gru = MaskedGRU(num_filters, gru_hidden_dim, generator)
        self.final_add_att = AdditiveAttention(gru_hidden_dim, query_dim, generator)

    def forward(self, hist: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(self.mhsa(hist, mask), deterministic, generator)
        longterm = self.add_att(x, mask)
        n = self.num_recent_news
        shortterm = self.gru(hist[:, -n:], None if mask is None else mask[:, -n:])
        return self.final_add_att(torch.stack([shortterm, longterm], dim=1))


class CAUMUserEncoder(nn.Module):
    """Candidate-aware user encoder; returns the scores: hist (B, H, D),
    cand (B, C, D) -> (B, C).  The candidates fold into the batch: the
    neighbour window (circular over the padded history, ``torch.roll`` as
    ``jnp.roll``), the candidate-conditioned self-attention (its MHSA sees
    (B C, H, user_vector_dim)) and the dense attention all run on
    (B, C, H, .) tensors in one pass."""

    def __init__(self, news_embed_dim: int = 400, num_filters: int = 400,
                 dense_att_hidden_dim1: int = 400, dense_att_hidden_dim2: int = 256,
                 user_vector_dim: int = 400, num_heads: int = 4, dropout: float = 0.2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.linear1 = Dense(4 * news_embed_dim, num_filters, generator)
        self.linear2 = Dense(2 * news_embed_dim, user_vector_dim, generator)
        self.mhsa = MultiHeadSelfAttention(user_vector_dim, num_heads, generator)
        self.linear3 = Dense(num_filters + user_vector_dim, user_vector_dim, generator)
        self.dense_att = DenseAttention(user_vector_dim + news_embed_dim, dense_att_hidden_dim1,
                                        dense_att_hidden_dim2, generator)

    def forward(self, hist: torch.Tensor, cand: torch.Tensor,
                mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, h, d = hist.shape
        c = cand.shape[1]
        cand = self.dropout(cand, deterministic, generator)
        hist = self.dropout(hist, deterministic, generator)

        def over_candidates(x):  # (B, H, D) -> (B, C, H, D)
            return x[:, None].expand(b, c, h, d)

        hist_e = over_candidates(hist)
        cand_e = cand[:, :, None, :].expand(b, c, h, d)
        left = over_candidates(torch.roll(hist, shifts=1, dims=1))
        right = over_candidates(torch.roll(hist, shifts=-1, dims=1))
        hist_cnn = self.linear1(torch.cat([left, hist_e, right, cand_e], dim=-1))

        hist_cat = self.linear2(torch.cat([cand_e, hist_e], dim=-1))
        key_mask = None if mask is None else mask[:, None].expand(b, c, h)
        hist_self = self.mhsa(hist_cat, key_mask)
        hist_all = self.linear3(self.dropout(torch.cat([hist_cnn, hist_self], dim=-1),
                                             deterministic, generator))

        logits = self.dense_att(torch.cat([hist_all, cand_e], dim=-1))[..., 0]
        weights = masked_softmax(logits, key_mask)  # (B, C, H)
        user_vec = (weights.unsqueeze(-2) @ hist_all).squeeze(-2)  # (B, C, D_u)
        return (cand * user_vec).sum(dim=-1)
