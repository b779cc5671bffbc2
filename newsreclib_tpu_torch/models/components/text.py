"""Text encoders: ``(U, L)`` token ids -> ``(U, D)`` article vectors
(counterpart of ``newsreclib_tpu/models/components/text.py``): the NRMS
title encoder ``MHSAAddAtt`` (``:33-92``, unpacked path), the NAML / TANR /
LSTUR encoder ``CNNAddAtt`` (``:94-116``), CenNewsRec's ``CNNMHSAAddAtt``
(``:119-144``) and NPA's ``CNNPersAtt`` (``:147-180``).

The JAX package packs several titles into one attention sequence on the TPU
(``pack_to``); that is exact (``test_mhsa_packing_exact``) and the per-article
CUDA kernel has no use for it, so the port encodes each title on its own.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from newsreclib_tpu_torch.models.components.attention import (
    AdditiveAttention,
    MultiHeadSelfAttention,
    PersonalizedAttention,
)
from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding
from newsreclib_tpu_torch.models.components.linear import lecun_normal


class MHSAAddAtt(nn.Module):
    """embed -> dropout -> MHSA -> dropout -> additive attention:
    ``(U, L)`` token ids -> ``(U, D)`` article vectors."""

    def __init__(self, vocab_size: int, embed_dim: int = 300, num_heads: int = 15,
                 query_dim: int = 200, dropout: float = 0.2,
                 pretrained: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = TokenEmbedding(vocab_size, embed_dim, pretrained, generator=generator)
        self.dropout = Dropout(dropout)
        self.mhsa = MultiHeadSelfAttention(embed_dim, num_heads, generator)
        self.add_att = AdditiveAttention(embed_dim, query_dim, generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Dropout is on when ``deterministic`` is False and then draws from
        ``generator`` (``components/dropout.py``)."""
        x = self.dropout(self.embedding(tokens), deterministic, generator)
        x = self.dropout(self.mhsa(x, mask), deterministic, generator)
        return self.add_att(x, mask)


class Conv1d(nn.Module):
    """flax ``nn.Conv`` over (U, L, C) with SAME padding and flax's init
    (lecun-normal over fan-in C * W, zero bias).  The JAX kernel of shape
    (W, in, out) is this layer's ``weight`` (out, in, W), its reversed
    transpose, as ``convert.flax_to_state_dict`` maps every ``kernel``.

    It runs as one matrix product of the W shifted copies of the input,
    stacked along the channels, with the kernel as a (W C, out) matrix: the
    same sums.  cuDNN's float32 convolution picked an FFT algorithm for
    CenNewsRec's (U, 30, 300) -> 400 titles on the H100, 28 of 48 device ms
    of a batch-64 train step and 21.9 GB of memory (PERF.md, §5)."""

    def __init__(self, in_channels: int, out_channels: int, window: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((out_channels, in_channels, window),
                                                in_channels * window, generator))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, c, w = self.weight.shape
        l = x.shape[1]
        xp = F.pad(x, (0, 0, (w - 1) // 2, w // 2))  # SAME: the extra pad on the right
        cols = torch.cat([xp[:, k:k + l] for k in range(w)], dim=-1)  # (U, L, W C)
        return F.linear(cols, self.weight.permute(0, 2, 1).reshape(out, w * c), self.bias)


class CNNAddAtt(nn.Module):
    """NAML text encoder: embed -> dropout -> conv (SAME) -> relu -> dropout
    -> additive attention: ``(U, L)`` token ids -> ``(U, num_filters)``."""

    def __init__(self, vocab_size: int, embed_dim: int = 300, num_filters: int = 400,
                 window_size: int = 3, query_dim: int = 200, dropout: float = 0.2,
                 pretrained: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = TokenEmbedding(vocab_size, embed_dim, pretrained, generator=generator)
        self.dropout = Dropout(dropout)
        self.cnn = Conv1d(embed_dim, num_filters, window_size, generator)
        self.add_att = AdditiveAttention(num_filters, query_dim, generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(self.embedding(tokens), deterministic, generator)
        x = self.dropout(torch.relu(self.cnn(x)), deterministic, generator)
        return self.add_att(x, mask)


class CNNMHSAAddAtt(nn.Module):
    """CenNewsRec text encoder: embed -> dropout -> conv (SAME) -> relu ->
    dropout -> MHSA -> dropout -> additive attention.  Its attention runs
    through the kernel at (U, L, num_filters), 20 heads of 20 at the
    config's widths."""

    def __init__(self, vocab_size: int, embed_dim: int = 300, num_filters: int = 300,
                 window_size: int = 3, num_heads: int = 15, query_dim: int = 200,
                 dropout: float = 0.2, pretrained: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = TokenEmbedding(vocab_size, embed_dim, pretrained, generator=generator)
        self.dropout = Dropout(dropout)
        self.cnn = Conv1d(embed_dim, num_filters, window_size, generator)
        self.mhsa = MultiHeadSelfAttention(num_filters, num_heads, generator)
        self.add_att = AdditiveAttention(num_filters, query_dim, generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(self.embedding(tokens), deterministic, generator)
        x = self.dropout(torch.relu(self.cnn(x)), deterministic, generator)
        x = self.dropout(self.mhsa(x, mask), deterministic, generator)
        return self.add_att(x, mask)


class CNNPersAtt(nn.Module):
    """NPA text encoder: embed -> dropout -> conv (SAME) -> relu -> dropout
    -> personalized attention with one query per row: ``(U, L)`` token ids
    and ``(U, Dq)`` queries -> ``(U, num_filters)``."""

    def __init__(self, vocab_size: int, query_dim: int, embed_dim: int = 300,
                 num_filters: int = 400, window_size: int = 3, dropout: float = 0.2,
                 pretrained: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = TokenEmbedding(vocab_size, embed_dim, pretrained, generator=generator)
        self.dropout = Dropout(dropout)
        self.cnn = Conv1d(embed_dim, num_filters, window_size, generator)
        self.pers_att = PersonalizedAttention(query_dim, num_filters, generator)

    def forward(self, tokens: torch.Tensor, user_query: torch.Tensor,
                mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(self.embedding(tokens), deterministic, generator)
        x = self.dropout(torch.relu(self.cnn(x)), deterministic, generator)
        return self.pers_att(user_query, x, mask)
