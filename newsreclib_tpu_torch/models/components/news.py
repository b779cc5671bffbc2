"""News encoder composition shell, the entity encoder and DKN's KCNN
(counterpart of ``newsreclib_tpu/models/components/news.py``).

``NewsEncoder`` applies per-attribute encoders to a unique news table and
combines the per-attribute vectors.  As in the JAX package, one text
encoder instance serves title and abstract, one category encoder category
and subcategory, one entity encoder both entity lists.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from newsreclib_tpu_torch.data.batch import NewsFeatures
from newsreclib_tpu_torch.models.components.attention import AdditiveAttention
from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding
from newsreclib_tpu_torch.models.components.linear import Dense, lecun_normal
from newsreclib_tpu_torch.models.components.plm import share

# the attributes, in the order their vectors are combined
ATTRIBUTES = ("title", "abstract", "category", "subcategory", "title_entities",
              "abstract_entities")


class NewsEncoder(nn.Module):
    """Per-attribute encoders + combine: ``NewsFeatures`` (U rows) -> (U, D).

    ``text_dim``, ``category_dim``, ``entity_dim`` are the widths of the
    encoders' vectors.  ``combine_type`` is None (one attribute),
    ``"add_att"`` (additive attention over the stacked vectors, which must
    share a width; ``query_dim``), ``"linear"`` (Dense of the concatenation
    to ``output_dim``) or ``"concat"``.  ``shared_text_encoder``: the text
    encoder is a PLM tower that the model registers (``plm.share``), called
    here, not owned."""

    def __init__(self, attributes2encode: Sequence[str],
                 text_encoder: Optional[nn.Module] = None,
                 category_encoder: Optional[nn.Module] = None,
                 entity_encoder: Optional[nn.Module] = None,
                 combine_type: Optional[str] = None, query_dim: Optional[int] = None,
                 output_dim: Optional[int] = None, text_dim: int = 0, category_dim: int = 0,
                 entity_dim: int = 0, generator: Optional[torch.Generator] = None,
                 shared_text_encoder: bool = False):
        super().__init__()
        unknown = set(attributes2encode) - set(ATTRIBUTES)
        if unknown:
            raise ValueError(f"unknown attributes {sorted(unknown)}")
        self.attributes = [a for a in ATTRIBUTES if a in set(attributes2encode)]
        if not self.attributes:
            raise ValueError("at least one attribute must be encoded")
        # an encoder no attribute uses is dropped, as flax creates no
        # parameters for a submodule that is never called
        used = set(self.attributes)
        text_encoder = text_encoder if used & {"title", "abstract"} else None
        if shared_text_encoder:
            share(self, "text_encoder", text_encoder)
        else:
            self.text_encoder = text_encoder
        self.category_encoder = category_encoder if used & {"category", "subcategory"} else None
        self.entity_encoder = (entity_encoder if used & {"title_entities", "abstract_entities"}
                               else None)
        self.combine_type = combine_type
        width = {"title": text_dim, "abstract": text_dim, "category": category_dim,
                 "subcategory": category_dim, "title_entities": entity_dim,
                 "abstract_entities": entity_dim}
        if len(self.attributes) > 1:
            if combine_type == "add_att":
                self.combine_add_att = AdditiveAttention(width[self.attributes[0]], query_dim,
                                                         generator)
            elif combine_type == "linear":
                self.combine_linear = Dense(sum(width[a] for a in self.attributes), output_dim,
                                            generator)
            elif combine_type != "concat":
                raise ValueError(f"invalid combine_type {combine_type!r}")

    def _encode(self, attr: str, news: NewsFeatures, deterministic: bool,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if attr in ("title", "abstract"):
            return self.text_encoder(getattr(news, attr), getattr(news, attr + "_mask"),
                                     deterministic, generator)
        if attr in ("category", "subcategory"):
            return self.category_encoder(getattr(news, attr), deterministic, generator)
        return self.entity_encoder(getattr(news, attr), getattr(news, attr + "_mask"),
                                   deterministic, generator)

    def forward(self, news: NewsFeatures, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        vectors = [self._encode(a, news, deterministic, generator) for a in self.attributes]
        if len(vectors) == 1:
            return vectors[0]
        if self.combine_type == "add_att":
            return self.combine_add_att(torch.stack(vectors, dim=1))
        if self.combine_type == "linear":
            return self.combine_linear(torch.cat(vectors, dim=-1))
        return torch.cat(vectors, dim=-1)


class EntityAddAtt(nn.Module):
    """Entity embedding -> dropout -> additive-attention pooling over the
    entity list: ``(U, L)`` ids + mask -> ``(U, embed_dim)``."""

    def __init__(self, vocab_size: int, embed_dim: int = 100, query_dim: int = 200,
                 dropout: float = 0.2, pretrained: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embedding = TokenEmbedding(vocab_size, embed_dim, pretrained, generator=generator)
        self.dropout = Dropout(dropout)
        self.add_att = AdditiveAttention(embed_dim, query_dim, generator)

    def forward(self, entities: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.dropout(self.embedding(entities), deterministic, generator)
        return self.add_att(x, mask)


class KCNN(nn.Module):
    """DKN's knowledge-aware CNN: ``(U, L)`` title tokens and entity ids, one
    entity slot per title word (padded with 0 or cut to the title width) ->
    ``(U, num_filters * len(window_sizes))``.

    The channels are the word embeddings, ``tanh(Dense)`` of the entity
    embeddings into the word space and, with ``use_context``, of a second
    (context) table over the same ids, drawn at random (no caller of the
    JAX package passes a pretrained one).  For each window w, a VALID
    convolution with a (w, word_embed_dim) kernel across the channels, relu
    and the max over the L - w + 1 positions; padded positions take part,
    as in the JAX package; then dropout 0.2 (fixed, as there).  ``mask`` is
    accepted and unused, as there.

    The JAX kernel ``conv_w{w}`` of shape (w, D, channels, F) is the weight
    (F, channels, D, w), its reversed transpose (``convert.py``).  Each
    convolution runs as one matrix product of the w shifted windows stacked
    along the features, as ``text.Conv1d`` does: the same sums, and no cuDNN
    algorithm choice (``Conv1d``'s doc)."""

    def __init__(self, word_vocab_size: int, entity_vocab_size: int, word_embed_dim: int = 300,
                 entity_embed_dim: int = 100, num_filters: int = 100,
                 window_sizes: Sequence[int] = (2, 3, 4), use_context: bool = False,
                 use_entities: bool = True, pretrained_words: Optional[np.ndarray] = None,
                 pretrained_entities: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.window_sizes = tuple(int(w) for w in window_sizes)
        self.use_entities = use_entities
        self.use_context = use_context and use_entities
        self.word_emb = TokenEmbedding(word_vocab_size, word_embed_dim, pretrained_words,
                                       generator=generator)
        if use_entities:
            self.entity_emb = TokenEmbedding(entity_vocab_size, entity_embed_dim,
                                             pretrained_entities, generator=generator)
            self.entity_transform = Dense(entity_embed_dim, word_embed_dim, generator)
        if self.use_context:
            self.context_emb = TokenEmbedding(entity_vocab_size, entity_embed_dim,
                                              generator=generator)
            self.context_transform = Dense(entity_embed_dim, word_embed_dim, generator)
        ch = 1 + use_entities + self.use_context
        for w in self.window_sizes:
            self.add_module(f"conv_w{w}", WindowConv(ch, word_embed_dim, num_filters, w,
                                                     generator))
        self.dropout = Dropout(0.2)

    def forward(self, tokens: torch.Tensor, entities: torch.Tensor,
                mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        l_tok, l_ent = tokens.shape[1], entities.shape[1]
        if l_ent < l_tok:
            entities = F.pad(entities, (0, l_tok - l_ent))
        elif l_ent > l_tok:
            entities = entities[:, :l_tok]
        channels = [self.word_emb(tokens)]
        if self.use_entities:
            channels.append(torch.tanh(self.entity_transform(self.entity_emb(entities))))
        if self.use_context:
            channels.append(torch.tanh(self.context_transform(self.context_emb(entities))))
        x = torch.stack(channels, dim=-1).flatten(2)  # (U, L, D ch), features (d, c)
        outs = [torch.relu(getattr(self, f"conv_w{w}")(x)).amax(dim=1)
                for w in self.window_sizes]
        return self.dropout(torch.cat(outs, dim=-1), deterministic, generator)


class WindowConv(nn.Module):
    """A VALID convolution with a (window, D) kernel over (U, L, D, channels)
    inputs given as (U, L, D channels), features ordered (d, c):
    -> (U, L - window + 1, out).  ``weight`` (out, channels, D, window) with
    flax's init (lecun-normal over fan-in window x D x channels, zero
    bias)."""

    def __init__(self, channels: int, dim: int, out_features: int, window: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(lecun_normal((out_features, channels, dim, window),
                                                window * dim * channels, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _, _, w = self.weight.shape
        n = x.shape[1] - w + 1
        cols = torch.cat([x[:, k:k + n] for k in range(w)], dim=-1)  # (U, n, w D ch)
        return F.linear(cols, self.weight.permute(0, 3, 2, 1).reshape(out, -1), self.bias)
