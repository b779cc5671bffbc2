"""News encoder composition shell and the entity encoder (counterpart of
``newsreclib_tpu/models/components/news.py:28-125``).

``NewsEncoder`` applies per-attribute encoders to a unique news table and
combines the per-attribute vectors.  As in the JAX package, one text
encoder instance serves title and abstract, one category encoder category
and subcategory, one entity encoder both entity lists.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.data.batch import NewsFeatures
from newsreclib_tpu_torch.models.components.attention import AdditiveAttention
from newsreclib_tpu_torch.models.components.dropout import Dropout
from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding
from newsreclib_tpu_torch.models.components.linear import Dense

# the attributes, in the order their vectors are combined
ATTRIBUTES = ("title", "abstract", "category", "subcategory", "title_entities",
              "abstract_entities")


class NewsEncoder(nn.Module):
    """Per-attribute encoders + combine: ``NewsFeatures`` (U rows) -> (U, D).

    ``text_dim``, ``category_dim``, ``entity_dim`` are the widths of the
    encoders' vectors.  ``combine_type`` is None (one attribute),
    ``"add_att"`` (additive attention over the stacked vectors, which must
    share a width; ``query_dim``), ``"linear"`` (Dense of the concatenation
    to ``output_dim``) or ``"concat"``."""

    def __init__(self, attributes2encode: Sequence[str],
                 text_encoder: Optional[nn.Module] = None,
                 category_encoder: Optional[nn.Module] = None,
                 entity_encoder: Optional[nn.Module] = None,
                 combine_type: Optional[str] = None, query_dim: Optional[int] = None,
                 output_dim: Optional[int] = None, text_dim: int = 0, category_dim: int = 0,
                 entity_dim: int = 0, generator: Optional[torch.Generator] = None):
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
        self.text_encoder = text_encoder if used & {"title", "abstract"} else None
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
