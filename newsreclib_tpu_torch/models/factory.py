"""Model factory: the ``model`` config node and the dataset's sizes -> model
and loss (counterpart of ``newsreclib_tpu/models/factory.py``).

The ten models of ``PORTED_MODELS`` have routes, with the JAX factory's
defaults (``newsreclib_tpu/models/factory.py:155-303``); the FairRec models
raise ``NotImplementedError`` (ROADMAP queue 1, "FairRec models").
``pack_titles`` is accepted and ignored: the port's attention kernel works
per article, and packed and unpacked titles give the same vectors
(``tests/test_nrms.py::test_mhsa_packing_exact``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from newsreclib_tpu_torch.models.components.losses import get_loss_fn
from newsreclib_tpu_torch.models.general_rec import (
    CAUM,
    DKN,
    LSTUR,
    MINER,
    MINS,
    NAML,
    NPA,
    NRMS,
    TANR,
    CenNewsRec,
)


@dataclass
class DataInfo:
    vocab_size: int
    num_users: int = 1
    num_categories: int = 19
    num_subcategories: int = 1
    num_sent_classes: int = 4
    entity_vocab_size: int = 1
    pretrained_embeddings: Optional[np.ndarray] = None
    pretrained_entity_embeddings: Optional[np.ndarray] = None
    pretrained_categ_embeddings: Optional[np.ndarray] = None


PORTED_MODELS = ("nrms", "mins", "cen_news_rec", "caum", "naml", "tanr", "lstur", "npa",
                 "miner", "dkn")


def title_split_margin(model_name: str, model_cfg: Optional[Dict] = None) -> int:
    """Title headroom a model needs past the last token for exact length
    trimming and splitting: DKN's VALID convolutions need the widest window,
    every other model 0."""
    if model_name != "dkn":
        return 0
    return int(max((model_cfg or {}).get("window_sizes", (1, 2, 3, 4))))


def build_model(cfg: Dict, info: DataInfo, device: Union[str, torch.device] = "cuda",
                seed: int = 0):
    """The model of ``cfg`` (the ``model`` node, with ``name``), its weights
    drawn from ``torch.Generator().manual_seed(seed)`` and moved to
    ``device``."""
    name = cfg["name"]
    if cfg.get("use_plm"):
        raise NotImplementedError(
            'the PLM text tower (model.use_plm) is not ported yet (ROADMAP queue 1, "PLM tower")')
    d = cfg.get("dropout_probability", 0.2)
    common = dict(late_fusion=cfg.get("late_fusion", False),
                  pretrained_embeddings=info.pretrained_embeddings, device=device,
                  generator=torch.Generator().manual_seed(seed))
    if name == "nrms":
        return NRMS(
            info.vocab_size,
            embed_dim=cfg.get("embed_dim", 300),
            num_heads=cfg.get("num_heads", 15),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            **common,
        )
    if name == "mins":
        return MINS(
            info.vocab_size,
            num_categories=info.num_categories,
            attributes2encode=tuple(cfg.get("attributes2encode",
                                            ("title", "abstract", "category"))),
            text_embed_dim=cfg.get("text_embed_dim", 300),
            categ_embed_dim=cfg.get("categ_embed_dim", 100),
            num_heads=cfg.get("num_heads", 15),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            num_filters=cfg.get("num_filters"),
            num_gru_channels=cfg.get("num_gru_channels", 6),
            **common,
        )
    if name == "cen_news_rec":
        return CenNewsRec(
            info.vocab_size,
            embed_dim=cfg.get("embed_dim", 300),
            num_heads=cfg.get("num_heads", 20),
            num_filters=cfg.get("num_filters", 400),
            window_size=cfg.get("window_size", 3),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            gru_hidden_dim=cfg.get("gru_hidden_dim", 400),
            num_recent_news=cfg.get("num_recent_news", 20),
            **common,
        )
    if name == "caum":
        return CAUM(
            info.vocab_size,
            entity_vocab_size=info.entity_vocab_size,
            num_categories=info.num_categories,
            attributes2encode=tuple(cfg.get("attributes2encode",
                                            ("title", "category", "title_entities"))),
            text_embed_dim=cfg.get("text_embed_dim", 300),
            text_num_heads=cfg.get("text_num_heads", 20),
            categ_embed_dim=cfg.get("categ_embed_dim", 100),
            news_embed_dim=cfg.get("news_embed_dim", 400),
            entity_embed_dim=cfg.get("entity_embed_dim", 100),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            user_vector_dim=cfg.get("user_vector_dim", 400),
            num_filters=cfg.get("num_filters", 400),
            dense_att_hidden_dim1=cfg.get("dense_att_hidden_dim1", 400),
            dense_att_hidden_dim2=cfg.get("dense_att_hidden_dim2", 256),
            pretrained_entity_embeddings=info.pretrained_entity_embeddings,
            **common,
        )
    if name == "naml":
        return NAML(
            info.vocab_size,
            num_categories=info.num_categories,
            attributes2encode=tuple(cfg.get("attributes2encode",
                                            ("title", "abstract", "category"))),
            text_embed_dim=cfg.get("text_embed_dim", 300),
            categ_embed_dim=cfg.get("categ_embed_dim", 100),
            num_filters=cfg.get("num_filters", 400),
            window_size=cfg.get("window_size", 3),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            **common,
        )
    if name == "tanr":
        return TANR(
            info.vocab_size,
            num_categories=info.num_categories,
            embed_dim=cfg.get("embed_dim", 300),
            num_heads=cfg.get("num_heads", 15),
            num_filters=cfg.get("num_filters", 400),
            window_size=cfg.get("window_size", 3),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            topic_pred_loss_coef=cfg.get("topic_pred_loss_coef", 0.2),
            **common,
        )
    if name == "lstur":
        return LSTUR(
            info.vocab_size,
            num_users=info.num_users,
            num_categories=info.num_categories,
            attributes2encode=tuple(cfg.get("attributes2encode",
                                            ("title", "abstract", "category"))),
            text_embed_dim=cfg.get("text_embed_dim", 300),
            categ_embed_dim=cfg.get("categ_embed_dim", 100),
            num_filters=cfg.get("num_filters", 300),
            window_size=cfg.get("window_size", 3),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            user_masking_probability=cfg.get("user_masking_probability", 0.5),
            long_short_term_method=cfg.get("long_short_term_method", "ini"),
            **common,
        )
    if name == "npa":
        return NPA(
            info.vocab_size,
            num_users=info.num_users,
            text_embed_dim=cfg.get("text_embed_dim", 300),
            user_embed_dim=cfg.get("user_embed_dim", 50),
            num_filters=cfg.get("num_filters", 400),
            window_size=cfg.get("window_size", 3),
            word_pref_query_dim=cfg.get("word_pref_query_dim", 200),
            news_pref_query_dim=cfg.get("news_pref_query_dim", 200),
            dropout=d,
            **common,
        )
    if name == "miner":
        return MINER(
            info.vocab_size,
            num_categories=info.num_categories,
            text_embed_dim=cfg.get("text_embed_dim", 300),
            news_embed_dim=cfg.get("news_embed_dim", 256),
            num_heads=cfg.get("num_heads", 15),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            use_categ_bias=cfg.get("use_categ_bias", True),
            categ_embed_dim=cfg.get("categ_embed_dim", 100),
            num_context_codes=cfg.get("num_context_codes", 32),
            context_code_dim=cfg.get("context_code_dim", 200),
            score_type=cfg.get("score_type", "weighted"),
            pretrained_categ_embeddings=info.pretrained_categ_embeddings,
            **common,
        )
    if name == "dkn":
        return DKN(
            info.vocab_size,
            entity_vocab_size=info.entity_vocab_size,
            text_embed_dim=cfg.get("text_embed_dim", 300),
            entity_embed_dim=cfg.get("entity_embed_dim", 100),
            num_filters=cfg.get("num_filters", 100),
            window_sizes=tuple(cfg.get("window_sizes", (1, 2, 3, 4))),
            use_context=cfg.get("use_context", True),
            use_entities=cfg.get("use_entities", True),
            hidden_dim_dnn=cfg.get("hidden_dim_dnn", 16),
            pretrained_entity_embeddings=info.pretrained_entity_embeddings,
            **common,
        )
    raise NotImplementedError(
        f'model {name!r} is not ported yet (ROADMAP queue 1, "FairRec models"); the port '
        f"builds {', '.join(PORTED_MODELS)}")


def build_loss(cfg: Dict) -> Callable:
    return get_loss_fn(
        cfg.get("loss", "cross_entropy_loss"),
        temperature=cfg.get("temperature") or 0.1,
        dual_loss_coef=cfg.get("dual_loss_coef") or 0.5,
    )


def load_data_info(mind_data, cfg_model: Dict) -> DataInfo:
    """DataInfo of a ``MINDData`` (sizes from its id maps, matrices from the
    train split's ``transformed_*_embeddings.npy``)."""
    classes = mind_data.num_classes()
    use_pretrained_w = cfg_model.get("use_pretrained_embeddings", True)
    train_dir = mind_data.split_dir("train")

    def npy(name: str, wanted: bool = True) -> Optional[np.ndarray]:
        path = os.path.join(train_dir, f"transformed_{name}_embeddings.npy")
        return np.load(path) if wanted and os.path.exists(path) else None

    return DataInfo(
        vocab_size=mind_data.vocab_size(),
        num_users=mind_data.num_users(),
        num_categories=classes["category"],
        num_subcategories=classes["subcategory"],
        num_sent_classes=classes["sentiment"],
        entity_vocab_size=classes["entity"],
        pretrained_embeddings=npy("word", use_pretrained_w),
        pretrained_entity_embeddings=npy("entity"),
        pretrained_categ_embeddings=npy("categ"),
    )
