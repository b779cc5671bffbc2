"""Model factory: the ``model`` config node and the dataset's sizes -> model
and loss (counterpart of ``newsreclib_tpu/models/factory.py``).

The twelve models of ``PORTED_MODELS`` have ``build_model`` routes, with the
JAX factory's defaults (``newsreclib_tpu/models/factory.py:155-338``);
SentiDebias's generator / discriminator pair comes from
``build_senti_debias`` and MANNeR's A-module from ``build_manner_a``, as in
the JAX package (MANNeR's ensemble is composed by ``eval.py``).  With
``use_plm`` every route but NPA's and DKN's (which, as in the JAX factory,
have none) takes the PLM text tower (``components/plm.py``) of
``_build_plm_tower``, its weights loaded from a local Hugging Face checkpoint
directory ``plm_model`` or drawn at random when ``plm_model`` is not one
(nothing is fetched).
``pack_titles`` and ``plm_pack_titles`` are accepted and ignored: the port's
attention kernel works per article, and packed and unpacked titles give the
same vectors (``tests/test_nrms.py::test_mhsa_packing_exact``,
``tests/test_plm.py::test_plm_packing_exact``).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from newsreclib_tpu_torch.models import fair_rec
from newsreclib_tpu_torch.models.components.losses import get_loss_fn
from newsreclib_tpu_torch.models.components.plm import (
    PLMTextEncoder,
    TransformerEncoder,
    load_hf_torch_weights,
)
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

log = logging.getLogger("newsreclib_tpu_torch")


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
                 "miner", "dkn", "sentirec", "manner_cr")
# models with a builder of their own, not ``build_model``
OWN_BUILDERS = {"senti_debias": "build_senti_debias (model.adversarial: true)",
                "manner_a": "build_manner_a (training/aspect.py)",
                "manner": "newsreclib_tpu_torch.eval (the ensemble of trained modules)"}


def title_split_margin(model_name: str, model_cfg: Optional[Dict] = None) -> int:
    """Title headroom a model needs past the last token for exact length
    trimming and splitting: DKN's VALID convolutions need the widest window,
    every other model 0."""
    if model_name != "dkn":
        return 0
    return int(max((model_cfg or {}).get("window_sizes", (1, 2, 3, 4))))


def _build_plm_tower(cfg: Dict, generator: torch.Generator, towers: str = "encoder"):
    """``(PLMTextEncoder, its width)`` of the ``model`` node ``cfg``
    (``newsreclib_tpu/models/factory.py:42-91``).  ``plm_model`` a local
    Hugging Face checkpoint directory: the tower's encoder takes its
    configuration and weights; anything else (a hub name such as
    ``roberta-base``, ``__random_init__``): random initialisation at the
    config's widths, with the JAX factory's warning."""
    plm_name = cfg.get("plm_model", "roberta-base")
    state = None
    if os.path.isdir(plm_name):
        state, kwargs = load_hf_torch_weights(plm_name)
    else:
        log.warning(
            "PLM weights for %r unavailable (not a local checkpoint directory; nothing is "
            "fetched); using RANDOM initialization — fine for pipeline tests, useless for "
            "accuracy", plm_name)
        kwargs = dict(
            vocab_size=cfg.get("plm_vocab_size", 50265),
            hidden_dim=cfg.get("embed_dim", 768),
            num_layers=cfg.get("plm_num_layers", 12),
            num_heads=cfg.get("plm_num_heads", 12),
            intermediate_dim=4 * cfg.get("embed_dim", 768),
            max_position=cfg.get("plm_max_position", 512),
        )
    encoder = TransformerEncoder(**kwargs, generator=generator)
    if state is not None:
        encoder.load_state_dict(state)
        log.info("spliced ported PLM weights into 1 %s towers", towers)
    tower = PLMTextEncoder(
        encoder,
        use_mhsa=cfg.get("plm_use_mhsa", True),
        num_heads=cfg.get("num_heads", 16),
        query_dim=cfg.get("query_dim", 200),
        apply_reduce_dim=cfg.get("apply_reduce_dim", False),
        reduced_embed_dim=cfg.get("news_embed_dim"),
        dropout=cfg.get("dropout_probability", 0.2),
        pack_to=cfg.get("plm_pack_titles", 128),
        generator=generator,
    )
    return tower, tower.out_dim


def _plm_kwargs(cfg: Dict, generator: torch.Generator, towers: str = "encoder") -> Dict:
    """The tower keywords of a model constructor: none without ``use_plm``."""
    if not cfg.get("use_plm"):
        return {}
    tower, dim = _build_plm_tower(cfg, generator, towers)
    return {"text_encoder_module": tower, "text_encoder_dim": dim}


def build_model(cfg: Dict, info: DataInfo, device: Union[str, torch.device] = "cuda",
                seed: int = 0):
    """The model of ``cfg`` (the ``model`` node, with ``name``), its weights
    drawn from ``torch.Generator().manual_seed(seed)`` (the PLM tower's
    first, with ``use_plm``) and moved to ``device``."""
    name = cfg["name"]
    d = cfg.get("dropout_probability", 0.2)
    rng = torch.Generator().manual_seed(seed)
    plm = {} if name in ("npa", "dkn") else _plm_kwargs(cfg, rng)
    common = dict(late_fusion=cfg.get("late_fusion", False),
                  pretrained_embeddings=info.pretrained_embeddings, device=device,
                  generator=rng, **plm)
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
            # the GRU's state is stacked with the news vectors: the tower's width
            gru_hidden_dim=cfg.get("gru_hidden_dim", plm.get("text_encoder_dim") or 400),
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
    if name == "sentirec":
        return fair_rec.SentiRec(
            info.vocab_size,
            embed_dim=cfg.get("embed_dim", 300),
            num_heads=cfg.get("num_heads", 15),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            sent_pred_loss_coef=cfg.get("sent_pred_loss_coef", 0.4),
            sent_div_loss_coef=cfg.get("sent_div_loss_coef", 10.0),
            **common,
        )
    if name == "manner_cr":
        return fair_rec.MANNeRCR(
            info.vocab_size,
            entity_vocab_size=info.entity_vocab_size,
            use_entities=cfg.get("use_entities", True),
            text_embed_dim=cfg.get("text_embed_dim", 300),
            entity_embed_dim=cfg.get("entity_embed_dim", 100),
            num_heads=cfg.get("num_heads", 15),
            query_dim=cfg.get("query_dim", 200),
            dropout=d,
            late_fusion=cfg.get("late_fusion", True),
            remat=cfg.get("remat", False),
            pretrained_embeddings=info.pretrained_embeddings,
            pretrained_entity_embeddings=info.pretrained_entity_embeddings,
            device=device,
            generator=rng,
            **plm,
        )
    if name in OWN_BUILDERS:
        raise ValueError(f"model {name!r} is built by {OWN_BUILDERS[name]}, not build_model")
    raise ValueError(f"unknown model: {name!r}; build_model builds {', '.join(PORTED_MODELS)}")


def build_manner_a(cfg: Dict, info: DataInfo, device: Union[str, torch.device] = "cuda",
                   seed: int = 0) -> fair_rec.MANNeRA:
    """MANNeR's A-module (``newsreclib_tpu/models/factory.py:340``), trained
    by ``training/aspect.py::run_aspect_training``, not on slates."""
    rng = torch.Generator().manual_seed(seed)
    return fair_rec.MANNeRA(
        info.vocab_size,
        entity_vocab_size=info.entity_vocab_size,
        use_entities=cfg.get("use_entities", True),
        text_embed_dim=cfg.get("text_embed_dim", 300),
        entity_embed_dim=cfg.get("entity_embed_dim", 100),
        num_heads=cfg.get("num_heads", 15),
        query_dim=cfg.get("query_dim", 200),
        dropout=cfg.get("dropout_probability", 0.2),
        pretrained_embeddings=info.pretrained_embeddings,
        pretrained_entity_embeddings=info.pretrained_entity_embeddings,
        device=device,
        generator=rng,
        **_plm_kwargs(cfg, rng),
    )


def build_senti_debias(cfg: Dict, info: DataInfo, device: Union[str, torch.device] = "cuda",
                       seed: int = 0):
    """SentiDebias's ``(generator, discriminator)``
    (``newsreclib_tpu/models/factory.py:366``), trained by
    ``training/adversarial.py``; the discriminator's weights come from the
    same generator of random numbers, after the generator's."""
    rng = torch.Generator().manual_seed(seed)
    plm = _plm_kwargs(cfg, rng, towers="generator")
    # the discriminator reads the news tower's vectors
    embed_dim = plm.get("text_encoder_dim") or cfg.get("embed_dim", 300)
    gen = fair_rec.SentiDebiasGenerator(
        info.vocab_size,
        num_sent_classes=info.num_sent_classes - 1,
        embed_dim=embed_dim,
        num_heads=cfg.get("num_heads", 15),
        query_dim=cfg.get("query_dim", 200),
        sent_embed_dim=cfg.get("sent_embed_dim", 64),
        dropout=cfg.get("dropout_probability", 0.2),
        late_fusion=cfg.get("late_fusion", False),
        pretrained_embeddings=info.pretrained_embeddings,
        device=device,
        generator=rng,
        **plm,
    )
    disc = fair_rec.SentiDebiasDiscriminator(
        embed_dim,
        hidden_dim=cfg.get("discriminator_hidden_dim", 128),
        num_sent_classes=info.num_sent_classes - 1,
        device=device,
        generator=rng,
    )
    return gen, disc


def build_loss(cfg: Dict) -> Callable:
    return get_loss_fn(
        cfg.get("loss", "cross_entropy_loss"),
        temperature=cfg.get("temperature") or 0.1,
        dual_loss_coef=cfg.get("dual_loss_coef") or 0.5,
    )


def load_data_info(mind_data, cfg_model: Dict) -> DataInfo:
    """DataInfo of a dataset (``MINDData``, ``AdressaData``, ``XMINDData``):
    sizes from its maps, matrices from the train split's
    ``transformed_*_embeddings.npy``; xMIND's word matrix is its extended
    one (``XMINDData.ensure_word_embeddings``), as in the JAX factory."""
    classes = mind_data.num_classes()
    use_pretrained_w = cfg_model.get("use_pretrained_embeddings", True)
    train_dir = mind_data.split_dir("train")
    word_dir = (
        mind_data.ensure_word_embeddings()
        if use_pretrained_w and hasattr(mind_data, "ensure_word_embeddings")
        else None
    ) or train_dir

    def npy(name: str, wanted: bool = True) -> Optional[np.ndarray]:
        path = os.path.join(word_dir if name == "word" else train_dir,
                            f"transformed_{name}_embeddings.npy")
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
