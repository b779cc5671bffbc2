"""Training entry point of the port (counterpart of the repository's
``train.py``): compose the config, run the ETL of MIND, Adressa or xMIND
(generating the configured fixture first where it is absent), build the
model, fit with early stopping and best / last checkpoints, test from the
best checkpoint, export every test user's candidate scores with
``save_recs=true`` (to ``recs_fpath``, default
``<output_dir>/recommendations.json``), and write ``metrics.csv``,
``hparams.json`` and ``config_tree.json`` under ``output_dir``.

    python -m newsreclib_tpu_torch.train experiment=nrms_statfix_celoss
    python -m newsreclib_tpu_torch.train experiment=nrms_demo platform=cpu \\
        data.data_dir=/tmp/demo output_dir=/tmp/run

It runs on the card (``cuda``) and raises without one; ``platform=cpu`` (or
``NEWSRECLIB_PLATFORM=cpu``) runs it on the CPU.  Precision follows
``trainer.precision``: float32 unless it names bf16.  Runs write under
``outputs/torch/`` unless ``output_dir`` is given.  The models of
``models/factory.py::PORTED_MODELS`` train here, SentiDebias
(``model.adversarial: true``) through ``training/adversarial.py`` and
MANNeR's A-module (``model=manner_a``) through ``training/aspect.py``, on
MIND, Adressa (one_week and three_month) and xMIND data, with the GloVe
text encoders or the PLM tower (``model.use_plm``, layer freezing by
``model.frozen_layers``), on word-level stores or, with ``data.use_plm``,
on stores tokenised by the local tokenizer directory ``data.plm_tokenizer``
(nothing is fetched); xMIND in PLM mode raises ``NotImplementedError``.

Several devices (``setup_parallelism``, the root ``train.py:178-213``), one
process per device:

* ``trainer.devices=N`` (N > 1, or ``all`` with more than one card; on the
  CPU, ``platform=cpu``, N ranks over gloo) starts N local ranks
  (``parallel/launch.py::spawn``); every rank builds the same global batch
  from the same batcher and seed and keeps its rows (JAX's single-host
  mesh).  N is clamped as JAX clamps it: to the cards present, then down
  until the data axis divides ``data.batch_size``.  Evaluation and
  ``save_recs`` are split over the data ranks as the JAX mesh splits them
  (``serving.py``, ``Trainer.evaluate``): every rank encodes its share of
  the corpus and scores its rows of every batch, and every rank gets the
  same metrics.  ``trainer.share_card=true`` (with an integer N) puts
  every rank on ``cuda:0`` over gloo, N not clamped to the cards: the
  multi-rank path on a one-card machine, for its checks.
* ``trainer.distributed=true``, or the variables torchrun sets (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``):
  multi-host mode, this process is one rank; each data rank takes a strided
  shard of the train impressions, its batcher seed is ``seed + 7919 x data
  rank``, epochs run in lockstep (``num_steps``) and batches carry global
  rows deduplicated on the device.  Multi-host adversarial (SentiDebias)
  training is refused, as in JAX.

``trainer.model_axis`` > 1 row-shards the embedding tables
(``trainer.row_shard_embeddings``, default true) and, with
``trainer.tp_transformer``, splits the PLM tower tensor-parallel over the
model ranks (``parallel/mesh.py``).  Training batches carry global rows
whenever there is more than one rank, or with ``data.global_rows``.  Each
rank uses ``cuda:<local rank>`` (NCCL) or the CPU (gloo); rank 0 alone
logs and writes checkpoints (and in multi-host mode evaluates and
exports), and ``run`` returns its metrics.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from newsreclib_tpu_torch.config.compose import CONFIG_DIR, compose
from newsreclib_tpu_torch.data.batching import EvalBatcher, TrainBatcher
from newsreclib_tpu_torch.data.mind import MINDConfig, MINDData
from newsreclib_tpu_torch.metrics.collector import RankingMetrics
from newsreclib_tpu_torch.models.components.plm import plm_freeze_labels
from newsreclib_tpu_torch.models.factory import (
    build_loss,
    build_model,
    load_data_info,
    title_split_margin,
)
from newsreclib_tpu_torch.training.loggers import make_loggers
from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer, param_count
from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

log = logging.getLogger("newsreclib_tpu_torch")

# the port's runs go beside, not into, the JAX package's outputs/<run>
DEFAULT_OVERRIDES = ("output_dir=outputs/torch/${model.name}_${data.name}",)


def _not_ported(what: str, item: str) -> NotImplementedError:
    """``item``: the name of the ROADMAP queue 1 item that ports ``what``."""
    return NotImplementedError(f'{what} is not ported yet (ROADMAP queue 1, "{item}")')


def platform_of(cfg: Dict) -> str:
    """``platform`` (or ``$NEWSRECLIB_PLATFORM``): ``cuda`` (absent, ``cuda``
    or ``gpu``) or ``cpu``."""
    platform = os.environ.get("NEWSRECLIB_PLATFORM") or cfg.get("platform") or "cuda"
    if platform == "gpu":
        return "cuda"
    if platform not in ("cuda", "cpu"):
        raise ValueError(f"unknown platform {platform!r}: the port runs on cuda or cpu")
    return platform


def select_device(cfg: Dict) -> torch.device:
    """The CPU for ``platform=cpu``; else the card, which must be present:
    ``cuda:<LOCAL_RANK>`` (made current) under a launcher, else ``cuda``."""
    if platform_of(cfg) == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; run with platform=cpu "
                           "(or NEWSRECLIB_PLATFORM=cpu) to train on the CPU")
    if "LOCAL_RANK" in os.environ:
        from newsreclib_tpu_torch.parallel.mesh import rank_device

        return rank_device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda")


def local_rank_count(cfg: Dict) -> int:
    """The ranks ``trainer.devices`` asks for on this node, clamped as the
    root ``train.py:195-206`` clamps them: ``all`` (the default) is every
    card (one on the CPU), an integer at most the cards present (any number
    of CPU ranks, or of ranks sharing one card with ``trainer.share_card``),
    then down until the data axis divides the batch and the model axis
    divides the count."""
    tc = cfg.get("trainer", {})
    want = tc.get("devices", "all")
    every = want in ("all", None, -1)
    if platform_of(cfg) == "cpu":
        n = 1 if every else int(want)
    elif tc.get("share_card") and not every:  # ranks sharing one card: as many as asked
        n = int(want)
    else:
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 1
        n = avail if every else min(int(want), avail)
    model_axis = int(tc.get("model_axis", 1))
    batch = int(cfg.get("data", {}).get("batch_size", n))
    while n > 1 and (batch % max(n // model_axis, 1) or n % model_axis):
        n -= 1
    if n % model_axis:
        raise ValueError(f"trainer.model_axis={model_axis} needs a multiple of "
                         f"{model_axis} devices; {n} available")
    return n


def setup_parallelism(cfg: Dict, rank: Optional[int] = None, world: Optional[int] = None):
    """This process's ``parallel/mesh.py::Mesh``, or None on one device.
    ``rank`` / ``world`` given: a rank of ``trainer.devices`` (single-node
    mode, the launcher's variables set); else multi-host mode when
    ``trainer.distributed`` or the launcher's variables ask for it."""
    from newsreclib_tpu_torch.parallel.mesh import env_rank, init_mesh, rank_device

    tc = cfg.get("trainer", {})
    single_node = rank is not None
    if not single_node:
        found = env_rank()
        if found is None:
            if tc.get("distributed"):
                raise RuntimeError(
                    "trainer.distributed=true needs RANK, WORLD_SIZE, MASTER_ADDR and "
                    "MASTER_PORT (as torchrun or newsreclib_tpu_torch.parallel.launch set "
                    "them)")
            return None
        rank, world, local_rank = found
    else:
        local_rank = rank
    shared = single_node and bool(tc.get("share_card")) and platform_of(cfg) == "cuda"
    device = rank_device(platform_of(cfg), 0 if shared else local_rank)
    # NCCL refuses two ranks on one card; gloo takes them
    mesh = init_mesh(rank, world, int(tc.get("model_axis", 1)), device,
                     backend="gloo" if shared else None, replicated_batches=single_node)
    log.info("rank %d of %d (%s mode): data %d of %d, model %d of %d, %s over %s", rank, world,
             "single-node" if single_node else "multi-host", mesh.data_index, mesh.data_size,
             mesh.model_index, mesh.model_axis, device, mesh.backend)
    return mesh


def check_dkn_title_split(model_name: str, dc: Dict) -> None:
    """DKN's KCNN aligns one entity id per title position and cuts the
    entities to the title width, so a short title segment narrower than the
    entity width would drop entity ids: refuse it, as the repository's
    ``train.py`` does."""
    split_len = dc.get("split_title_len", 16)
    if split_len is None or model_name != "dkn":
        return
    ents_w = dc.get("max_entities", 10)
    if split_len < ents_w:
        raise AssertionError(
            f"DKN needs data.split_title_len ({split_len}) >= data.max_entities ({ents_w}); "
            f"KCNN entity ids would be truncated in the short title segment")


def check_store_attributes(mc: Dict, store, dataset: str) -> None:
    """Refuse a model whose ``attributes2encode`` names a field the store
    lacks (an Adressa store holds no abstracts and no entities), with a
    message: the JAX package fails on such a model inside its first
    forward."""
    missing = [a for a in mc.get("attributes2encode") or ()
               if hasattr(store, a) and getattr(store, a) is None]
    if missing:
        raise ValueError(
            f"model.attributes2encode names {missing}, which the {dataset} store does not "
            f"hold; set model.attributes2encode to fields it has (e.g. [title, category])")


def plm_vocab_size(mc: Dict):
    """``(the PLM tower's vocabulary size, where it comes from)``: the
    checkpoint's ``config.json`` when ``model.plm_model`` is a local
    directory, else ``model.plm_vocab_size`` (``models/factory.py``)."""
    plm_model = mc.get("plm_model", "roberta-base")
    if os.path.isdir(plm_model):
        from newsreclib_tpu_torch.models.components.plm import encoder_config_from_hf

        with open(os.path.join(plm_model, "config.json")) as f:
            return encoder_config_from_hf(json.load(f))["vocab_size"], \
                f"{plm_model}/config.json"
    return int(mc.get("plm_vocab_size", 50265)), "model.plm_vocab_size"


def check_token_range(mc: Dict, store) -> None:
    """Refuse, for a model with the PLM tower, a store whose largest token id
    is not below the tower's vocabulary: the JAX package's embedding
    (``flax.linen.Embed``) reads NaN for such an id without a word, a CUDA
    gather asserts on the device."""
    if not mc.get("use_plm"):
        return
    largest = max(int(a.max()) for a in (store.title, store.abstract)
                  if a is not None and a.size)
    vocab, source = plm_vocab_size(mc)
    if largest >= vocab:
        raise ValueError(
            f"the news store holds token id {largest}, not below the PLM tower's vocabulary "
            f"of {vocab} ({source}); the tower would read past its embedding table: set "
            "model.plm_vocab_size (or model.plm_model) to the tokenizer's vocabulary")


def annotator_kwargs(cfg: Dict) -> Dict:
    """The sentiment annotator's keywords: ``data.sentiment_annotator_kwargs``,
    and for the BERT annotator the run's device (the card, or the CPU under
    ``platform=cpu``) unless they name one."""
    dc = cfg["data"]
    kwargs = dict(dc.get("sentiment_annotator_kwargs") or {})
    if dc.get("sentiment_annotator") == "bert":
        kwargs.setdefault("device", select_device(cfg).type)
    return kwargs


def setup_data(cfg: Dict):
    """The dataset of ``cfg["data"]`` (``MINDData``, ``AdressaData`` or
    ``XMINDData``, one interface), as the repository's ``train.py:35-135``
    builds it, generating a fixture first where ``generate_fixture`` asks
    for one and its raw file is absent: Adressa's ``statfix`` ->
    ``write_adressa_statfix`` (at its default seed 0, as there), any other
    value -> ``write_adressa_fixture``; MIND's ``statfix`` / ``statfix_v2``
    -> the statfix generators at the data seed, any other value ->
    ``write_mind_fixture``; xMIND's ``statfix`` also writes
    ``write_xmind_statfix``'s companion files.  ``data.use_plm`` tokenises
    with the local tokenizer directory ``data.plm_tokenizer`` at
    ``data.tokenizer_max_len``; xMIND with it raises
    ``NotImplementedError`` (the JAX package appends word-level ids of the
    translated news to the PLM store, and no config composes it)."""
    dc = cfg["data"]
    dataset = dc.get("dataset", "mind")
    fixture = dc.get("generate_fixture")
    plm = dict(use_plm=bool(dc.get("use_plm", False)), plm_tokenizer=dc.get("plm_tokenizer"),
               tokenizer_max_len=dc.get("tokenizer_max_len", 96))
    if dataset == "xmind" and plm["use_plm"]:
        raise NotImplementedError(
            "xMIND in PLM mode (data.use_plm with the xmind dataset) is refused: the JAX "
            "package appends word-level ids of the translated news to the PLM store "
            "(newsreclib_tpu/data/xmind.py:62-117), and no config composes it (ROADMAP §3)")

    if dataset == "adressa":
        from newsreclib_tpu_torch.data.adressa import AdressaConfig, AdressaData

        size = dc.get("dataset_size", "one_week")
        if fixture and not os.path.exists(os.path.join(dc["data_dir"], "one_week.tar.gz")):
            from newsreclib_tpu_torch.data import statfix, testing

            name = "write_adressa_statfix" if fixture == "statfix" else "write_adressa_fixture"
            writer = getattr(statfix if fixture == "statfix" else testing, name)
            _timed_fixture(name, lambda: writer(dc["data_dir"]), dc["data_dir"])
        return AdressaData(AdressaConfig(
            data_dir=dc["data_dir"],
            dataset_size=size,
            train_date_split=dc.get("train_date_split", 6),
            test_date_split=dc.get("test_date_split", 7),
            neg_num=dc.get("neg_num", 20),
            user_dev_size=dc.get("user_dev_size", 0.2),
            max_title_len=dc["max_title_len"],
            word_embeddings_fpath=dc.get("word_embeddings_fpath"),
            word_embed_dim=dc.get("word_embed_dim", 300),
            sentiment_annotator=dc.get("sentiment_annotator", "lexicon"),
            sentiment_annotator_kwargs=annotator_kwargs(cfg),
            download=dc.get("download", False),
            seed=dc.get("seed", 42),
            **plm,
        ))

    if dataset not in ("mind", "xmind"):
        raise _not_ported(f"the {dataset} dataset", "Other datasets")
    ensure_mind_fixture(dc)
    mind = MINDData(MINDConfig(
        data_dir=dc["data_dir"],
        dataset_size=dc["dataset_size"],
        valid_time_split=dc["valid_time_split"],
        max_title_len=dc["max_title_len"],
        max_abstract_len=dc["max_abstract_len"],
        max_entities=dc.get("max_entities", 10),
        entity_freq_threshold=dc.get("entity_freq_threshold", 2),
        entity_confidence_threshold=dc.get("entity_confidence_threshold", 0.5),
        word_embeddings_fpath=dc.get("word_embeddings_fpath"),
        word_embed_dim=dc.get("word_embed_dim", 300),
        sentiment_annotator=dc.get("sentiment_annotator", "lexicon"),
        sentiment_annotator_kwargs=annotator_kwargs(cfg),
        download=dc.get("download", False),
        seed=dc.get("seed", 0),
        **plm,
    ))
    if dataset == "mind":
        return mind
    from newsreclib_tpu_torch.data.xmind import XMINDConfig, XMINDData

    if fixture == "statfix":
        # the translated news and aligned embeddings of the statfix fixture
        from newsreclib_tpu_torch.data.statfix import write_xmind_statfix

        _timed_fixture("write_xmind_statfix", lambda: write_xmind_statfix(
            dc["data_dir"], lang=dc.get("tgt_lang", "fin")), dc["data_dir"])
    return XMINDData(mind, XMINDConfig(
        tgt_lang=dc.get("tgt_lang", "fin"),
        bilingual_train=dc.get("bilingual_train", False),
        bilingual_test=dc.get("bilingual_test", True),
        pct_tgt_lang_train=dc.get("pct_tgt_lang_train", 0.5),
        pct_tgt_lang_test=dc.get("pct_tgt_lang_test", 1.0),
        seed=dc.get("seed", 42),
    ))


def ensure_mind_fixture(dc: Dict) -> None:
    """Write the MIND fixture that the data node ``dc`` names
    (``generate_fixture``: ``statfix``, ``statfix_v2`` or any other for the
    small demo fixture) into ``data_dir``, unless its train news are there."""
    fixture = dc.get("generate_fixture")
    news_tsv = os.path.join(dc["data_dir"], f"MIND{dc['dataset_size']}_train", "news.tsv")
    if not fixture or os.path.exists(news_tsv):
        return
    from newsreclib_tpu_torch.data import statfix, testing

    seed = dc.get("seed", 42)
    writers = {
        "statfix": lambda: statfix.write_mind_small_statfix(dc["data_dir"], seed=seed),
        "statfix_v2": lambda: statfix.write_mind_small_statfix_v2(dc["data_dir"], seed=seed),
    }
    writer = writers.get(fixture, lambda: testing.write_mind_fixture(
        dc["data_dir"], dataset_size=dc["dataset_size"]))
    _timed_fixture(fixture if fixture in writers else "write_mind_fixture", writer,
                   dc["data_dir"])


def _timed_fixture(name: str, write, data_dir: str) -> None:
    t0 = time.time()
    write()
    log.info("%s: %.1f s (fixture under %s)", name, time.time() - t0, data_dir)


def build_optimizer(cfg: Dict, steps_per_epoch: int = 0, model: Optional[torch.nn.Module] = None):
    """The update rule of the ``model.optimizer`` node (lr, weight decay,
    cosine or linear-warmup schedule, gradient clipping); the schedule spans
    ``steps_per_epoch x trainer.max_epochs`` updates unless it names its
    ``total_steps``.  With ``use_plm`` and ``model.frozen_layers``, the PLM
    tower's layers of those indices (and its embeddings, unless
    ``freeze_plm_embeddings`` is false) are frozen in ``model``
    (``plm_freeze_labels``, as the root ``train.py:219-252``)."""
    mc = cfg["model"]
    opt_cfg = mc.get("optimizer", {})
    frozen_layers = mc.get("frozen_layers")
    freeze_labels = None
    if frozen_layers is not None and mc.get("use_plm"):
        if model is None:
            raise ValueError("freezing PLM layers needs the model")
        freeze_labels = plm_freeze_labels(
            (n for n, _ in model.named_parameters()), frozen_layers,
            freeze_embeddings=bool(mc.get("freeze_plm_embeddings", True)))
        log.info("PLM layers %s frozen%s: %d of %d parameter tensors", list(frozen_layers),
                 " with the embeddings" if mc.get("freeze_plm_embeddings", True) else "",
                 sum(v == "freeze" for v in freeze_labels.values()), len(freeze_labels))
    total_steps = opt_cfg.get("total_steps") or (
        steps_per_epoch * cfg["trainer"].get("max_epochs", 20))
    return make_optimizer(
        opt_cfg.get("lr", 1e-4),
        opt_cfg.get("weight_decay", 0.0),
        scheduler=opt_cfg.get("scheduler"),
        warmup_steps=opt_cfg.get("warmup_steps", 0),
        total_steps=total_steps,
        grad_clip_norm=opt_cfg.get("grad_clip_norm"),
        freeze_labels=freeze_labels,
    )


def normalize_precision(p) -> Optional[str]:
    """``trainer.precision``: 16 / "bf16" / "bfloat16" -> bf16 compute;
    32 / None -> float32."""
    if p in (None, 32, "32", "f32", "float32"):
        return None
    if p in (16, "16", "bf16", "bfloat16", "16-mixed"):
        return "bfloat16"
    raise ValueError(f"unsupported precision {p!r}")


def write_config_tree(cfg: Dict, out_dir: str) -> None:
    tree = json.dumps(cfg, indent=2, default=str)
    log.info("composed config:\n%s", tree)
    with open(os.path.join(out_dir, "config_tree.json"), "w") as f:
        f.write(tree + "\n")


def _setup_logging() -> None:
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s][%(levelname)s] %(message)s", force=True)


class Run(NamedTuple):
    trainer: Trainer  # an AdversarialTrainer for SentiDebias
    train_batcher: TrainBatcher
    val_batcher: EvalBatcher
    test_batcher: EvalBatcher
    data: object  # the dataset (MINDData, AdressaData or XMINDData)
    mesh: object = None  # this rank's parallel/mesh.py::Mesh, None on one device


def _barrier(mesh) -> None:
    if mesh is not None:
        from newsreclib_tpu_torch.parallel.collectives import broadcast_value

        broadcast_value(0.0, mesh.device)


def build_run(cfg: Dict, mesh=None) -> Run:
    """Everything ``run`` fits and tests with: the data (ETL and fixture as
    needed), the model on its device, the batchers, the loggers and the
    trainer.  ``mesh``: this rank's ``Mesh`` (``setup_parallelism``); rank 0
    runs the ETL first, the other ranks then read its caches."""
    device = select_device(cfg) if mesh is None else mesh.device
    rank = 0 if mesh is None else mesh.rank
    mc, dc, tc = cfg["model"], cfg["data"], cfg["trainer"]
    check_dkn_title_split(mc["name"], dc)
    out_dir = cfg["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    if rank == 0:
        write_config_tree(cfg, out_dir)
    log.info("device: %s%s", device,
             f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
    if rank:
        _barrier(mesh)  # rank 0's ETL writes the caches the others read
    data = load_run_data(cfg)
    if rank == 0:
        _barrier(mesh)
    return _build_run(cfg, mesh, device, data)


class RunData(NamedTuple):
    data: object
    store_train: object
    store_test: object
    train_imp: object
    val_imp: object
    test_imp: object
    info: object


def load_run_data(cfg: Dict) -> RunData:
    """The dataset, its train and test news stores (titles trimmed), its
    impressions and the model's data info, timed."""
    mc, dc = cfg["model"], cfg["data"]
    mind = setup_data(cfg)
    trim_margin = title_split_margin(mc["name"], mc)
    timings = {}

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        timings[name] = time.time() - t0
        return out

    store_train = timed("news_store(train)", lambda: mind.news_store("train")).trim_titles(
        margin=trim_margin)
    check_store_attributes(mc, store_train, dc.get("dataset", "mind"))
    check_token_range(mc, store_train)
    info = timed("data_info", lambda: load_data_info(mind, mc))
    train_imp = timed("impressions(train)", lambda: mind.impressions("train"))
    val_imp = timed("impressions(val)", lambda: mind.impressions("val"))
    store_test = timed("news_store(test)", lambda: mind.news_store("test")).trim_titles(
        margin=trim_margin)
    check_token_range(mc, store_test)
    test_imp = timed("impressions(test)", lambda: mind.impressions("test"))
    if dc.get("use_plm"):  # the PLM tokenizer's share of the news stores' seconds
        timings["plm_tokenize"] = mind.plm_tokenize_seconds
    log.info("ETL seconds: %s", json.dumps({k: round(v, 3) for k, v in timings.items()}))
    log.info("vocab=%d users=%d categ=%d news(train)=%d impressions train/val/test=%d/%d/%d; "
             "title width %d (trimmed)", info.vocab_size, info.num_users, info.num_categories,
             store_train.num_news, len(train_imp), len(val_imp), len(test_imp),
             store_train.title.shape[1])
    return RunData(mind, store_train, store_test, train_imp, val_imp, test_imp, info)


def _build_run(cfg: Dict, mesh, device: torch.device, rd: RunData) -> Run:
    mc, dc, tc = cfg["model"], cfg["data"], cfg["trainer"]
    mind, store_train, store_test, info = rd.data, rd.store_train, rd.store_test, rd.info
    train_imp = rd.train_imp
    out_dir = cfg["output_dir"]
    trim_margin = title_split_margin(mc["name"], mc)
    world = 1 if mesh is None else mesh.world
    multi_host = mesh is not None and not mesh.replicated_batches

    adversarial = bool(mc.get("adversarial"))
    if adversarial and multi_host and world > 1:
        raise NotImplementedError(
            "multi-host adversarial (SentiDebias) training is not wired; "
            "run it single-host or data-parallel within one host")
    model = None if adversarial else build_model(mc, info, device=device, seed=cfg.get("seed", 0))
    loss_fn = build_loss(mc)
    split_len = dc.get("split_title_len", 16)
    eval_kwargs = dict(
        max_history_len=dc["max_history_len"],
        target_cells=dc.get("eval_target_cells", 8192),
        u_bucket_min=dc.get("u_bucket_min", 512),
        split_title_len=split_len,
        split_margin=trim_margin,
    )
    # more than one rank: global-row batches (data.batch_size is the global
    # batch), deduplicated on the device against the whole store
    global_rows = (world > 1 or bool(dc.get("global_rows"))) and not adversarial
    local_batch, num_steps, seed = dc["batch_size"], None, cfg.get("seed", 0)
    if mesh is not None and dc["batch_size"] % mesh.data_size:
        raise ValueError(f"batch_size {dc['batch_size']} not divisible by the data axis "
                         f"{mesh.data_size}")
    if multi_host and mesh.data_size > 1:
        from newsreclib_tpu_torch.parallel.data import shard_impressions

        n, i = mesh.data_size, mesh.data_index
        local_batch = dc["batch_size"] // n
        # lockstep epochs: every rank takes the fewest steps of any shard
        pos_per_imp = np.add.reduceat(train_imp.labels_flat.astype(np.int64),
                                      train_imp.cand_offsets[:-1])
        num_steps = min(int(pos_per_imp[p::n].sum()) // local_batch for p in range(n))
        train_imp = shard_impressions(train_imp, i, n)
        seed += 7919 * i  # decorrelates the data ranks' sampling and shuffling
        log.info("data rank %d/%d: %d train impressions, %d steps an epoch", i, n,
                 len(train_imp), num_steps)
    train_batcher = TrainBatcher(
        store_train, train_imp, batch_size=local_batch,
        max_history_len=dc["max_history_len"], neg_sampling_ratio=dc["neg_sampling_ratio"],
        seed=seed, u_bucket_min=dc.get("u_bucket_min", 512), global_rows=global_rows,
        num_steps=num_steps, split_title_len=split_len, split_margin=trim_margin,
    )
    corpus = u_bucket = None
    if global_rows:
        corpus = store_train.features_for(np.arange(store_train.title.shape[0]))
        u_bucket = train_batcher.global_u_bucket(dc["batch_size"])
        log.info("global-row training: corpus table %d rows, u_bucket %d",
                 store_train.title.shape[0], u_bucket)
    if mesh is not None and mesh.replicated_batches:
        # each data rank scores its rows of every eval batch (root train.py:400)
        eval_kwargs["batch_multiple"] = mesh.data_size
    val_batcher = EvalBatcher(store_train, rd.val_imp, **eval_kwargs)
    test_batcher = EvalBatcher(store_test, rd.test_imp, **eval_kwargs)

    ranking = RankingMetrics(
        top_k_list=tuple(mc.get("top_k_list", (5, 10))),
        num_categ_classes=info.num_categories,
        num_sent_classes=info.num_sent_classes,
    )
    # rank-zero loggers: the other ranks train silently
    rank = 0 if mesh is None else mesh.rank
    loggers = make_loggers(out_dir, cfg.get("loggers", ["stdout", "csv"]) if rank == 0 else [])
    trainer_cfg = TrainerConfig(
        max_epochs=tc["max_epochs"],
        patience=tc["patience"],
        monitor=tc.get("monitor", "loss"),
        mode=tc.get("mode", "min"),
        log_every_n_steps=tc.get("log_every_n_steps", 50),
        check_finite=tc.get("check_finite", True),
        # ckpt_path: resume fit from an existing checkpoint directory
        ckpt_dir=cfg.get("ckpt_path") or os.path.join(out_dir, "checkpoints"),
        limit_train_batches=tc.get("limit_train_batches"),
        limit_eval_batches=tc.get("limit_eval_batches"),
        cached_eval=tc.get("cached_eval", True),
        row_shard_embeddings=tc.get("row_shard_embeddings", True),
        tp_transformer=tc.get("tp_transformer", False),
        compute_dtype=normalize_precision(tc.get("precision")),
        overfit_batches=tc.get("overfit_batches"),
    )
    if adversarial:
        # SentiDebias: alternating generator / discriminator steps
        from newsreclib_tpu_torch.models.fair_rec import create_sentidebias_state
        from newsreclib_tpu_torch.models.factory import build_senti_debias
        from newsreclib_tpu_torch.training.adversarial import AdversarialTrainer

        gen, disc = build_senti_debias(mc, info, device=device, seed=cfg.get("seed", 0))
        opt_cfg = mc.get("optimizer", {})
        sd_state = create_sentidebias_state(gen, disc, seed=cfg.get("seed", 0),
                                            g_lr=opt_cfg.get("lr", 1e-5),
                                            d_lr=opt_cfg.get("d_lr", 2e-5))
        log.info("params: %d generator, %d discriminator; %d train steps an epoch; compute %s",
                 param_count(gen), param_count(disc), len(train_batcher),
                 trainer_cfg.compute_dtype or "float32")
        trainer = AdversarialTrainer(sd_state, loss_fn, trainer_cfg,
                                     alpha=mc.get("alpha_coefficient", 0.15),
                                     beta=mc.get("beta_coefficient", 10.0),
                                     ranking=ranking, loggers=loggers, mesh=mesh)
        return Run(trainer, train_batcher, val_batcher, test_batcher, mind, mesh)
    state = create_train_state(model, build_optimizer(cfg, len(train_batcher), model),
                               dropout_seed=cfg.get("seed", 0))
    n_params = param_count(model)
    log.info("params: %d; %d train steps an epoch; compute %s", n_params, len(train_batcher),
             trainer_cfg.compute_dtype or "float32")
    for lg in loggers:
        if hasattr(lg, "log_hparams"):
            lg.log_hparams({"param_count": n_params, "cfg": cfg})

    trainer = Trainer(state, loss_fn, trainer_cfg, ranking=ranking, loggers=loggers,
                      mesh=mesh, corpus=corpus, u_bucket=u_bucket)
    return Run(trainer, train_batcher, val_batcher, test_batcher, mind, mesh)


def run_aspect(cfg: Dict) -> Dict[str, float]:
    """MANNeR's A-module (``model.name == manner_a``): SupCon on
    aspect-labelled news batches, not slates
    (``training/aspect.py::run_aspect_training``)."""
    from newsreclib_tpu_torch.training.aspect import run_aspect_training

    device = select_device(cfg)
    out_dir = cfg["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    write_config_tree(cfg, out_dir)
    mind = setup_data(cfg)
    info = load_data_info(mind, cfg["model"])
    loggers = make_loggers(out_dir, cfg.get("loggers", ["stdout", "csv"]))
    metrics = run_aspect_training(cfg, mind, info, loggers, out_dir, device=device)
    log.info("final metrics: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def run(cfg: Dict) -> Dict[str, float]:
    """Train and test as ``cfg`` says (module doc); on several ranks, rank
    0's metrics.  MANNeR's A-module trains on one device (rank 0 of a
    multi-host run; the JAX package trains it outside its mesh)."""
    from newsreclib_tpu_torch.parallel.mesh import destroy, env_rank

    _setup_logging()
    launched = env_rank()
    if cfg["model"]["name"] == "manner_a":
        return run_aspect(cfg) if launched is None or launched[0] == 0 else {}
    if launched is None and not cfg["trainer"].get("distributed"):
        n = local_rank_count(cfg)
        if n == 1:
            return run_rank(cfg, None)
        from newsreclib_tpu_torch.parallel.launch import spawn

        log.info("trainer.devices: %d local ranks", n)
        return spawn(_local_rank, n, (cfg,))[0]
    mesh = setup_parallelism(cfg)
    try:
        return run_rank(cfg, mesh)
    finally:
        destroy()


def _local_rank(rank: int, world: int, cfg: Dict) -> Dict[str, float]:
    """One rank of ``trainer.devices=N`` (a ``spawn`` process)."""
    from newsreclib_tpu_torch.parallel.mesh import destroy

    _setup_logging()
    mesh = setup_parallelism(cfg, rank, world)
    try:
        return run_rank(cfg, mesh)
    finally:
        destroy()


def run_rank(cfg: Dict, mesh=None) -> Dict[str, float]:
    """Fit, test and (``save_recs``) export on this rank: the export is
    split over the data ranks in single-node mode, rank 0's alone in
    multi-host mode."""
    r = build_run(cfg, mesh)
    metrics = r.trainer.fit(r.train_batcher, r.val_batcher, resume=bool(cfg.get("ckpt_path")))
    if cfg.get("test_after_train", True):
        metrics.update(r.trainer.test(r.test_batcher))
    # the one-device model (each rank's full copy on several ranks)
    model = getattr(r.trainer, "_eval_model", None)
    exports = mesh is None or mesh.replicated_batches or mesh.rank == 0
    if cfg.get("save_recs") and exports and hasattr(model, "encode_news"):
        export_recommendations(cfg, r, model)
    log.info("final metrics: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def export_recommendations(cfg: Dict, r: Run, model) -> str:
    """``save_recs``: the test split's candidate scores of every user,
    ``{"U<id>": {"N<id>": score}}``, to ``recs_fpath`` (default
    ``<output_dir>/recommendations.json``), from the trainer's parameters
    (the best checkpoint's after the test) in its compute type, as the
    repository's ``train.py:526-535``; in single-node mode over the data
    ranks (``CachedScorer(mesh=...)``: every rank calls it, rank 0 writes)."""
    from newsreclib_tpu_torch.serving import CachedScorer

    recs_fpath = cfg.get("recs_fpath") or os.path.join(cfg["output_dir"], "recommendations.json")
    mesh = r.mesh if r.mesh is not None and r.mesh.replicated_batches else None
    CachedScorer(model, compute_dtype=r.trainer.cfg.compute_dtype,
                 device=next(model.parameters()).device, mesh=mesh).export_recommendations(
        r.data.news_store("test"), r.data.impressions("test"), recs_fpath,
        max_history_len=cfg["data"]["max_history_len"],
    )
    log.info("recommendations exported to %s", recs_fpath)
    return recs_fpath


def task_wrapper(fn, cfg: Dict):
    """Run ``fn(cfg)``; on an exception, append its traceback to
    ``<output_dir>/error.log`` and re-raise.  Logs the output directory."""
    try:
        return fn(cfg)
    except Exception:
        import traceback

        out_dir = cfg.get("output_dir", ".")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "error.log"), "a") as f:
            traceback.print_exc(file=f)
        log.exception("task failed; traceback saved to %s/error.log", out_dir)
        raise
    finally:
        log.info("output dir: %s", cfg.get("output_dir"))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = compose(CONFIG_DIR, "train", [*DEFAULT_OVERRIDES, *argv])
    return task_wrapper(run, cfg)


if __name__ == "__main__":
    main()
