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
(nothing is fetched); xMIND in PLM mode and the multi-device settings raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, NamedTuple, Optional, Sequence

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


def select_device(cfg: Dict) -> torch.device:
    """``platform`` (or ``$NEWSRECLIB_PLATFORM``): absent, ``cuda`` or
    ``gpu`` -> the card, which must be present; ``cpu`` -> the CPU."""
    platform = os.environ.get("NEWSRECLIB_PLATFORM") or cfg.get("platform") or "cuda"
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r}: the port runs on cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; run with platform=cpu "
                           "(or NEWSRECLIB_PLATFORM=cpu) to train on the CPU")
    return torch.device("cuda")


def check_single_device(cfg: Dict) -> None:
    """Refuse the JAX package's multi-device settings (ROADMAP queue 1, "Multi-GPU")."""
    tc = cfg.get("trainer", {})
    if tc.get("distributed"):
        raise _not_ported("multi-host training", "Multi-GPU")
    if int(tc.get("model_axis", 1)) > 1 or tc.get("tp_transformer"):
        raise _not_ported("model-axis sharding and tensor parallelism", "Multi-GPU")
    if tc.get("devices", "all") not in ("all", None, -1, 1):
        raise _not_ported("data parallelism over several devices", "Multi-GPU")
    if cfg.get("data", {}).get("global_rows"):
        raise _not_ported("global-row training", "Multi-GPU")


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
    news_tsv = os.path.join(dc["data_dir"], f"MIND{dc['dataset_size']}_train", "news.tsv")
    if fixture and not os.path.exists(news_tsv):
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


def build_run(cfg: Dict) -> Run:
    """Everything ``run`` fits and tests with: the data (ETL and fixture as
    needed), the model on its device, the batchers, the loggers and the
    trainer."""
    device = select_device(cfg)
    check_single_device(cfg)
    mc, dc, tc = cfg["model"], cfg["data"], cfg["trainer"]
    check_dkn_title_split(mc["name"], dc)
    out_dir = cfg["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    write_config_tree(cfg, out_dir)
    log.info("device: %s%s", device,
             f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")

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

    adversarial = bool(mc.get("adversarial"))
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
    train_batcher = TrainBatcher(
        store_train, train_imp, batch_size=dc["batch_size"],
        max_history_len=dc["max_history_len"], neg_sampling_ratio=dc["neg_sampling_ratio"],
        seed=cfg.get("seed", 0), u_bucket_min=dc.get("u_bucket_min", 512),
        split_title_len=split_len, split_margin=trim_margin,
    )
    val_batcher = EvalBatcher(store_train, val_imp, **eval_kwargs)
    test_batcher = EvalBatcher(store_test, test_imp, **eval_kwargs)

    ranking = RankingMetrics(
        top_k_list=tuple(mc.get("top_k_list", (5, 10))),
        num_categ_classes=info.num_categories,
        num_sent_classes=info.num_sent_classes,
    )
    loggers = make_loggers(out_dir, cfg.get("loggers", ["stdout", "csv"]))
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
                                     ranking=ranking, loggers=loggers)
        return Run(trainer, train_batcher, val_batcher, test_batcher, mind)
    state = create_train_state(model, build_optimizer(cfg, len(train_batcher), model),
                               dropout_seed=cfg.get("seed", 0))
    n_params = param_count(model)
    log.info("params: %d; %d train steps an epoch; compute %s", n_params, len(train_batcher),
             trainer_cfg.compute_dtype or "float32")
    for lg in loggers:
        if hasattr(lg, "log_hparams"):
            lg.log_hparams({"param_count": n_params, "cfg": cfg})

    trainer = Trainer(state, loss_fn, trainer_cfg, ranking=ranking, loggers=loggers)
    return Run(trainer, train_batcher, val_batcher, test_batcher, mind)


def run_aspect(cfg: Dict) -> Dict[str, float]:
    """MANNeR's A-module (``model.name == manner_a``): SupCon on
    aspect-labelled news batches, not slates
    (``training/aspect.py::run_aspect_training``)."""
    from newsreclib_tpu_torch.training.aspect import run_aspect_training

    device = select_device(cfg)
    check_single_device(cfg)
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
    _setup_logging()
    if cfg["model"]["name"] == "manner_a":
        return run_aspect(cfg)
    r = build_run(cfg)
    metrics = r.trainer.fit(r.train_batcher, r.val_batcher, resume=bool(cfg.get("ckpt_path")))
    if cfg.get("test_after_train", True):
        metrics.update(r.trainer.test(r.test_batcher))
    model = getattr(r.trainer.state, "model", None)
    if cfg.get("save_recs") and hasattr(model, "encode_news"):
        export_recommendations(cfg, r, model)
    log.info("final metrics: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def export_recommendations(cfg: Dict, r: Run, model) -> str:
    """``save_recs``: the test split's candidate scores of every user,
    ``{"U<id>": {"N<id>": score}}``, to ``recs_fpath`` (default
    ``<output_dir>/recommendations.json``), from the trainer's parameters
    (the best checkpoint's after the test) in its compute type, as the
    repository's ``train.py:526-535``."""
    from newsreclib_tpu_torch.serving import CachedScorer

    recs_fpath = cfg.get("recs_fpath") or os.path.join(cfg["output_dir"], "recommendations.json")
    CachedScorer(model, compute_dtype=r.trainer.cfg.compute_dtype,
                 device=next(model.parameters()).device).export_recommendations(
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
