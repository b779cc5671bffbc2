"""Training entry point of the port (counterpart of the repository's
``train.py``): compose the config, run the MIND ETL (generating the statfix
fixture first where the config asks for it and it is absent), build the
model, fit with early stopping and best / last checkpoints, test from the
best checkpoint, and write ``metrics.csv``, ``hparams.json`` and
``config_tree.json`` under ``output_dir``.

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
MIND-format data; the PLM tower, the other datasets and the multi-device
settings raise ``NotImplementedError`` naming their ROADMAP item.
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


def setup_data(cfg: Dict) -> MINDData:
    """The dataset of ``cfg["data"]``; generates the statfix fixture first
    when ``generate_fixture`` is ``statfix`` or ``statfix_v2`` and its news
    file is absent."""
    dc = cfg["data"]
    dataset = dc.get("dataset", "mind")
    if dataset != "mind":
        raise _not_ported(f"the {dataset} dataset", "Other datasets")
    news_tsv = os.path.join(dc["data_dir"], f"MIND{dc['dataset_size']}_train", "news.tsv")
    fixture = dc.get("generate_fixture")
    if fixture and not os.path.exists(news_tsv):
        from newsreclib_tpu_torch.data import statfix

        writers = {"statfix": statfix.write_mind_small_statfix,
                   "statfix_v2": statfix.write_mind_small_statfix_v2}
        if fixture not in writers:
            raise _not_ported(f"the {fixture!r} fixture generator", "Other datasets")
        t0 = time.time()
        writers[fixture](dc["data_dir"], seed=dc.get("seed", 42))
        log.info("%s fixture generated in %.1f s under %s", fixture, time.time() - t0,
                 dc["data_dir"])
    return MINDData(MINDConfig(
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
        download=dc.get("download", False),
        seed=dc.get("seed", 0),
        use_plm=dc.get("use_plm", False),
    ))


def build_optimizer(cfg: Dict, steps_per_epoch: int = 0):
    """The update rule of the ``model.optimizer`` node (lr, weight decay,
    cosine or linear-warmup schedule, gradient clipping); the schedule spans
    ``steps_per_epoch x trainer.max_epochs`` updates unless it names its
    ``total_steps``."""
    mc = cfg["model"]
    opt_cfg = mc.get("optimizer", {})
    if mc.get("frozen_layers") is not None and mc.get("use_plm"):
        raise _not_ported("PLM layer freezing", "PLM tower")
    total_steps = opt_cfg.get("total_steps") or (
        steps_per_epoch * cfg["trainer"].get("max_epochs", 20))
    return make_optimizer(
        opt_cfg.get("lr", 1e-4),
        opt_cfg.get("weight_decay", 0.0),
        scheduler=opt_cfg.get("scheduler"),
        warmup_steps=opt_cfg.get("warmup_steps", 0),
        total_steps=total_steps,
        grad_clip_norm=opt_cfg.get("grad_clip_norm"),
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


def build_run(cfg: Dict) -> Run:
    """Everything ``run`` fits and tests with: the data (ETL and fixture as
    needed), the model on its device, the batchers, the loggers and the
    trainer."""
    device = select_device(cfg)
    check_single_device(cfg)
    mc, dc, tc = cfg["model"], cfg["data"], cfg["trainer"]
    if cfg.get("save_recs"):
        raise _not_ported("CachedScorer.export_recommendations (save_recs)",
                          "Entry points around serving")
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
    info = timed("data_info", lambda: load_data_info(mind, mc))
    train_imp = timed("impressions(train)", lambda: mind.impressions("train"))
    val_imp = timed("impressions(val)", lambda: mind.impressions("val"))
    store_test = timed("news_store(test)", lambda: mind.news_store("test")).trim_titles(
        margin=trim_margin)
    test_imp = timed("impressions(test)", lambda: mind.impressions("test"))
    log.info("ETL seconds: %s", json.dumps({k: round(v, 3) for k, v in timings.items()}))
    log.info("vocab=%d users=%d categ=%d news(train)=%d impressions train/val/test=%d/%d/%d",
             info.vocab_size, info.num_users, info.num_categories, store_train.num_news,
             len(train_imp), len(val_imp), len(test_imp))

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
        return Run(trainer, train_batcher, val_batcher, test_batcher)
    state = create_train_state(model, build_optimizer(cfg, len(train_batcher)),
                               dropout_seed=cfg.get("seed", 0))
    n_params = param_count(model)
    log.info("params: %d; %d train steps an epoch; compute %s", n_params, len(train_batcher),
             trainer_cfg.compute_dtype or "float32")
    for lg in loggers:
        if hasattr(lg, "log_hparams"):
            lg.log_hparams({"param_count": n_params, "cfg": cfg})

    trainer = Trainer(state, loss_fn, trainer_cfg, ranking=ranking, loggers=loggers)
    return Run(trainer, train_batcher, val_batcher, test_batcher)


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
    log.info("final metrics: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


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
