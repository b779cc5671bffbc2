"""Evaluation entry point of the port (counterpart of the repository's
``eval.py``): restore a trained model from its checkpoint directory and run
the test split, or compose MANNeR's ensemble from trained CR and A-module
checkpoints.

    python -m newsreclib_tpu_torch.eval experiment=nrms_demo ckpt_path=RUN/checkpoints
    python -m newsreclib_tpu_torch.eval experiment=manner_ensemble_statfix \\
        model.cr_ckpt=CR_RUN/checkpoints model.aspects.categ.ckpt=A_RUN/checkpoints \\
        model.aspects.sent.ckpt=A2_RUN/checkpoints

It composes ``newsreclib_tpu/configs/eval.yaml`` with the overrides, runs on
the card (``cuda``; ``cuda:<LOCAL_RANK>`` under a launcher) and raises
without one unless ``platform=cpu``; it evaluates on one device, and reads
the full checkpoints a multi-rank training run writes; metrics
go to ``output_dir`` (default ``outputs/torch/eval_<model>_<data>``).
Any model the training CLI trains is restored from the 'best' checkpoint
of ``ckpt_path`` (SentiDebias: its generator, bias-free scores); the
optimizer it was trained with need not be known
(``Checkpointer.restore_params``).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import sys
from typing import Dict, Optional, Sequence

from newsreclib_tpu_torch.config.compose import CONFIG_DIR, compose
from newsreclib_tpu_torch.data.batching import EvalBatcher
from newsreclib_tpu_torch.metrics.collector import RankingMetrics
from newsreclib_tpu_torch.models.factory import (
    build_loss,
    build_manner_a,
    build_model,
    build_senti_debias,
    load_data_info,
    title_split_margin,
)
from newsreclib_tpu_torch.train import (
    _setup_logging,
    check_token_range,
    select_device,
    setup_data,
    task_wrapper,
)
from newsreclib_tpu_torch.training.checkpoint import Checkpointer
from newsreclib_tpu_torch.training.loggers import make_loggers
from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

log = logging.getLogger("newsreclib_tpu_torch")

DEFAULT_OVERRIDES = ("output_dir=outputs/torch/eval_${model.name}_${data.name}",)


def _ranking(cfg: Dict, info) -> RankingMetrics:
    return RankingMetrics(
        top_k_list=tuple(cfg["model"].get("top_k_list", (5, 10))),
        num_categ_classes=info.num_categories,
        num_sent_classes=info.num_sent_classes,
    )


def _test_batcher(cfg: Dict, mind) -> EvalBatcher:
    dc = cfg["data"]
    margin = title_split_margin(cfg["model"].get("name", ""), cfg["model"])
    return EvalBatcher(
        mind.news_store("test").trim_titles(margin=margin),
        mind.impressions("test"),
        max_history_len=dc["max_history_len"],
        target_cells=dc.get("eval_target_cells", 8192),
        u_bucket_min=dc.get("u_bucket_min", 512),
        split_title_len=dc.get("split_title_len", 16),
        split_margin=margin,
    )


def _restored(model, ckpt_dir: str):
    model.load_state_dict(Checkpointer(ckpt_dir).restore_params("best"))
    return model.eval()


def run_manner_ensemble(cfg: Dict, mind, info, out_dir: str, device) -> Dict[str, float]:
    """MANNeR's test-only ensemble (``eval.py:59-101`` of the repository):
    the CR module from ``model.cr`` / ``model.cr_ckpt`` and each aspect of
    ``model.aspects`` (a ``manner_a`` node with ``ckpt`` and ``weight``;
    null or a ``???`` checkpoint leaves it out), each restored from its
    'best' checkpoint, their per-impression z-scored scores summed with the
    weights (``models/fair_rec/manner.py::evaluate_ensemble``)."""
    from newsreclib_tpu_torch.models.fair_rec.manner import evaluate_ensemble

    def info_for(node):
        # the top-level node has no embedding widths: each module decides
        # whether the pretrained matrices fit it
        if node.get("use_pretrained_embeddings", True):
            return info
        return dataclasses.replace(info, pretrained_embeddings=None)

    mc = cfg["model"]
    seed = cfg.get("seed", 0)
    cr = _restored(build_model(mc["cr"], info_for(mc["cr"]), device=device, seed=seed),
                   mc["cr_ckpt"])
    aspects = {}
    for name, node in (mc.get("aspects") or {}).items():
        if not node or node.get("ckpt") in (None, "???"):
            continue
        a_model = _restored(build_manner_a(node, info_for(node), device=device, seed=seed),
                            node["ckpt"])
        aspects[name] = (a_model, node.get("weight", 0.0))
    log.info("ensemble: CR + %d aspect modules (%s)", len(aspects),
             {k: v[1] for k, v in aspects.items()})
    dc = cfg["data"]
    metrics = evaluate_ensemble(cr, aspects, mind.news_store("test"), mind.impressions("test"),
                                _ranking(cfg, info), max_history_len=dc["max_history_len"],
                                target_cells=dc.get("eval_target_cells", 8192), device=device)
    metrics = {f"test/{k}": v for k, v in metrics.items()}
    for lg in make_loggers(out_dir, cfg.get("loggers", ["stdout", "csv"])):
        lg.log_metrics(metrics, 0)
    log.info("ensemble test metrics: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def run(cfg: Dict) -> Dict[str, float]:
    _setup_logging()
    device = select_device(cfg)
    out_dir = cfg["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    mind = setup_data(cfg)
    mc = cfg["model"]
    check_token_range(mc, mind.news_store("test"))
    info = load_data_info(mind, mc)
    if mc["name"] == "manner":
        return run_manner_ensemble(cfg, mind, info, out_dir, device)

    ckpt_path = cfg.get("ckpt_path")
    if not ckpt_path or ckpt_path == "???":
        raise ValueError("ckpt_path is required for eval")
    seed = cfg.get("seed", 0)
    if mc.get("adversarial"):
        model = build_senti_debias(mc, info, device=device, seed=seed)[0]
    else:
        model = build_model(mc, info, device=device, seed=seed)
    _restored(model, ckpt_path)
    tc = cfg.get("trainer", {})
    trainer = Trainer(
        create_train_state(model, make_optimizer()), build_loss(mc),
        TrainerConfig(ckpt_dir=None, limit_eval_batches=tc.get("limit_eval_batches")),
        ranking=_ranking(cfg, info),
        loggers=make_loggers(out_dir, cfg.get("loggers", ["stdout", "csv"])),
    )
    metrics = trainer.test(_test_batcher(cfg, mind), restore_best=False)
    log.info("test metrics: %s", {k: round(v, 4) for k, v in metrics.items()})
    return metrics


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = compose(CONFIG_DIR, "eval", [*DEFAULT_OVERRIDES, *argv])
    return task_wrapper(run, cfg)


if __name__ == "__main__":
    main()
