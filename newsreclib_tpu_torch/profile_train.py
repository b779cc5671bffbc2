"""Where the time of a train step goes, on one NVIDIA card.

    python3 -m newsreclib_tpu_torch.profile_train [--steps 20] [--compute-dtype float32]
        [--model {nrms,mins,cen_news_rec,caum,naml,tanr,lstur,npa,miner,dkn,sentirec,
                  senti_debias,manner_cr}]
        [--json OUT.jsonl]

The cell (``make_cell``): NRMS at the width of
``newsreclib_tpu/configs/model/nrms.yaml`` (D = 300, 15 heads of 20, query
200, dropout 0.2, vocab 60,000, random weights from seed 0), float32 master
parameters with bfloat16 compute (``--compute-dtype float32``: float32
compute, the training CLI's route when ``trainer.precision`` is unset, so
the float32 instances of both attention kernels run), Adam at lr 1e-4,
cross-entropy, fed by
``TrainBatcher`` at ``configs/data/mind_small.yaml``'s values (K = 4
negatives, history 50, ``u_bucket_min`` 512, ``split_title_len`` 16) over
the ``bench.py`` workload regenerated from seed 0 (32,768 articles, 16,384
impressions, one positive each).  Two batch sizes: 64 (the data config)
and 256 (``bench.py``'s train step: 256 impressions of 5 candidates).
``--model`` takes another model of ``models/factory.py`` at its config
file's widths instead, trained on its config file's loss (the workload's
articles carry abstracts, subcategories, entities and sentiment scores, its
impressions user ids, for them); ``senti_debias`` runs its alternating
generator / discriminator step (``models/fair_rec/senti_debias.py``).

For each, after 5 warm-up steps, one JSON line with:

* ``host_batch_ms``: ``TrainBatcher`` time per batch (numpy, host clock);
* ``step_ms`` / ``impressions_per_s``: train steps on batches already on
  the card, host clock over ``--steps`` steps ending in
  ``torch.cuda.synchronize``, the mean of two runs; ``plain_step_ms``: the
  same cell with the plain attention (``use_plain_attention``), timed in
  turns with it (kernel, plain, plain, kernel); ``loop_ms``: the kernel
  route with the batcher and the host-to-device copy in the loop, as a
  training loop runs it;
* ``peak_mem_mb``: ``torch.cuda.max_memory_allocated`` over those steps;
* ``profile``: ``--steps`` steps under ``torch.profiler``: kernels (and
  copies) per step, device busy time per step and its share of the
  profiled and of the unprofiled step, device time of the forward, the
  backward (the kernels of the ``autograd::engine`` ranges) and the Adam
  update, of the attention's forward kernel, of its backward kernel and of
  the whole ``FusedSmallMHSABackward`` node, the kernels that took the most
  device time and the host operations that took the most host time;
* ``attention_launches_per_step`` / ``attention_bwd_launches_per_step``:
  the forward and backward kernels' launch counts per step.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

VOCAB_SIZE = 60000
DATA = dict(max_history_len=50, neg_sampling_ratio=4, seed=0, u_bucket_min=512,
            split_title_len=16)
LEARNING_RATE = 1e-4
BATCH_SIZES = (64, 256)
WARMUP = 5
# attention calls of each model's news encoder on one news segment (MINS
# encodes title and abstract with its attention, MANNeR's CR module title and
# abstract side by side in one, NRMS, CenNewsRec, CAUM, MINER, SentiRec and
# SentiDebias titles alone; NAML, TANR, LSTUR, NPA and DKN have no MHSA) and
# of its user encoder on one batch of a train step's forward (SentiDebias
# encodes its bias-free and its bias-aware users; MANNeR fuses late)
TEXT_ATTENTIONS = {"nrms": 1, "mins": 2, "cen_news_rec": 1, "caum": 1, "miner": 1, "naml": 0,
                   "tanr": 0, "lstur": 0, "npa": 0, "dkn": 0, "sentirec": 1,
                   "senti_debias": 1, "manner_cr": 1}
USER_ATTENTIONS = {"nrms": 1, "mins": 1, "cen_news_rec": 1, "caum": 1, "sentirec": 1,
                   "senti_debias": 2}
# models whose train step is not ``make_train_step`` on the model's loss
ADVERSARIAL = ("senti_debias",)


def cell_config(model: str) -> dict:
    """The ``model`` node of ``model``'s config file."""
    from newsreclib_tpu_torch.config.compose import compose

    return compose(overrides=[f"model={model}"])["model"]


def cell_info():
    """The factory's ``DataInfo`` of the cells: a ``VOCAB_SIZE`` vocabulary,
    the serving workload's entity and user counts."""
    from newsreclib_tpu_torch.data.synthetic import SERVING_ENTITIES, SERVING_USERS
    from newsreclib_tpu_torch.models import factory

    return factory.DataInfo(vocab_size=VOCAB_SIZE, num_subcategories=50,
                            entity_vocab_size=SERVING_ENTITIES, num_users=SERVING_USERS)


def build_cell_model(model: str, device):
    """``model`` from ``build_model`` at its config file's widths, random
    weights from seed 0."""
    from newsreclib_tpu_torch.models import factory

    return factory.build_model(cell_config(model), cell_info(), device=device, seed=0)


def cell_state_and_step(model: str, device, compute_dtype="bfloat16",
                        learning_rate=LEARNING_RATE):
    """``(state, train_step)`` of ``model``'s cell: Adam at
    ``learning_rate`` and the config file's loss through ``make_train_step``;
    SentiDebias's alternating G / D step (D at twice G's rate, as its config
    file) over its ``SentiDebiasState``, whose ``model`` is the generator."""
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    cfg = cell_config(model)
    if model in ADVERSARIAL:
        from newsreclib_tpu_torch.models.fair_rec import (
            create_sentidebias_state,
            make_sentidebias_train_step,
        )

        gen, disc = factory.build_senti_debias(cfg, cell_info(), device=device)
        state = create_sentidebias_state(gen, disc, g_lr=learning_rate, d_lr=2 * learning_rate)
        return state, make_sentidebias_train_step(cfg.get("alpha_coefficient", 0.15),
                                                  cfg.get("beta_coefficient", 10.0),
                                                  compute_dtype)
    state = create_train_state(build_cell_model(model, device), make_optimizer(learning_rate),
                               dropout_seed=0)
    return state, make_train_step(factory.build_loss(cfg), compute_dtype)


def make_cell(store, imp, batch_size, device, compute_dtype="bfloat16",
              learning_rate=LEARNING_RATE, model="nrms"):
    """``(state, batcher, train_step)`` of the cell in the module doc
    (``compute_dtype`` None: float32 compute)."""
    from newsreclib_tpu_torch.data.batching import TrainBatcher

    state, step = cell_state_and_step(model, device, compute_dtype, learning_rate)
    return state, TrainBatcher(store, imp, batch_size=batch_size, **DATA), step


def attention_launches(batch, model: str = "nrms", backward: bool = False) -> int:
    """Attention kernel launches of one train step of ``model`` on
    ``batch``, of the forward kernel (of the backward kernel with
    ``backward``): the news encoder's per news segment and the user
    encoder's; SentiDebias's discriminator step runs the news tower's
    forward once more."""
    segments = 1 + (batch.news2 is not None)
    n = TEXT_ATTENTIONS[model] * segments + USER_ATTENTIONS.get(model, 0)
    if model in ADVERSARIAL and not backward:
        n += TEXT_ATTENTIONS[model] * segments
    return n


def _sync_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _device_breakdown(prof, steps: int) -> dict:
    """Device ms per step by phase from the profiler's events.  A CPU
    event's device time is that of the kernels it and its children
    launched; the user-annotation ranges on the device timeline are left
    out (``kernel_bench.device_events``)."""
    from newsreclib_tpu_torch.kernel_bench import device_events

    annotations = {e.name for e in prof.events() if e.is_user_annotation}

    def kernel_us(e):
        return (sum(k.duration for k in e.kernels if k.name not in annotations)
                + sum(kernel_us(c) for c in e.cpu_children))

    kernels = device_events(prof)
    total_us = sum(e.self_device_time_total for e in kernels)
    backward_us = attention_bwd_us = adam_us = 0.0
    for e in prof.events():
        if e.cpu_parent is not None or e.device_type.name != "CPU":
            continue
        if e.name.startswith("autograd::engine::evaluate_function"):
            backward_us += kernel_us(e)
            if e.name.endswith("FusedSmallMHSABackward"):
                attention_bwd_us += kernel_us(e)
        elif e.name.startswith("Optimizer.step#"):
            adam_us += kernel_us(e)
    attention_bwd_kernel_us = sum(e.self_device_time_total for e in kernels
                                  if "mhsa_bwd_" in e.key)
    attention_fwd_us = sum(e.self_device_time_total for e in kernels
                           if "mhsa_" in e.key) - attention_bwd_kernel_us
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    host = [e for e in prof.key_averages() if e.device_type.name == "CPU"]
    top_host = sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    per = lambda us: us / 1e3 / steps  # noqa: E731
    return {
        "device_ms_per_step": per(total_us),
        "forward_ms": per(total_us - backward_us - adam_us),
        "backward_ms": per(backward_us),
        "adam_ms": per(adam_us),
        "attention_fwd_kernel_ms": per(attention_fwd_us),
        "attention_bwd_ms": per(attention_bwd_us),
        "attention_bwd_kernel_ms": per(attention_bwd_kernel_us),
        "cuda_events_per_step": sum(e.count for e in kernels) / steps,
        "top_kernels": [{"name": e.key[:90], "calls_per_step": e.count / steps,
                         "device_ms_per_step": per(e.self_device_time_total)} for e in top],
        "top_host_ops": [{"name": e.key[:90], "calls_per_step": e.count / steps,
                          "self_cpu_ms_per_step": per(e.self_cpu_time_total)}
                         for e in top_host],
    }


def profile_cell(store, imp, batch_size: int, steps: int, card: str,
                 compute_dtype="bfloat16", model="nrms") -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.models.components.attention import use_plain_attention
    from newsreclib_tpu_torch.ops import mhsa

    state, batcher, step = make_cell(store, imp, batch_size, "cuda", compute_dtype, model=model)
    plain_state, _, plain_step = make_cell(store, imp, batch_size, "cuda", compute_dtype,
                                           model=model)
    use_plain_attention(plain_state.model)
    t0 = time.perf_counter()
    host = [b for _, b in zip(range(WARMUP + 2 * steps), batcher.epoch(0))]
    host_batch_ms = (time.perf_counter() - t0) / len(host) * 1e3
    dev = [to_device(b, "cuda") for b in host]
    for b in dev[:WARMUP]:
        step(state, b)
        plain_step(plain_state, b)

    timed = dev[WARMUP:WARMUP + steps]
    torch.cuda.reset_peak_memory_stats()
    mhsa.launches = mhsa.bwd_launches = 0
    kernel_s = [_sync_s(lambda: [step(state, b) for b in timed]) / steps]
    launches, bwd_launches = mhsa.launches, mhsa.bwd_launches
    expected = sum(attention_launches(b, model) for b in timed)
    bwd_expected = sum(attention_launches(b, model, backward=True) for b in timed)
    if launches != expected or bwd_launches != bwd_expected:
        raise AssertionError(f"{launches} forward and {bwd_launches} backward kernel launches "
                             f"({expected} and {bwd_expected} expected)")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    plain_s = [_sync_s(lambda: [plain_step(plain_state, b) for b in timed]) / steps
               for _ in range(2)]
    kernel_s.append(_sync_s(lambda: [step(state, b) for b in timed]) / steps)
    step_s = sum(kernel_s) / 2

    def loop():
        for n, b in enumerate(batcher.epoch(1), 1):
            step(state, to_device(b, "cuda"))
            if n == steps:
                return

    loop_s = _sync_s(loop) / steps

    profiled = dev[WARMUP + steps:WARMUP + 2 * steps]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = _sync_s(lambda: [step(state, b) for b in profiled])
    breakdown = _device_breakdown(prof, steps)
    busy_ms = breakdown["device_ms_per_step"]
    return {
        "model": model,
        "batch_size": batch_size,
        "compute_dtype": compute_dtype or "float32",
        "title_shapes": sorted({(tuple(b.news.title.shape),
                                 None if b.news2 is None else tuple(b.news2.title.shape))
                                for b in timed}),
        "steps": steps,
        "host_batch_ms": host_batch_ms,
        "step_ms": step_s * 1e3,
        "step_ms_runs": [t * 1e3 for t in kernel_s],
        "impressions_per_s": batch_size / step_s,
        "plain_step_ms": sum(plain_s) / 2 * 1e3,
        "plain_step_ms_runs": [t * 1e3 for t in plain_s],
        "loop_ms": loop_s * 1e3,
        "loop_impressions_per_s": batch_size / loop_s,
        "peak_mem_mb": peak_mb,
        "attention_launches_per_step": launches / steps,
        "attention_bwd_launches_per_step": bwd_launches / steps,
        "profile": {"wall_ms_per_step": wall_s * 1e3 / steps,
                    "device_busy_share_profiled": busy_ms / (wall_s * 1e3 / steps),
                    "device_busy_share_unprofiled": busy_ms / (step_s * 1e3),
                    **breakdown},
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="float32: the training CLI's default route")
    ap.add_argument("--model", choices=sorted(TEXT_ATTENTIONS), default="nrms")
    ap.add_argument("--json", type=Path, help="also write the records here, one per line")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_train: no CUDA device is available", file=sys.stderr)
        return 1
    from newsreclib_tpu_torch.data.synthetic import make_serving_workload
    from newsreclib_tpu_torch.kernel_bench import card_line
    from newsreclib_tpu_torch.ops import build

    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build_all(["mhsa"])
    store, imp = make_serving_workload(np.random.default_rng(0))
    records = []
    for batch_size in BATCH_SIZES:
        rec = profile_cell(store, imp, batch_size, args.steps, card,
                           None if args.compute_dtype == "float32" else args.compute_dtype,
                           args.model)
        print("profile_train " + json.dumps(rec), flush=True)
        records.append(rec)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(r) + "\n" for r in records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
