"""Where the time of a train step goes, on one NVIDIA card.

    python3 -m newsreclib_tpu_torch.profile_train [--steps 20] [--compute-dtype float32]
        [--model {nrms,mins,cen_news_rec,caum,naml,tanr,lstur,npa,miner,dkn,sentirec,
                  senti_debias,manner_cr,nrms_plm}]
        [--remat] [--global-rows] [--distributed] [--json OUT.jsonl]

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
``nrms_plm`` is NRMS with the PLM tower at the model node of
``experiment=nrms_statfix_plm_supconloss`` (a random 12-layer tower 768
wide, 12 heads, FFN 3,072; the head's 16 heads of 48; SupCon), its
vocabulary at the workload's 60,000 ids, trained at that experiment's
batch of 8 and 32 with its ``u_bucket_min`` of 128; its profile also splits
the device time of the tower (``tower``: its GEMMs, its plain attention and
the rest, forward and backward) from the head's attention kernels.

``--remat`` builds the model with ``model.remat`` (MANNeR's CR module:
the news tower's activations recomputed in the backward pass, so its
attention's forward kernel runs twice a news segment).

``--global-rows`` feeds global-row batches (``TrainBatcher(global_rows=True)``,
deduplicated on the card by ``data/batch.py::densify`` against the whole
store: the route of every multi-rank run); ``--distributed`` also makes
the process rank 0 of a multi-host world of one over NCCL
(``parallel/mesh.py``), so the step gathers the batch and the loss's inputs
and sums the gradients as a rank does: what the collectives cost at world
size 1.

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
  the forward and backward kernels' launch counts per step;
* ``tower`` (``nrms_plm``): device ms a step of the PLM tower's GEMMs (its
  Dense layers), of its plain attention (``components/plm.py::
  self_attention``: the batched products, mask, softmax and dropout) and of
  the rest of it (embeddings, LayerNorms, GELU, dropout), forward and
  backward: the kernels launched under ``torch.profiler`` ranges put
  around the tower and its attention for the profiled steps, and by the
  backward nodes whose sequence numbers those ranges' operations carry.

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

VOCAB_SIZE = 60000
DATA = dict(max_history_len=50, neg_sampling_ratio=4, seed=0, u_bucket_min=512,
            split_title_len=16)
LEARNING_RATE = 1e-4
BATCH_SIZES = (64, 256)
# NRMS with the PLM tower (module doc): its experiment, batches and batcher
PLM_CELL, PLM_EXPERIMENT = "nrms_plm", "nrms_statfix_plm_supconloss"
PLM_BATCH_SIZES = (8, 32)
PLM_DATA = dict(DATA, u_bucket_min=128)
WARMUP = 5
# attention calls of each model's news encoder on one news segment (MINS
# encodes title and abstract with its attention, MANNeR's CR module title and
# abstract side by side in one, NRMS, CenNewsRec, CAUM, MINER, SentiRec and
# SentiDebias titles alone; NAML, TANR, LSTUR, NPA and DKN have no MHSA) and
# of its user encoder on one batch of a train step's forward (SentiDebias
# encodes its bias-free and its bias-aware users; MANNeR fuses late)
TEXT_ATTENTIONS = {"nrms": 1, "mins": 2, "cen_news_rec": 1, "caum": 1, "miner": 1, "naml": 0,
                   "tanr": 0, "lstur": 0, "npa": 0, "dkn": 0, "sentirec": 1,
                   "senti_debias": 1, "manner_cr": 1, PLM_CELL: 1}
USER_ATTENTIONS = {"nrms": 1, "mins": 1, "cen_news_rec": 1, "caum": 1, "sentirec": 1,
                   "senti_debias": 2, PLM_CELL: 1}
# models whose train step is not ``make_train_step`` on the model's loss
ADVERSARIAL = ("senti_debias",)


def cell_config(model: str, remat: bool = False) -> dict:
    """The ``model`` node of ``model``'s config file (``nrms_plm``: of
    ``PLM_EXPERIMENT``, its vocabulary at ``VOCAB_SIZE``), with ``remat``
    its ``remat`` set."""
    from newsreclib_tpu_torch.config.compose import compose

    extra = ["model.remat=true"] if remat else []
    if model == PLM_CELL:
        return compose(overrides=[f"experiment={PLM_EXPERIMENT}",
                                  f"model.plm_vocab_size={VOCAB_SIZE}", *extra])["model"]
    return compose(overrides=[f"model={model}", *extra])["model"]


def cell_data(model: str) -> dict:
    """``TrainBatcher`` keywords of ``model``'s cell."""
    return PLM_DATA if model == PLM_CELL else DATA


def cell_info():
    """The factory's ``DataInfo`` of the cells: a ``VOCAB_SIZE`` vocabulary,
    the serving workload's entity and user counts."""
    from newsreclib_tpu_torch.data.synthetic import SERVING_ENTITIES, SERVING_USERS
    from newsreclib_tpu_torch.models import factory

    return factory.DataInfo(vocab_size=VOCAB_SIZE, num_subcategories=50,
                            entity_vocab_size=SERVING_ENTITIES, num_users=SERVING_USERS)


def build_cell_model(model: str, device, remat: bool = False):
    """``model`` from ``build_model`` at its config file's widths, random
    weights from seed 0."""
    from newsreclib_tpu_torch.models import factory

    return factory.build_model(cell_config(model, remat), cell_info(), device=device, seed=0)


def cell_state_and_step(model: str, device, compute_dtype="bfloat16",
                        learning_rate=LEARNING_RATE, remat: bool = False):
    """``(state, train_step)`` of ``model``'s cell: Adam at
    ``learning_rate`` and the config file's loss through ``make_train_step``;
    SentiDebias's alternating G / D step (D at twice G's rate, as its config
    file) over its ``SentiDebiasState``, whose ``model`` is the generator."""
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    cfg = cell_config(model, remat)
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
    state = create_train_state(build_cell_model(model, device, remat),
                               make_optimizer(learning_rate), dropout_seed=0)
    return state, make_train_step(factory.build_loss(cfg), compute_dtype)


def make_cell(store, imp, batch_size, device, compute_dtype="bfloat16",
              learning_rate=LEARNING_RATE, model="nrms", remat: bool = False,
              global_rows: bool = False, mesh=None):
    """``(state, batcher, train_step)`` of the cell in the module doc
    (``compute_dtype`` None: float32 compute).  ``global_rows``: the
    batcher's global-row batches, which ``train_step(state, batch)``
    densifies against the store on ``device``; ``mesh``: the state placed
    on it (``parallel/mesh.py::place_state``)."""
    from newsreclib_tpu_torch.data.batching import TrainBatcher

    state, step = cell_state_and_step(model, device, compute_dtype, learning_rate, remat)
    batcher = TrainBatcher(store, imp, batch_size=batch_size, global_rows=global_rows,
                           **cell_data(model))
    if not global_rows:
        return state, batcher, step
    import numpy as np

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.training.steps import as_dtype, make_train_step

    if mesh is not None:
        from newsreclib_tpu_torch.parallel.mesh import place_state

        place_state(state, mesh)
    corpus = to_device(store.features_for(np.arange(store.title.shape[0])), device)
    rows_step = make_train_step(factory.build_loss(cell_config(model, remat)),
                                as_dtype(compute_dtype), u_bucket=batcher.global_u_bucket())
    return state, batcher, lambda st, b: rows_step(st, b, corpus)


def attention_launches(batch, model: str = "nrms", backward: bool = False,
                       remat: bool = False) -> int:
    """Attention kernel launches of one train step of ``model`` on
    ``batch``, of the forward kernel (of the backward kernel with
    ``backward``): the news encoder's per news segment and the user
    encoder's; SentiDebias's discriminator step runs the news tower's
    forward once more, and so does the backward pass of a model built with
    ``remat``."""
    segments = 1 + (batch.news2 is not None)
    n = TEXT_ATTENTIONS[model] * segments + USER_ATTENTIONS.get(model, 0)
    if (model in ADVERSARIAL or remat) and not backward:
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


GEMM_KERNEL_NAMES = ("gemm", "gemv", "Gemm")


def _tower_breakdown(prof, steps: int, cost=None) -> dict:
    """Device ms a step of the PLM tower's GEMMs, its plain attention and
    the rest of it, forward and backward (module doc, ``tower``): forward
    kernels under the ``plm_tower`` / ``plm_tower_attention`` ranges
    (``tower_ranges``), backward kernels of the autograd nodes whose
    sequence numbers the ranges' forward operations carry.  ``cost(event)``
    gives ``(name, us)`` pairs of what an event launched (default: its CUDA
    kernels but the ranges' own device spans)."""
    events = prof.events()
    annotations = {e.name for e in events if e.is_user_annotation}
    if cost is None:
        def cost(e):
            return [(k.name, k.duration) for k in e.kernels if k.name not in annotations]

    def subtree(e):
        yield e
        for c in e.cpu_children:
            yield from subtree(c)

    def kernels(e, skip=()):
        """(GEMM us, other us) of the kernels ``e`` and its children
        launched, leaving out the subtrees of ``skip``."""
        gemm = other = 0.0
        stack = [e]
        while stack:
            x = stack.pop()
            if x in skip:
                continue
            for name, duration in cost(x):
                if any(n in name for n in GEMM_KERNEL_NAMES):
                    gemm += duration
                else:
                    other += duration
            stack.extend(x.cpu_children)
        return gemm, other

    att_roots = [e for e in events if e.name == "plm_tower_attention"]
    tower_roots = [e for e in events if e.name == "plm_tower"]
    att_seq = {d.sequence_nr for r in att_roots for d in subtree(r) if d.sequence_nr >= 0}
    tower_seq = {d.sequence_nr for r in tower_roots for d in subtree(r)
                 if d.sequence_nr >= 0} - att_seq
    us = dict.fromkeys(("fwd_gemm", "fwd_attention", "fwd_other", "bwd_gemm",
                        "bwd_attention", "bwd_other"), 0.0)
    skip = set(att_roots)
    for r in att_roots:
        us["fwd_attention"] += sum(kernels(r))
    for r in tower_roots:
        g, o = kernels(r, skip)
        us["fwd_gemm"] += g
        us["fwd_other"] += o
    for e in events:
        if e.cpu_parent is not None or not e.name.startswith(
                "autograd::engine::evaluate_function"):
            continue
        if e.sequence_nr in att_seq:
            us["bwd_attention"] += sum(kernels(e))
        elif e.sequence_nr in tower_seq:
            g, o = kernels(e)
            us["bwd_gemm"] += g
            us["bwd_other"] += o
    out = {f"{k}_ms": v / 1e3 / steps for k, v in us.items()}
    for part in ("gemm", "attention", "other"):
        out[f"{part}_ms"] = out[f"fwd_{part}_ms"] + out[f"bwd_{part}_ms"]
    return out


@contextlib.contextmanager
def tower_ranges():
    """Within it, every PLM tower's forward runs in a ``plm_tower`` profiler
    range and its attention in ``plm_tower_attention`` (for
    ``_tower_breakdown``); outside, the model code has no range."""
    from torch.profiler import record_function

    from newsreclib_tpu_torch.models.components import plm

    saved = plm.self_attention, plm.TransformerEncoder.forward

    def ranged(fn, name):
        def call(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return call

    plm.self_attention = ranged(saved[0], "plm_tower_attention")
    plm.TransformerEncoder.forward = ranged(saved[1], "plm_tower")
    try:
        yield
    finally:
        plm.self_attention, plm.TransformerEncoder.forward = saved


def profile_cell(store, imp, batch_size: int, steps: int, card: str,
                 compute_dtype="bfloat16", model="nrms", remat: bool = False,
                 global_rows: bool = False, mesh=None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.models.components.attention import use_plain_attention
    from newsreclib_tpu_torch.ops import mhsa

    state, batcher, step = make_cell(store, imp, batch_size, "cuda", compute_dtype, model=model,
                                     remat=remat, global_rows=global_rows, mesh=mesh)
    plain_state, _, plain_step = make_cell(store, imp, batch_size, "cuda", compute_dtype,
                                           model=model, remat=remat, global_rows=global_rows,
                                           mesh=mesh)
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
    expected = sum(attention_launches(b, model, remat=remat) for b in timed)
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
    with tower_ranges(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
        wall_s = _sync_s(lambda: [step(state, b) for b in profiled])
    breakdown = _device_breakdown(prof, steps)
    if model == PLM_CELL:
        breakdown["tower"] = _tower_breakdown(prof, steps)
    busy_ms = breakdown["device_ms_per_step"]
    return {
        "model": model,
        "remat": remat,
        "batch_size": batch_size,
        "compute_dtype": compute_dtype or "float32",
        "global_rows": global_rows,
        "distributed": None if mesh is None else f"rank 0 of {mesh.world}, {mesh.backend}",
        "title_shapes": None if global_rows else sorted(
            {(tuple(b.news.title.shape), None if b.news2 is None else tuple(b.news2.title.shape))
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
    ap.add_argument("--remat", action="store_true",
                    help="model.remat: recompute the news tower in the backward pass")
    ap.add_argument("--global-rows", action="store_true",
                    help="global-row batches, deduplicated on the card")
    ap.add_argument("--distributed", action="store_true",
                    help="with --global-rows: rank 0 of a multi-host world of one over NCCL")
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
    mesh = None
    if args.distributed:
        from newsreclib_tpu_torch.parallel.launch import free_port
        from newsreclib_tpu_torch.parallel.mesh import init_mesh

        mesh = init_mesh(0, 1, 1, torch.device("cuda", 0), "nccl",
                         f"tcp://127.0.0.1:{free_port()}", replicated_batches=False)
    records = []
    for batch_size in PLM_BATCH_SIZES if args.model == PLM_CELL else BATCH_SIZES:
        rec = profile_cell(store, imp, batch_size, args.steps, card,
                           None if args.compute_dtype == "float32" else args.compute_dtype,
                           args.model, args.remat, args.global_rows or args.distributed, mesh)
        print("profile_train " + json.dumps(rec), flush=True)
        records.append(rec)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(r) + "\n" for r in records))
    if mesh is not None:
        from newsreclib_tpu_torch.parallel.mesh import destroy

        destroy()
    return 0


if __name__ == "__main__":
    sys.exit(main())
