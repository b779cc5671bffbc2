#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py

Imports the port (``newsreclib_tpu_torch``) and nothing of JAX, then:

1. prints the card's name and power limit, as ``nvidia-smi`` gives them;
2. builds every CUDA kernel of the port from ``csrc/`` (one nvcc each, in
   parallel);
3. drives the port's main path: NRMS cached serving at full width (D = 300,
   15 heads, query 200, vocab 60,000, bf16 parameters) over the workload of
   ``bench.py`` regenerated from a seed (32,768 articles, 16,384 impressions,
   history 50, 32 candidates).  One epoch warms up, one is timed; the kernel
   launch count of the timed epoch must equal what its shapes give (one per
   chunk of the corpus encode, one per impression batch).  The served
   metrics must be finite and equal those of the same pipeline with the
   plain attention forced, over the first 2,048 impressions;
4. drives NRMS training at the same width (float32 master parameters,
   bf16 compute, Adam lr 1e-4, dropout 0.2), fed by ``TrainBatcher`` over
   the same store and impressions at the data config's values (batch 64,
   K = 4, history 50, ``u_bucket_min`` 512, split at 16): 5 warm-up steps,
   then 50 timed steps, batching and host-to-device copies included; the
   kernel launch count of the timed steps must equal what their shapes give
   (one per news segment and one for the user encoder).  Then, from the
   same init, batch and dropout seeds, 20 steps at lr 1e-3 on one
   planted-signal batch with the kernel, with the plain attention and with
   two deliberately wrong attentions, in float32 and in bf16 compute: the
   kernel's per-step losses must agree with the plain ones
   (``ROUTE_ATOL``) and the wrong attentions' must not (``ROUTE_FAULTS``);
   the backward kernel's launch count of the timed steps must equal the
   forward's (one per attention call); ``FusedSmallMHSA``'s output and
   gradient (both kernels) against the plain version and autograd of it at
   every attention shape of the timed steps, in float32 and bf16, where a
   planted wrong gradient (the rowsum term of dS dropped) must fail the same
   check; and 50 steps at lr 1e-3 on the planted-signal batch, which must
   at least halve the loss;
5. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving and training paths give it, in float32 and bfloat16,
   with its time, its plain version's time and a library call's time
   (``newsreclib_tpu_torch/kernel_bench.py``: device time per launch from
   ``torch.profiler``, inputs rotated past the L2; the per-call CUDA event
   time, host cost included, is on each ``kernel_shape`` line);
6. times the backward kernel alone against its plain version
   (``mhsa_backward``) and SDPA's backward, and ``FusedSmallMHSA``'s forward
   + backward against autograd of the plain version and SDPA's, at the
   batch-64 training shapes in bfloat16 and float32
   (``kernel_bench.measure_backward``);
7. the zoo phase, on the same store, whose articles also carry abstracts,
   subcategories and title and abstract entities: MINS, CenNewsRec, CAUM
   and MINER at their config files' widths (MINS's user encoder 6 heads of
   50, the kernel's wide instances; CenNewsRec's and CAUM's D = 400 with 20
   heads; MINER's title encoder the NRMS shapes), in float32 and bf16
   compute, each trained ``ZOO_STEPS`` steps on ``TrainBatcher`` batches
   (batch 64, K = 4, history 50), where the kernel route must launch the
   forward and the backward kernel exactly once per attention call (MINS:
   title, abstract and user encoder; MINER: titles only); then
   the route check of step 4 for each model: 20 steps at lr 1e-3 on the
   planted-signal batch with the kernel, the plain attention and the
   planted faults (``ROUTE_ATOL``, ``ZOO_FAULTS``; MINER's in bf16, whose
   trajectory does not reproduce itself, is logged and not held,
   ``CHAOTIC_ROUTES``); then the kernel
   route's planted-trained model serves one ``CachedScorer`` epoch over
   the whole corpus and the first ``ZOO_IMPRESSIONS`` impressions, with an
   exact launch count and metrics equal to the same weights' plain
   pipeline's (``METRIC_ATOL``), and served scores that differ from the
   plain route's by no more than those of an attention that errs by the
   kernel tolerance at every output, where the unmasked fault must differ
   by more (``ZOO_FAULTS``).  Before the models, with the other profiled
   phases, both kernels at the zoo's user-encoder shapes
   (``kernel_bench.ZOO_SHAPES``) and at ``BOX_SHAPES`` (the PLM tower's
   MHSA at (512, 96, 768, 16 heads) and CAUM's default head dim 100 at
   (64, 50, 400, 4 heads), shapes beyond the kernel's earlier box of L <= 64
   and head dim <= 64)
   are held against the plain versions and timed, where the same checks
   must reject the planted faults of ``ELEMENT_FAULTS`` (logits 10% too
   large, the gradient's rowsum term dropped);
8. the models without an MHSA, NAML, TANR, LSTUR, NPA and DKN, at their
   config files' widths on the same store and impressions (which carry
   user ids): ``ZOO_STEPS`` train steps each in float32 and bf16 compute
   with finite losses and no kernel launch; in float32 with TF32 off, the
   fused forward's scores, the loss and one Adam step's update on the card
   against the port on the CPU from the same weights and batch
   (``CARD_CPU_TOL``), where a dropped history mask must fail each check;
   the served scores of one ``CachedScorer`` epoch equal to the fused
   forward's on the same impressions (NAML, TANR, LSTUR, DKN), and NPA's
   eval-step metrics through the trainer, card against CPU;
9. drives the training CLI in-process (``newsreclib_tpu_torch.train.run``)
   at full NRMS width (D = 300, 15 heads, GloVe 300-d, float32 as
   configured) on a copy of the raw ``data/demo`` files under
   ``build/smoke_demo``: ETL from the raw files, 2 epochs with cached
   validation, checkpoints, test from the best checkpoint.  The forward
   kernel's launches must equal one per non-empty news segment and one for
   the user encoder in every train step, plus one per corpus chunk and per
   impression batch of every evaluation; the backward kernel's, the train
   steps' alone.  Every ``val/*`` and ``test/*`` metric must be finite, the
   best and last checkpoints must exist, and the best checkpoint restored
   into a new trainer must give the same ``test/auc`` (1e-6) and, with the
   plain attention, the same test metrics (``METRIC_ATOL``);
10. prints one ``{"kernels": [...]}`` line (the wide instances' own
   entries, with their times at ``BOX_SHAPES`` under ``plm_*`` and
   ``hd100_*``; the D = 400 float32 times under ``d400_f32_*``; MINER's
   launches under ``miner_launches``) and, last, ``{"ok": true, ...}``.

Exits non-zero, printing no result, when no card is present or any phase
fails.  Writes nothing but the kernel build and the CLI phase's data copy
and run under ``build/``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

D = 300
# Served metrics, kernel pipeline vs plain-attention pipeline.  The two differ
# only by the order of float32 sums inside the attention; in bf16 that can move
# an attention output by one bf16 step, which can swap near-tied candidates.
METRIC_ATOL = {"float32": 1e-4, "bfloat16": 5e-3}
SERVING = dict(corpus=32768, n_impressions=16384, hist_len=50, num_candidates=32,
               title_len=30, vocab_size=60000)
COMPARE_IMPRESSIONS = 2048
ENCODE_BATCH, TARGET_CELLS = 4096, 16384  # corpus chunk rows; cells per impression batch
EVAL = dict(max_history_len=SERVING["hist_len"], target_cells=TARGET_CELLS,
            encode_batch=ENCODE_BATCH)
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_TIMED = 64, 5, 50
# Per-step losses over 20 steps on one planted-signal batch at lr 1e-3 (the
# loss falls from ln 5 to about 1e-3, so the trajectory depends on what the
# attention computes), kernel route vs plain route.  Readings on an H100
# (chip_smoke.py itself, three runs): correct routes 1.10e-5 to 1.17e-5
# (float32) and 1.86e-3 to 1.89e-3 (bf16); the planted faults: keys unmasked
# 0.677 / 0.678, logits 10% too large 6.1e-4 / 5.9e-4 to 1.3e-3.  A fault named in ROUTE_FAULTS[dtype]
# must differ by more than the tolerance, or the run fails; the 10% logit
# fault is under the bf16 routes' own spread, and is left to the element
# checks at the same shapes (kernel phase, check_backward).
ROUTE_STEPS = 20
ROUTE_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}
ROUTE_FAULTS = {"float32": ("unmasked", "scaled"), "bfloat16": ("unmasked",)}
PLANTED_STEPS, PLANTED_LR = 50, 1e-3
# The CLI phase: the demo data copied under build/ (never written in data/demo)
CLI_DATA, CLI_OUT = os.path.join(ROOT, "build", "smoke_demo"), os.path.join(ROOT, "build",
                                                                            "smoke_cli")
CLI_OVERRIDES = ["data=mind_demo", "model=nrms", "trainer.max_epochs=2",
                 f"data.data_dir={CLI_DATA}",
                 f"data.word_embeddings_fpath={os.path.join(CLI_DATA, 'glove_demo.txt')}",
                 f"output_dir={CLI_OUT}"]
CLI_RETEST_ATOL = 1e-6  # test/auc of the run against the best checkpoint restored
# The zoo phase: MINS, CenNewsRec, CAUM and MINER at their config files'
# widths, trained from the same init, batches and dropout seeds on both
# attention routes, then served over the whole corpus and the first
# ZOO_IMPRESSIONS.
ZOO = ("mins", "cen_news_rec", "caum", "miner")
ZOO_STEPS = 4
ZOO_IMPRESSIONS = 2048
# The planted faults the zoo's model-level checks must catch: the route check
# (ROUTE_ATOL) and the served scores.  The kernel route's served scores must
# differ from the plain route's by no more than those of the tolerance
# attention (tolerance_attention: every attention output moved by
# kernel_bench's ATOL + RTOL x |plain|), the error the element checks let
# through as it reaches the scores.  The element tolerances cannot be put on
# the scores themselves: the planted-signal models' scores reach hundreds,
# and an attention error within tolerance moves them by more (CAUM, float32:
# 2.26x ATOL + RTOL x |score|, one H100 run).  Keys unmasked move both checks
# by far more than their tolerances.  Logits 10% too large move the zoo
# models' planted-signal losses by less than the float32 tolerance (the
# planted loss falls to about 0 and the logits stay small), so that fault is
# logged there and must be caught by the element checks at the zoo's shapes
# (ELEMENT_FAULTS).
ZOO_FAULTS = {"float32": ("unmasked",), "bfloat16": ("unmasked",)}
# Route checks that cannot be held: MINER in bf16 compute.  Its loss (CE
# plus the disagreement term) falls from 2.58 to about 0.9 through a steep,
# unstable stretch where bf16 rounding moves the trajectory as far as the
# planted faults do: on an H100 (this script's route line, three runs) the
# plain route against itself differed by 0.040 to 0.079 over the 20 steps,
# keys unmasked by 0.24 to 0.27 and the tolerance attention by 0.25 to 0.30.
# There the route is logged with that spread and not held; MINER's kernel
# route in bf16 is held by the served-score check (the unmasked fault
# beyond), by its float32 route check and by the element checks of the same
# kernel instances (NRMS's).
CHAOTIC_ROUTES = {("miner", "bfloat16")}
# The models without an MHSA (module doc, phase 8): held, in float32 with
# TF32 off, against the port on the CPU from the same weights and batch (of
# CARD_CPU_BATCH impressions; dropout and LSTUR's user masking off, since a
# CUDA and a CPU generator draw different streams).  Each error is relative:
# max |scores difference| / max |CPU scores|, |loss difference| / |CPU
# loss| and ||card update - CPU update|| / ||CPU update|| over every
# parameter after one Adam step.  The planted fault (the history mask
# dropped on the card) must move the scores and the update by more than
# their tolerances; the loss of a fresh model stays near ln 5 whatever its
# small scores are, so the fault's loss error is logged only.
ZOO2 = ("naml", "tanr", "lstur", "npa", "dkn")
CARD_CPU_BATCH = 16
CARD_CPU_TOL = {"scores": 1e-4, "loss": 1e-5, "update": 1e-2}
CARD_CPU_FAULT_CHECKED = ("scores", "update")
# Served scores of a cacheable ZOO2 model against its fused forward on the
# same impressions (EvalBatcher batches), float32: the same arithmetic over
# other GEMM shapes.
SERVED_FUSED_TOL = dict(atol=1e-5, rtol=1e-5)
NPA_CPU_IMPRESSIONS = 64  # NPA's eval-step metrics, card against CPU
ELEMENT_FAULTS = {"float32": ("scaled", "rowsum"), "bfloat16": ("rowsum",)}
# Kernel shapes beyond the earlier box (L <= 64, head dim <= 64) that the zoo
# kernel phase checks and times beside ZOO_SHAPES: the PLM tower's MHSA at
# PLM-mode title length 96 and the JAX package's PLM operating point U = 512,
# and CAUMUserEncoder's default of 4 heads over 400 (head dim 100).
BOX_SHAPES = {"plm": (512, 96, 768, 16), "hd100": (64, 50, 400, 4)}


def log(*a):
    print(*a, flush=True)


def main_path_shapes(store):
    """The (U, L) the serving epoch gives the attention kernel: the chunks of
    each title-length segment of the corpus encode, and one batch of
    impression histories for the user encoder."""
    from newsreclib_tpu_torch.serving import corpus_segments

    shapes = []
    for rows, width in corpus_segments(store, 16, ENCODE_BATCH):
        sizes = {min(ENCODE_BATCH, len(rows) - i) for i in range(0, len(rows), ENCODE_BATCH)}
        shapes += [(u, width) for u in sorted(sizes, reverse=True)]
    return shapes + [(TARGET_CELLS // SERVING["num_candidates"], SERVING["hist_len"])]


def serving_launches(store, imp, hist_len=SERVING["hist_len"], target_cells=TARGET_CELLS):
    """Kernel launches of one serving epoch (``CachedScorer.evaluate``): one
    per chunk of the corpus encode and one per impression batch (the user
    encoder)."""
    from newsreclib_tpu_torch.data.batching import BucketedAssembler
    from newsreclib_tpu_torch.serving import corpus_segments

    encode = sum(math.ceil(len(rows) / ENCODE_BATCH)
                 for rows, _ in corpus_segments(store, 16, ENCODE_BATCH))
    buckets = BucketedAssembler(imp, hist_len, target_cells).buckets
    return encode + sum(math.ceil(len(idx) / max(1, target_cells // c))
                        for c, idx in buckets.items())


def kernel_phase(shapes):
    """Hold fused_small_mhsa against mhsa_plain at every shape given, in
    float32 and bfloat16, and time it, the plain version and SDPA
    (``kernel_bench.measure_shape``).  Returns the per-shape records."""
    import torch

    from newsreclib_tpu_torch.kernel_bench import measure_shape
    from newsreclib_tpu_torch.ops import mhsa

    records = []
    for dtype in (torch.float32, torch.bfloat16):
        for u, l in shapes:
            rec = measure_shape(u, l, dtype, [("kernel", mhsa.fused_small_mhsa)])
            log("kernel_shape " + json.dumps(rec))
            records.append(rec)
    return records


def backward_phase(shapes):
    """Time the backward kernel at the training shapes given, in bfloat16
    and float32 (``kernel_bench.measure_backward``, which checks it first).
    Returns the per-shape records."""
    import torch

    from newsreclib_tpu_torch.kernel_bench import measure_backward

    records = []
    for dtype in (torch.bfloat16, torch.float32):
        for u, l in shapes:
            rec = measure_backward(u, l, dtype)
            log("backward_shape " + json.dumps(rec))
            records.append(rec)
    return records


def plain_copy(model):
    """A copy of ``model`` with every MHSA forced onto the plain attention."""
    from newsreclib_tpu_torch.models.components.attention import use_plain_attention

    return use_plain_attention(copy.deepcopy(model))


def serving_phase(card: str, store, imp):
    """The main path; returns the kernel launch count of the timed epoch."""
    import torch

    from newsreclib_tpu_torch.models.general_rec import NRMS
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.serving import CachedScorer, build_news_vector_table

    model = NRMS(SERVING["vocab_size"], device="cuda",
                 generator=torch.Generator().manual_seed(0)).eval()
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)

    table = build_news_vector_table(model_bf16, store, ENCODE_BATCH, device="cuda")
    if table.shape != (SERVING["corpus"] + 1, D) or not bool(torch.isfinite(table).all()):
        raise AssertionError(f"news table {tuple(table.shape)} not finite or wrong shape")
    if bool(table[0].any()):
        raise AssertionError("row 0 of the news table is not zero")

    scorer = CachedScorer(model_bf16, device="cuda")
    scorer.evaluate(store, imp, **EVAL)  # warm-up: builds the device caches
    torch.cuda.synchronize()
    mhsa.launches = 0
    t0 = time.perf_counter()
    metrics = scorer.evaluate(store, imp, **EVAL)  # ends in one device-to-host fetch
    epoch_s = time.perf_counter() - t0
    launches, expected = mhsa.launches, serving_launches(store, imp)
    log(f"serving epoch: {epoch_s:.4f} s for {len(imp)} impressions -> "
        f"{len(imp) / epoch_s:.1f} impressions/s on {card}; "
        f"fused_small_mhsa launches {launches} ({expected} expected)")
    log("metrics " + json.dumps(metrics, sort_keys=True))
    if launches != expected:
        raise AssertionError(f"the serving epoch launched fused_small_mhsa {launches} times "
                             f"({expected} expected)")
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad or len(metrics) < 10:
        raise AssertionError(f"metrics not finite or missing: {metrics}")

    sub = imp.subset(COMPARE_IMPRESSIONS)
    for name, m in (("bfloat16", model_bf16), ("float32", model)):
        got = CachedScorer(m, device="cuda").evaluate(store, sub, **EVAL)
        want = CachedScorer(plain_copy(m), device="cuda").evaluate(store, sub, **EVAL)
        diff = max(abs(got[k] - want[k]) for k in want)
        log(f"served metrics, kernel vs plain attention, first {COMPARE_IMPRESSIONS} "
            f"impressions, {name}: max abs diff {diff:.3g} (tolerance {METRIC_ATOL[name]})")
        if set(got) != set(want) or diff > METRIC_ATOL[name]:
            raise AssertionError(f"served metrics differ ({name}): {got} vs {want}")
    return launches


def unmasked_attention(qkv, mask, num_heads):
    """A planted fault: the plain attention with every key valid."""
    import torch

    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    return mhsa_plain(qkv, torch.ones_like(mask), num_heads)


def scaled_attention(qkv, mask, num_heads):
    """A planted fault: the plain attention with logits 10% too large."""
    import torch

    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    q, kv = qkv.split([qkv.shape[-1] // 3, 2 * qkv.shape[-1] // 3], dim=-1)
    return mhsa_plain(torch.cat([q * 1.1, kv], dim=-1).contiguous(), mask, num_heads)


FAULTS = {"unmasked": unmasked_attention, "scaled": scaled_attention}


def tolerance_attention(dtype: str):
    """The plain attention with every output element moved by the kernel
    tolerance (``kernel_bench.ATOL + RTOL x |plain|``) up or down at
    random: what the element checks let through, as seen by the model."""
    import torch

    from newsreclib_tpu_torch.kernel_bench import ATOL, RTOL
    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    gen = torch.Generator(device="cuda").manual_seed(0)

    def attention(qkv, mask, num_heads):
        out = mhsa_plain(qkv, mask, num_heads).float()
        sign = torch.randint(0, 2, out.shape, generator=gen, device=out.device) * 2 - 1
        return (out + (ATOL[dtype] + RTOL[dtype] * out.abs()) * sign).to(qkv.dtype)

    return attention


def backward_without_rowsum(qkv, mask, num_heads, grad_out):
    """A planted fault: the attention gradient with dS = P * dP, the
    rowsum(dP * P) term dropped (``mhsa_backward`` otherwise)."""
    import torch

    from newsreclib_tpu_torch.ops.mhsa import _heads, _probabilities

    u, l, d3 = qkv.shape
    d = d3 // 3
    scale = 1.0 / math.sqrt(d // num_heads)
    q, k, v = qkv.float().split(d, dim=-1)
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    p = _probabilities(q, k, mask, num_heads)
    do = _heads(grad_out.float(), num_heads)
    ds = torch.where(mask[:, None, None, :], p * (do @ vh.transpose(-1, -2)), 0.0)
    grads = (ds @ kh * scale, ds.transpose(-1, -2) @ qh * scale, p.transpose(-1, -2) @ do)
    return torch.cat([g.transpose(1, 2).reshape(u, l, d) for g in grads], dim=-1).to(qkv.dtype)


def element_faults():
    """The planted faults of ``ELEMENT_FAULTS`` as ``kernel_bench.check_backward``
    arguments: the output and gradient of logits 10% too large, and the
    gradient without the rowsum term."""
    from newsreclib_tpu_torch.ops import mhsa

    return {"scaled": dict(forward=scaled_attention, backward=mhsa.mhsa_backward),
            "rowsum": dict(backward=backward_without_rowsum)}


def set_attention(model, attention):
    """``model`` with every MHSA's attention set to ``attention`` ("plain":
    ``mhsa_plain``; a function: that function; None: the kernel), in place."""
    from newsreclib_tpu_torch.models.components.attention import (
        MultiHeadSelfAttention,
        use_plain_attention,
    )

    if attention == "plain":
        return use_plain_attention(model)
    if attention is not None:
        for m in model.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.attention = attention
    return model


def planted_batch():
    """The planted-signal batch of the route checks, on the card: batch 64,
    history 50, 5 candidates over 1,024 articles with every field."""
    import numpy as np

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch

    cfg = SyntheticConfig(vocab_size=SERVING["vocab_size"])
    return to_device(make_batch(np.random.default_rng(0), batch_size=TRAIN_BATCH,
                                hist_len=SERVING["hist_len"], num_candidates=5,
                                unique_news=1024, cfg=cfg, planted_signal=True), "cuda")


def route_losses(batches, cdtype, lr, attention, model="nrms"):
    """Per-step losses of a fresh ``model`` cell (``profile_train``'s init,
    Adam, cross-entropy, dropout seed 0) over ``batches`` with every MHSA's
    attention set to ``attention`` (``set_attention``), and the trained
    model."""
    import torch

    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.profile_train import build_cell_model
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    st = create_train_state(set_attention(build_cell_model(model, "cuda"), attention),
                            make_optimizer(lr), dropout_seed=0)
    stp = make_train_step(cross_entropy_loss, cdtype)
    return torch.stack([stp(st, b)[1]["loss"] for b in batches]).cpu(), st.model


def training_phase(card: str, store, imp):
    """The training path, then its checks (see module doc).  Returns the
    forward and the backward kernel launches of the timed steps, the step
    time in seconds, the attention shapes (U, L) of the timed steps and the
    largest gradient error of the checks."""
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.kernel_bench import check_backward
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import DATA, attention_launches, make_cell

    state, batcher, step = make_cell(store, imp, TRAIN_BATCH, "cuda")
    log(f"training: {batcher.num_samples()} positives -> {len(batcher)} steps an epoch at "
        f"batch {TRAIN_BATCH}")
    batches = batcher.epoch(0)
    for _ in range(TRAIN_WARMUP):
        step(state, to_device(next(batches), "cuda"))
    torch.cuda.synchronize()
    shapes, losses, expected = set(), [], 0
    mhsa.launches = mhsa.bwd_launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_TIMED):
        b = next(batches)
        expected += attention_launches(b)
        shapes.add(tuple(tuple(seg.title.shape) for seg in (b.news, b.news2) if seg is not None))
        losses.append(step(state, to_device(b, "cuda"))[1]["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_TIMED
    launches, bwd_launches = mhsa.launches, mhsa.bwd_launches
    losses = torch.stack(losses).cpu()
    log(f"train step (batching and copies included): {step_s * 1e3:.4f} ms, "
        f"{TRAIN_BATCH / step_s:.1f} impressions/s on {card}; news segments {sorted(shapes)}; "
        f"fused_small_mhsa launches {launches} ({launches / TRAIN_TIMED} a step, "
        f"{expected} expected), its backward {bwd_launches} ({expected} expected); "
        f"loss {losses[0].item():.4f} -> {losses[-1].item():.4f}")
    if launches != expected or bwd_launches != expected:
        raise AssertionError(f"{launches} forward and {bwd_launches} backward kernel launches "
                             f"({expected} each expected)")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"train losses not finite: {losses}")
    del state

    # kernel route vs plain route, same init, batch and dropout seeds; the
    # planted faults show that the comparison can fail
    planted = planted_batch()
    for name, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
        route = [planted] * ROUTE_STEPS
        kernel = route_losses(route, cdtype, PLANTED_LR, None)[0]
        plain = route_losses(route, cdtype, PLANTED_LR, "plain")[0]
        diff = (kernel - plain).abs().max().item()
        faults = {f: (route_losses(route, cdtype, PLANTED_LR, fn)[0]
                      - plain).abs().max().item() for f, fn in FAULTS.items()}
        log(f"train losses over {ROUTE_STEPS} steps on a planted-signal batch at lr "
            f"{PLANTED_LR}, kernel vs plain attention, {name}: max abs diff {diff:.3g} "
            f"(tolerance {ROUTE_ATOL[name]}); planted faults vs plain: {json.dumps(faults)}; "
            f"kernel {kernel[0].item():.5f} -> {kernel[-1].item():.5f}")
        if not bool(torch.isfinite(kernel).all()) or diff > ROUTE_ATOL[name]:
            raise AssertionError(f"train losses differ ({name}): {kernel} vs {plain}")
        missed = [f for f in ROUTE_FAULTS[name] if not faults[f] > ROUTE_ATOL[name]]
        if missed:
            raise AssertionError(f"the route check ({name}) does not tell the planted "
                                 f"faults {missed} from the plain attention: {faults}")

    # the output and gradient at the step's attention shapes
    grad_shapes = sorted({seg for sh in shapes for seg in sh}, reverse=True)
    grad_shapes.append((TRAIN_BATCH, DATA["max_history_len"]))
    grad_errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for u, l in grad_shapes:
            fwd_err, err, _ = check_backward(u, l, dtype)
            grad_errs.append(err)
            log(f"FusedSmallMHSA vs plain at ({u}, {l}) {dtype}: output max abs err "
                f"{fwd_err:.3g}, gradient max abs err {err:.3g}")
        u, l = grad_shapes[0]
        try:
            check_backward(u, l, dtype, backward=backward_without_rowsum)
        except AssertionError as e:
            log(f"planted wrong gradient (rowsum dropped) at ({u}, {l}) {dtype}: caught ({e})")
        else:
            raise AssertionError(f"the gradient check at ({u}, {l}) {dtype} does not tell a "
                                 "gradient without the rowsum term from the plain one")

    # planted signal: the loss falls on one fixed batch
    curve = route_losses([planted] * PLANTED_STEPS, "bfloat16", PLANTED_LR, None)[0]
    log(f"planted signal, {PLANTED_STEPS} steps at lr {PLANTED_LR}: loss "
        f"{curve[0].item():.4f} -> {curve[-1].item():.4f}")
    if not curve[-1].item() <= curve[0].item() / 2:
        raise AssertionError(f"the planted-signal loss did not halve: {curve.tolist()}")
    return launches, bwd_launches, step_s, grad_shapes, max(grad_errs)


def cli_phase(card: str):
    """The training CLI on the demo data at full NRMS width (module doc,
    phase 9).  Returns the forward and backward kernel launches of the run
    and the phase's wall time in seconds."""
    import shutil

    import torch

    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.config.compose import compose
    from newsreclib_tpu_torch.models.components.attention import use_plain_attention
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import attention_launches

    for d in (CLI_DATA, CLI_OUT):
        shutil.rmtree(d, ignore_errors=True)
    demo = os.path.join(ROOT, "data", "demo")
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        os.makedirs(os.path.join(CLI_DATA, split))
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            shutil.copy(os.path.join(demo, split, name), os.path.join(CLI_DATA, split, name))
    shutil.copy(os.path.join(demo, "glove_demo.txt"), CLI_DATA)
    cfg = compose(overrides=CLI_OVERRIDES)
    m = cfg["model"]
    log(f"CLI: NRMS D={m['embed_dim']}, {m['num_heads']} heads, query {m['query_dim']}, "
        f"GloVe {cfg['data']['word_embed_dim']}-d, precision "
        f"{cfg['trainer'].get('precision') or 'float32'}, {cfg['trainer']['max_epochs']} epochs")

    torch.cuda.synchronize()
    mhsa.launches = mhsa.bwd_launches = 0
    t0 = time.perf_counter()
    metrics = train.run(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, bwd_launches = mhsa.launches, mhsa.bwd_launches

    caches = [os.path.join(CLI_DATA, "MINDdemo_train", f) for f in
              ("news_store.npz", "parsed_news.tsv", "train_impressions.npz",
               "transformed_word_embeddings.npy")]
    missing = [c for c in caches if not os.path.exists(c)]
    if missing:
        raise AssertionError(f"the ETL did not run from the raw files: {missing} missing")
    ckpts = [os.path.join(CLI_OUT, "checkpoints", f"{w}.pt") for w in ("best", "last")]
    if not all(os.path.exists(c) for c in ckpts):
        raise AssertionError(f"checkpoints missing: {ckpts}")
    with open(os.path.join(CLI_OUT, "checkpoints", "last.json")) as f:
        epochs = json.load(f)["epoch"] + 1

    # the launches the run's batches give, counted on the host
    quiet = compose(overrides=CLI_OVERRIDES + ["loggers=[]"])
    r = train.build_run(quiet)
    train_expected = sum(attention_launches(b) for e in range(epochs)
                         for b in r.train_batcher.epoch(e))
    dc = cfg["data"]
    eval_launches = [serving_launches(b.store, b.imp, dc["max_history_len"],
                                      dc["eval_target_cells"])
                     for b in (r.val_batcher, r.test_batcher)]
    expected = train_expected + epochs * eval_launches[0] + eval_launches[1]
    log(f"CLI run: {wall_s:.2f} s wall on {card}; {epochs} epochs of {len(r.train_batcher)} "
        f"steps; fused_small_mhsa launches {launches} ({expected} expected: {train_expected} in "
        f"train steps, {eval_launches[0]} a validation, {eval_launches[1]} the test), its "
        f"backward {bwd_launches} ({train_expected} expected)")
    log("CLI metrics " + json.dumps(metrics, sort_keys=True))
    if launches != expected or bwd_launches != train_expected:
        raise AssertionError(f"{launches} forward and {bwd_launches} backward kernel launches "
                             f"({expected} and {train_expected} expected)")
    evals = {k: v for k, v in metrics.items() if k.startswith(("val/", "test/"))}
    bad = [k for k, v in evals.items() if not math.isfinite(v)]
    if bad or "val/loss" not in evals or "test/auc" not in evals:
        raise AssertionError(f"val/test metrics not finite or missing: {bad} in {evals}")

    # the best checkpoint restored into a new trainer, with the kernel and
    # with the plain attention
    again = r.trainer.test(r.test_batcher)
    diff = abs(again["test/auc"] - metrics["test/auc"])
    use_plain_attention(r.trainer.state.model)
    plain = r.trainer.test(r.test_batcher)
    plain_diff = max(abs(plain[k] - again[k]) for k in again)
    log(f"CLI best checkpoint restored: test/auc {again['test/auc']:.6f} against the run's "
        f"{metrics['test/auc']:.6f} (diff {diff:.3g}, tolerance {CLI_RETEST_ATOL}); plain "
        f"attention vs kernel, test metrics: max abs diff {plain_diff:.3g} (tolerance "
        f"{METRIC_ATOL['float32']})")
    if diff > CLI_RETEST_ATOL or set(plain) != set(again) or plain_diff > METRIC_ATOL["float32"]:
        raise AssertionError(f"the restored test differs: {again} / {plain} vs {metrics}")
    return launches, bwd_launches, wall_s


def zoo_serving_launches(name, store, imp) -> int:
    """Kernel launches of one zoo serving epoch: the news encoder's
    attention calls of each corpus chunk and the user encoder's of each
    impression batch (MINER's user encoder has none)."""
    from newsreclib_tpu_torch.data.batching import BucketedAssembler
    from newsreclib_tpu_torch.profile_train import TEXT_ATTENTIONS, USER_ATTENTIONS
    from newsreclib_tpu_torch.serving import corpus_segments

    chunks = sum(math.ceil(len(rows) / ENCODE_BATCH)
                 for rows, _ in corpus_segments(store, 16, ENCODE_BATCH))
    buckets = BucketedAssembler(imp, SERVING["hist_len"], TARGET_CELLS).buckets
    return TEXT_ATTENTIONS[name] * chunks + USER_ATTENTIONS.get(name, 0) * sum(
        math.ceil(len(idx) / max(1, TARGET_CELLS // c)) for c, idx in buckets.items())


def served_scores(model, store, imp, cdtype, attention):
    """Every candidate's score over ``imp`` from cached serving's own steps
    (the corpus table of ``build_news_vector_table``, then
    ``score_with_vectors`` on ``BucketedAssembler`` batches), for a copy of
    ``model`` in ``cdtype`` with its attention set to ``attention``."""
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import BucketedAssembler
    from newsreclib_tpu_torch.serving import build_news_vector_table

    m = set_attention(copy.deepcopy(model).eval(), attention)
    if cdtype is not None:
        m = m.to(getattr(torch, cdtype))
    with torch.inference_mode():
        table = build_news_vector_table(m, store, ENCODE_BATCH, device="cuda")
        batches = [to_device(b, "cuda")
                   for b in BucketedAssembler(imp, SERVING["hist_len"], TARGET_CELLS)]
        return torch.cat([m.score_with_vectors(b, table).float()[
            b.cand_mask & b.impression_valid[:, None]] for b in batches])


def zoo_phase(card: str, store, imp):
    """MINS, CenNewsRec, CAUM and MINER, each at its config file's widths,
    in float32 and bf16 compute (module doc, step 7):

    * ZOO_STEPS train steps (Adam lr 1e-4, dropout 0.2) on ``TrainBatcher``
      batches (batch 64, K = 4, history 50, split at 16): the kernel route
      must launch the forward and the backward kernel exactly once per
      attention call;
    * the route check: ROUTE_STEPS steps at PLANTED_LR on the planted-signal
      batch from the same init and dropout seeds with the kernels, with the
      plain attention and with each planted fault; the per-step losses of the
      kernel and the plain route must agree (``ROUTE_ATOL``) and those of
      each fault in ``ZOO_FAULTS`` must not (logged only in
      ``CHAOTIC_ROUTES``);
    * the kernel route's trained model serves one ``CachedScorer`` epoch (the
      whole corpus encoded with every field the model reads, the first
      ZOO_IMPRESSIONS impressions scored) with an exact launch count and
      metrics equal to the same weights' plain-attention pipeline's
      (``METRIC_ATOL``); the kernel route's served scores must differ from
      the plain route's by no more than those of ``tolerance_attention``,
      and each fault's in ``ZOO_FAULTS`` by more.

    Returns the forward, backward, wide forward and wide backward (head dim
    above 32) launches of the ``TrainBatcher`` steps and the serving epochs,
    in all and by model."""
    import numpy as np
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import DATA, attention_launches, build_cell_model
    from newsreclib_tpu_torch.serving import CachedScorer
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    sub = imp.subset(ZOO_IMPRESSIONS)
    planted = [planted_batch()] * ROUTE_STEPS
    counts = np.zeros(4, dtype=np.int64)  # forward, backward, wide forward, wide backward
    by_model = {name: np.zeros(4, dtype=np.int64) for name in ZOO}
    for name in ZOO:
        for dname, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
            state = create_train_state(build_cell_model(name, "cuda"), make_optimizer(1e-4),
                                       dropout_seed=0)
            step = make_train_step(cross_entropy_loss, cdtype)
            batches = TrainBatcher(store, imp, batch_size=TRAIN_BATCH, **DATA).epoch(0)
            calls, out = 0, []
            torch.cuda.synchronize()
            mhsa.launches = mhsa.bwd_launches = 0
            mhsa.wide_launches = mhsa.wide_bwd_launches = 0
            t0 = time.perf_counter()
            for _ in range(ZOO_STEPS):
                b = next(batches)
                calls += attention_launches(b, name)
                out.append(step(state, to_device(b, "cuda"))[1]["loss"])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / ZOO_STEPS * 1e3
            got = np.array([mhsa.launches, mhsa.bwd_launches, mhsa.wide_launches,
                            mhsa.wide_bwd_launches])
            counts += got
            by_model[name] += got
            out = torch.stack(out).cpu()
            log(f"zoo {name} {dname}: {ZOO_STEPS} train steps at batch {TRAIN_BATCH}, "
                f"{step_ms:.2f} ms a step on {card}; kernel launches {got[0]} forward / "
                f"{got[1]} backward ({calls} attention calls; {got[2]} wide); losses "
                f"{[round(x, 5) for x in out.tolist()]}")
            if got[0] != calls or got[1] != calls:
                raise AssertionError(f"zoo {name} {dname}: {got[0]} forward and {got[1]} "
                                     f"backward kernel launches ({calls} expected)")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"zoo {name} {dname} train losses not finite: {out}")
            if (got[2] > 0) != (name == "mins"):
                raise AssertionError(f"zoo {name}: {got[2]} wide launches")
            del state

            kernel, model = route_losses(planted, cdtype, PLANTED_LR, None, name)
            mhsa.launches = 0
            plain = route_losses(planted, cdtype, PLANTED_LR, "plain", name)[0]
            if mhsa.launches:
                raise AssertionError(f"zoo {name}: the plain route launched the kernel")
            def gap(attention):
                return (route_losses(planted, cdtype, PLANTED_LR, attention, name)[0]
                        - plain).abs().max().item()

            diff = (kernel - plain).abs().max().item()
            faults = {f: gap(fn) for f, fn in FAULTS.items()}
            chaotic = (name, dname) in CHAOTIC_ROUTES
            spread = (f"; not held (CHAOTIC_ROUTES): the plain route against itself "
                      f"{gap('plain'):.3g}, the tolerance attention "
                      f"{gap(tolerance_attention(dname)):.3g}") if chaotic else ""
            log(f"zoo {name} {dname}: train losses over {ROUTE_STEPS} steps on a "
                f"planted-signal batch at lr {PLANTED_LR}, kernel vs plain attention: max abs "
                f"diff {diff:.3g} (tolerance {ROUTE_ATOL[dname]}{spread}); planted faults vs "
                f"plain: {json.dumps(faults)}; kernel {kernel[0].item():.5f} -> "
                f"{kernel[-1].item():.5f}")
            if not bool(torch.isfinite(kernel).all()) or (not chaotic
                                                          and diff > ROUTE_ATOL[dname]):
                raise AssertionError(f"zoo {name} {dname} train losses differ: {kernel} vs "
                                     f"{plain}")
            missed = [f for f in ZOO_FAULTS[dname]
                      if not chaotic and not faults[f] > ROUTE_ATOL[dname]]
            if missed:
                raise AssertionError(f"zoo {name} {dname}: the route check does not tell the "
                                     f"planted faults {missed} from the plain attention")

            metrics = {}
            for route, m in (("kernel", model), ("plain", plain_copy(model))):
                mhsa.launches = mhsa.wide_launches = 0
                metrics[route] = CachedScorer(m, compute_dtype=cdtype, device="cuda"
                                              ).evaluate(store, sub, **EVAL)
                launches = mhsa.launches
                want = zoo_serving_launches(name, store, sub) if route == "kernel" else 0
                if launches != want:
                    raise AssertionError(f"zoo {name} {dname} {route} serving epoch: {launches}"
                                         f" kernel launches ({want} expected)")
                if route == "kernel":
                    counts[0] += launches
                    counts[2] += mhsa.wide_launches
                    by_model[name][0] += launches
                    by_model[name][2] += mhsa.wide_launches
                    served_launches = launches
            got, want = metrics["kernel"], metrics["plain"]
            diff = max(abs(got[k] - want[k]) for k in want)
            bad = [k for k, v in got.items() if not math.isfinite(v)]
            routes = (("kernel", None), ("plain", "plain"),
                      ("tolerance", tolerance_attention(dname)), *FAULTS.items())
            scores = {r: served_scores(model, store, sub, cdtype, fn) for r, fn in routes}
            want_s = scores.pop("plain")
            gaps = {r: (s - want_s).abs().max().item() for r, s in scores.items()}
            limit = gaps.pop("tolerance")
            ratio = {r: g / limit for r, g in gaps.items()}
            log(f"zoo {name} {dname}: served metrics over {ZOO_IMPRESSIONS} impressions "
                f"(auc {got['auc']:.4f}), {served_launches} kernel launches; kernel vs plain "
                f"attention max abs diff {diff:.3g} (tolerance {METRIC_ATOL[dname]}); "
                f"{want_s.numel()} served scores (max |plain| {want_s.abs().max().item():.4g}), "
                f"max abs diff from the plain route's: {json.dumps(gaps)}, over the tolerance "
                f"attention's {limit:.4g}: {json.dumps(ratio)} (kernel within 1, faults "
                f"{list(ZOO_FAULTS[dname])} beyond)")
            if bad or set(got) != set(want) or diff > METRIC_ATOL[dname]:
                raise AssertionError(f"zoo {name} {dname} served metrics differ: {got} vs {want}")
            if not bool(torch.isfinite(scores["kernel"]).all()) or not ratio["kernel"] <= 1:
                raise AssertionError(f"zoo {name} {dname}: served scores differ from the "
                                     f"plain route's: {ratio}")
            missed = [f for f in ZOO_FAULTS[dname] if not ratio[f] > 1]
            if missed:
                raise AssertionError(f"zoo {name} {dname}: the served-score check does not "
                                     f"tell the planted faults {missed} from the plain route")
            del model, scores
    return counts, by_model


def without_dropout(model):
    """``model`` with every dropout rate and LSTUR's user masking at 0, in
    place."""
    from newsreclib_tpu_torch.models.components.dropout import Dropout
    from newsreclib_tpu_torch.models.components.user import LSTURUserEncoder

    for m in model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
        elif isinstance(m, LSTURUserEncoder):
            m.user_masking_probability = 0.0
    return model


def forward_and_step(model, batch, device):
    """``model`` on ``device``: the fused forward's scores (eval mode), then
    one train step (Adam lr 1e-4, cross-entropy) on ``batch``.  Returns the
    scores, the loss and every parameter's update, on the CPU."""
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    b = to_device(batch, device)
    before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    with torch.no_grad():
        scores = model.eval()(b)[0].float().cpu()
    state = create_train_state(model.train(), make_optimizer(1e-4), dropout_seed=0)
    loss = make_train_step(cross_entropy_loss)(state, b)[1]["loss"].item()
    update = torch.cat([(p.detach().cpu() - before[n]).reshape(-1)
                        for n, p in model.named_parameters()])
    return scores, loss, update


def card_cpu_errors(got, want) -> dict:
    """The relative errors of ``CARD_CPU_TOL`` between two
    ``forward_and_step`` results."""
    (s, l, u), (ws, wl, wu) = got, want
    return {"scores": ((s - ws).abs().max() / ws.abs().max()).item(),
            "loss": abs(l - wl) / abs(wl),
            "update": ((u - wu).norm() / wu.norm()).item()}


def fused_scores(model, store, imp, margin):
    """Every candidate's score over ``imp`` from the fused forward on
    ``EvalBatcher`` batches (each with its own news table), in the order of
    ``served_scores``."""
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import EvalBatcher

    with torch.inference_mode():
        out = []
        for b in EvalBatcher(store, imp, SERVING["hist_len"], TARGET_CELLS, split_title_len=16,
                             split_margin=margin):
            b = to_device(b, "cuda")
            out.append(model(b)[0].float()[b.cand_mask & b.impression_valid[:, None]])
        return torch.cat(out)


def zoo2_phase(card: str, store, imp):
    """NAML, TANR, LSTUR, NPA and DKN, which run no attention kernel, each
    at its config file's widths (module doc, step 8):

    * ZOO_STEPS train steps (Adam lr 1e-4, dropout 0.2, LSTUR's user masking
      0.5) on ``TrainBatcher`` batches of TRAIN_BATCH impressions, in
      float32 and bf16 compute: finite losses and no kernel launch;
    * float32 on the card against the port on the CPU from the same weights
      and batch (CARD_CPU_BATCH impressions, dropout off): the fused
      forward's scores, the loss and the update of one train step, each
      within ``CARD_CPU_TOL``; the planted fault (the history mask dropped
      on the card) beyond the scores' and the update's;
    * NAML, TANR, LSTUR and DKN: one ``CachedScorer`` epoch over the first
      ZOO_IMPRESSIONS impressions (finite metrics), whose served scores equal
      the fused forward's on ``EvalBatcher`` batches of the same impressions
      (``SERVED_FUSED_TOL``), in float32;
    * NPA (no cacheable split): the trainer's eval-step path over the same
      impressions, finite metrics, and over the first NPA_CPU_IMPRESSIONS
      equal to the CPU's (``METRIC_ATOL``).

    Returns the largest error of each comparison."""
    import numpy as np
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import EvalBatcher, TrainBatcher
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import DATA, build_cell_model
    from newsreclib_tpu_torch.serving import CachedScorer
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    sub = imp.subset(ZOO_IMPRESSIONS)
    worst = {k: 0.0 for k in (*CARD_CPU_TOL, "served_vs_fused", "npa_metrics")}
    for name in ZOO2:
        for dname, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
            state = create_train_state(build_cell_model(name, "cuda"), make_optimizer(1e-4),
                                       dropout_seed=0)
            step = make_train_step(cross_entropy_loss, cdtype)
            batches = TrainBatcher(store, imp, batch_size=TRAIN_BATCH, **DATA).epoch(0)
            torch.cuda.synchronize()
            mhsa.launches = mhsa.bwd_launches = 0
            t0 = time.perf_counter()
            out = torch.stack([step(state, to_device(next(batches), "cuda"))[1]["loss"]
                               for _ in range(ZOO_STEPS)]).cpu()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / ZOO_STEPS * 1e3
            log(f"zoo {name} {dname}: {ZOO_STEPS} train steps at batch {TRAIN_BATCH}, "
                f"{step_ms:.2f} ms a step on {card}; kernel launches {mhsa.launches} / "
                f"{mhsa.bwd_launches}; losses {[round(x, 5) for x in out.tolist()]}")
            if not bool(torch.isfinite(out).all()) or mhsa.launches or mhsa.bwd_launches:
                raise AssertionError(f"zoo {name} {dname}: losses {out}, kernel launches "
                                     f"{mhsa.launches} / {mhsa.bwd_launches}")
            del state

        cpu_model = without_dropout(build_cell_model(name, "cpu"))
        batch = next(TrainBatcher(store, imp, batch_size=CARD_CPU_BATCH, **DATA).epoch(0))
        want = forward_and_step(copy.deepcopy(cpu_model), batch, "cpu")
        errs = card_cpu_errors(forward_and_step(copy.deepcopy(cpu_model).cuda(), batch, "cuda"),
                               want)
        unmasked = batch._replace(hist_mask=np.ones_like(batch.hist_mask))
        fault = card_cpu_errors(forward_and_step(copy.deepcopy(cpu_model).cuda(), unmasked,
                                                 "cuda"), want)
        log(f"zoo {name} float32, card vs CPU from the same weights and batch ({CARD_CPU_BATCH} "
            f"impressions, dropout off): relative errors {json.dumps(errs)} (tolerances "
            f"{json.dumps(CARD_CPU_TOL)}); history mask dropped on the card: "
            f"{json.dumps(fault)}")
        for k, tol in CARD_CPU_TOL.items():
            worst[k] = max(worst[k], errs[k])
            if not errs[k] <= tol:
                raise AssertionError(f"zoo {name}: card vs CPU {k} error {errs[k]} > {tol}")
            if k in CARD_CPU_FAULT_CHECKED and not fault[k] > tol:
                raise AssertionError(f"zoo {name}: the card-vs-CPU {k} check does not tell a "
                                     f"dropped history mask ({fault[k]} <= {tol})")

        model = cpu_model.cuda().eval()
        if name != "npa":
            mhsa.launches = 0
            metrics = CachedScorer(model, device="cuda").evaluate(store, sub, **EVAL)
            bad = [k for k, v in metrics.items() if not math.isfinite(v)]
            served = served_scores(model, store, sub, None, None)
            fused = fused_scores(model, store, sub, getattr(model, "TITLE_SPLIT_MARGIN", 0))
            diff = (served - fused).abs().max().item()
            limit = SERVED_FUSED_TOL["atol"] + SERVED_FUSED_TOL["rtol"] * fused.abs().max().item()
            worst["served_vs_fused"] = max(worst["served_vs_fused"], diff)
            log(f"zoo {name} float32: served metrics over {ZOO_IMPRESSIONS} impressions (auc "
                f"{metrics.get('auc', float('nan')):.4f}), {mhsa.launches} kernel launches; "
                f"{served.numel()} served scores against the fused forward's: max abs diff "
                f"{diff:.3g} (max |score| {fused.abs().max().item():.4g}, limit {limit:.3g})")
            if bad or "auc" not in metrics or mhsa.launches or served.shape != fused.shape:
                raise AssertionError(f"zoo {name} serving: {metrics}, {mhsa.launches} launches")
            if not diff <= limit:
                raise AssertionError(f"zoo {name}: served scores differ from the fused "
                                     f"forward's by {diff}")
            continue

        def evaluate(m, n):
            trainer = Trainer(create_train_state(m, make_optimizer(1e-4)), cross_entropy_loss,
                              TrainerConfig())
            return trainer.evaluate(EvalBatcher(store, imp.subset(n), SERVING["hist_len"],
                                                TARGET_CELLS, split_title_len=16), "val")

        metrics = evaluate(model, ZOO_IMPRESSIONS)
        bad = [k for k, v in metrics.items() if not math.isfinite(v)]
        got = evaluate(model, NPA_CPU_IMPRESSIONS)
        want = evaluate(copy.deepcopy(model).cpu(), NPA_CPU_IMPRESSIONS)
        diff = max(abs(got[k] - want[k]) for k in want)
        worst["npa_metrics"] = diff
        log(f"zoo npa float32: the trainer's eval-step path over {ZOO_IMPRESSIONS} impressions "
            f"(val/auc {metrics.get('val/auc', float('nan')):.4f}); over the first "
            f"{NPA_CPU_IMPRESSIONS}, card vs CPU metrics max abs diff {diff:.3g} (tolerance "
            f"{METRIC_ATOL['float32']})")
        if bad or "val/auc" not in metrics or set(got) != set(want):
            raise AssertionError(f"zoo npa eval: {metrics}")
        if not diff <= METRIC_ATOL["float32"]:
            raise AssertionError(f"zoo npa: eval metrics differ, card {got} vs CPU {want}")
    return worst


def zoo_kernel_phase():
    """The kernels at the zoo's user-encoder shapes (``kernel_bench.ZOO_SHAPES``)
    and at ``BOX_SHAPES`` in float32 and bfloat16: forward and backward held
    against ``mhsa_plain`` / autograd of it and timed with the plain versions
    and SDPA; the same check must reject each planted fault of
    ``ELEMENT_FAULTS``."""
    import torch

    from newsreclib_tpu_torch.kernel_bench import (
        ZOO_SHAPES,
        check_backward,
        dtype_name,
        measure_backward,
        measure_shape,
    )
    from newsreclib_tpu_torch.ops import mhsa

    planted = element_faults()
    fwd, bwd = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dname = dtype_name(dtype)
        for u, l, d, h in ZOO_SHAPES + list(BOX_SHAPES.values()):
            rec = measure_shape(u, l, dtype, [("kernel", mhsa.fused_small_mhsa)], d=d, h=h)
            log("zoo_kernel_shape " + json.dumps(rec))
            fwd.append(rec)
            rec = measure_backward(u, l, dtype, d=d, h=h)
            log("zoo_backward_shape " + json.dumps(rec))
            bwd.append(rec)
            for fault in ELEMENT_FAULTS[dname]:
                try:
                    check_backward(u, l, dtype, d=d, h=h, **planted[fault])
                except AssertionError as e:
                    log(f"planted fault {fault} at ({u}, {l}, {d}, {h}) {dname}: caught ({e})")
                else:
                    raise AssertionError(f"the element check at ({u}, {l}, {d}, {h}) {dname} "
                                         f"does not tell the planted fault {fault} from the "
                                         "plain version")
    return fwd, bwd


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from newsreclib_tpu_torch.data.synthetic import make_serving_workload
    from newsreclib_tpu_torch.kernel_bench import EXTRA_SHAPES, card_line
    from newsreclib_tpu_torch.ops import build

    t_start = time.time()
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.time()
    build.build_all(["mhsa"])
    log(f"kernel build: {time.time() - t0:.1f} s")

    t0 = time.time()
    store, imp = make_serving_workload(np.random.default_rng(0), **SERVING)
    log(f"workload: {SERVING['corpus']} articles (titles, abstracts, categories, entities), "
        f"{len(imp)} impressions, built in {time.time() - t0:.1f} s")
    shapes = main_path_shapes(store)
    log(f"attention shapes (U, L) of the serving path: {shapes}")

    # The serving epoch runs before the kernel phase, whose many profiler
    # windows leave the process slower to launch kernels.
    launches = serving_phase(card, store, imp)
    train_launches, bwd_launches, train_step_s, train_shapes, grad_err = training_phase(
        card, store, imp)
    checked = list(shapes)
    for s in train_shapes + EXTRA_SHAPES:
        if s not in checked:
            checked.append(s)
    records = kernel_phase(checked)
    bwd_records = backward_phase(train_shapes)
    bwd_main, bwd_f32 = (next(r for r in bwd_records if r["dtype"] == name)
                         for name in ("bfloat16", "float32"))
    zoo_fwd, zoo_bwd = zoo_kernel_phase()
    # after the profiled phases: with the CLI phase before them, a profiler
    # window recorded no device time, and with the zoo phase before them six
    # windows in a row recorded fewer kernels than calls (one H100 run each)
    zoo_counts, zoo_by_model = zoo_phase(card, store, imp)
    zoo2_worst = zoo2_phase(card, store, imp)
    cli_launches, cli_bwd_launches, cli_s = cli_phase(card)

    main_shape, main_f32 = (next(r for r in records
                                 if (r["U"], r["L"], r["dtype"]) == (4096, 16, t))
                            for t in ("bfloat16", "float32"))
    kernels = [{
        "name": "fused_small_mhsa",
        "route": "cuda",
        "source": "newsreclib_tpu_torch/csrc/mhsa.cu",
        "replaces": "newsreclib_tpu/ops/mhsa.py:160",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in records),
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "f32_ms": main_f32["ms"],
        "f32_bound_ms": main_f32["bound_ms"],
        "f32_plain_ms": main_f32["plain_ms"],
        "f32_library_ms": main_f32["library_ms"],
        "train_launches": train_launches,
        "train_launches_per_step": train_launches / TRAIN_TIMED,
        "train_step_ms": train_step_s * 1e3,
        "cli_launches": cli_launches,
        "cli_wall_s": cli_s,
    }, {
        "name": "fused_small_mhsa_backward",
        "route": "cuda",
        "source": "newsreclib_tpu_torch/csrc/mhsa.cu",
        "replaces": "newsreclib_tpu/ops/mhsa.py:219 (XLA autodiff of mhsa_reference; "
                    "the TPU kernel at :160 has no backward)",
        "launches": bwd_launches,
        "launches_per_step": bwd_launches / TRAIN_TIMED,
        "cli_launches": cli_bwd_launches,
        "max_abs_err": max(grad_err, *(r["max_abs_err"] for r in bwd_records)),
        "ms": bwd_main["bwd_ms"],
        "plain_ms": bwd_main["plain_bwd_ms"],
        "bound_ms": bwd_main["bwd_bound_ms"],
        "bound_by": bwd_main["bwd_bound_by"],
        "library_ms": bwd_main["library_bwd_ms"],
        "f32_ms": bwd_f32["bwd_ms"],
        "f32_bound_ms": bwd_f32["bwd_bound_ms"],
        "f32_plain_ms": bwd_f32["plain_bwd_ms"],
        "f32_library_ms": bwd_f32["library_bwd_ms"],
        "fwd_bwd_ms": bwd_main["ms"],
        "autograd_plain_fwd_bwd_ms": bwd_main["plain_ms"],
        "library_fwd_bwd_ms": bwd_main["library_ms"],
    }]
    def zoo_rec(recs, shape, dtype):
        return next(r for r in recs if (r["U"], r["L"], r["D"], r["H"], r["dtype"])
                    == (*shape, dtype))

    wide_shape, d400_shape = (64, 50, 300, 6), (320, 50, 400, 20)
    for entry, recs, prefix in ((kernels[0], zoo_fwd, ""), (kernels[1], zoo_bwd, "bwd_")):
        r = zoo_rec(recs, d400_shape, "float32")
        entry.update({
            "zoo_launches": int(zoo_counts[0] if not prefix else zoo_counts[1]),
            "miner_launches": int(zoo_by_model["miner"][0 if not prefix else 1]),
            "d400_f32_ms": r[prefix + "ms"], "d400_f32_bound_ms": r[prefix + "bound_ms"],
            "d400_f32_plain_ms": r["plain_" + prefix + "ms"],
            "d400_f32_library_ms": r["library_" + prefix + "ms"],
        })
    for name, recs, prefix, count in (
            ("fused_small_mhsa_wide", zoo_fwd, "", zoo_counts[2]),
            ("fused_small_mhsa_wide_backward", zoo_bwd, "bwd_", zoo_counts[3])):
        main_r, f32_r = (zoo_rec(recs, wide_shape, t) for t in ("bfloat16", "float32"))
        box = {}
        for key, shape in BOX_SHAPES.items():
            for t, tag in (("bfloat16", ""), ("float32", "f32_")):
                r = zoo_rec(recs, shape, t)
                box.update({
                    f"{key}_{tag}ms": r[prefix + "ms"],
                    f"{key}_{tag}bound_ms": r[prefix + "bound_ms"],
                    f"{key}_{tag}bound_by": r[prefix + "bound_by"],
                    f"{key}_{tag}plain_ms": r["plain_" + prefix + "ms"],
                    f"{key}_{tag}library_ms": r["library_" + prefix + "ms"],
                })
            box[f"{key}_shape"] = list(shape)
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "newsreclib_tpu_torch/csrc/mhsa.cu",
            "replaces": ("newsreclib_tpu/ops/mhsa.py:160" if not prefix else
                         "newsreclib_tpu/ops/mhsa.py:219 (XLA autodiff of mhsa_reference)")
                        + " at head dims above 32 and L above 64",
            "launches": int(count),
            "max_abs_err": max(r["max_abs_err"] for r in recs if r["D"] // r["H"] > 32),
            "ms": main_r[prefix + "ms"],
            "plain_ms": main_r["plain_" + prefix + "ms"],
            "bound_ms": main_r[prefix + "bound_ms"],
            "bound_by": main_r[prefix + "bound_by"],
            "library_ms": main_r["library_" + prefix + "ms"],
            "f32_ms": f32_r[prefix + "ms"],
            "f32_bound_ms": f32_r[prefix + "bound_ms"],
            "f32_plain_ms": f32_r["plain_" + prefix + "ms"],
            "f32_library_ms": f32_r["library_" + prefix + "ms"],
            "shape": list(wide_shape),
            **box,
        })
    log("zoo models without an MHSA, largest errors: " + json.dumps(zoo2_worst))
    log(f"total {time.time() - t_start:.1f} s; kernel times at U=4096 L=16 (forward) and "
        f"U={bwd_main['U']} L={bwd_main['L']} (backward), bf16 (f32_*: float32), on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
