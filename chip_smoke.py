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
8. the FairRec phase: SentiRec, SentiDebias and MANNeR's CR module
   (``FAIR``) at their config files' widths through the zoo phase's checks
   (exact launches a step, the route check with the planted faults, the
   served epoch against the plain route); SentiDebias trains with its
   alternating generator / discriminator step (forward launches 2 x
   segments + 2, backward segments + 2) and serves its bias-free scores;
   MANNeR's attention over title and abstract side by side runs the wide
   instances at every launch.  Then MANNeR's A-modules for the category and
   the sentiment aspect, ``ASPECT_STEPS`` SupCon steps each on m-per-class
   batches (one wide launch each way a step, the plain route's losses; the
   trained embeddings no further from the plain route's than those of
   ``tolerance_attention``, keys unmasked further), and the ensemble of a
   CR module and both towers served over ``ZOO_IMPRESSIONS`` impressions
   (one wide launch a corpus chunk per module, metrics and served scores
   against the plain route's).  SentiDebias's bf16 route is logged, not
   held (``CHAOTIC_ROUTES``), and so is its bf16 served-score fault check
   (``LOOSE_SERVED_ROUTES``).  The zoo
   kernel phase of step 7 also holds and times both kernels at
   ``kernel_bench.MANNER_SHAPES`` and at the PLM head's train shapes
   (``kernel_bench.plm_statfix_shapes``: 16 heads of 48 over 768 at batch
   8) with the planted element faults;
9. the models without an MHSA, NAML, TANR, LSTUR, NPA and DKN, at their
   config files' widths on the same store and impressions (which carry
   user ids): ``ZOO_STEPS`` train steps each in float32 and bf16 compute
   with finite losses and no kernel launch; in float32 with TF32 off, the
   fused forward's scores, the loss and one Adam step's update on the card
   against the port on the CPU from the same weights and batch
   (``CARD_CPU_TOL``), where a dropped history mask must fail each check;
   the served scores of one ``CachedScorer`` epoch equal to the fused
   forward's on the same impressions (NAML, TANR, LSTUR, DKN), and NPA's
   eval-step metrics through the trainer, card against CPU;
10. the PLM phase (``plm_phase``): a tower at roberta-base's widths
   (``PLM_TOWER``: 12 layers, 768 wide, 12 heads, FFN 3,072, 514 positions
   from 2), random from seed 0 with the workload's 60,000-id vocabulary,
   written by ``save_as_hf_bert`` and as a RoBERTa checkpoint directory
   (safetensors, a ``roberta.`` prefix, heads the loader leaves out), both
   loaded back on the card identical tensor for tensor; NRMS over it (the
   model node of ``nrms_statfix_plm_supconloss``: the head's 16 heads of 48,
   SupCon) from the factory, which loads the RoBERTa directory; its main
   path, counts at 0 before it: one float32 ``CachedScorer`` epoch over the
   whole workload (seconds, peak memory), then ``PLM_STEPS``
   ``TrainBatcher`` steps at batch 8 with layers 0-7 and the embeddings
   frozen, with exact launch counts, all of the wide instances, the frozen
   tensors bit-identical after the steps and the others moved; served
   metrics against the plain attention's (``METRIC_ATOL``) and served
   scores against the plain route's (within the tolerance attention's gap,
   the planted faults beyond it); the route check on one batch of 8 with
   two title segments in float32 and bf16 at ``PLM_ROUTE_LR``
   (``PLM_ROUTE_RTOL``, the planted faults beyond it; bf16 logged, not held,
   ``CHAOTIC_ROUTES``; 3 launches a step each way, all wide);
11. drives the training CLI in-process (``newsreclib_tpu_torch.train.run``)
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
   plain attention, the same test metrics (``METRIC_ATOL``); then again
   with the PLM tower (``PLM_CLI_OVERRIDES``: random, two layers at 768, 16
   head heads, layer 0 frozen), with the same checks;
12. the same CLI and checks on the other datasets (``dataset_cli_phase``):
   Adressa from a copy of ``data/adressa_demo/one_week.tar.gz`` alone under
   ``build/smoke_adressa`` (the ETL from the raw tar; user encoder at
   L = 50, 2 epochs, ``save_recs``: the export's corpus encode and
   impression batches are in the exact launch count, and its JSON must
   cover every test impression's candidates), with the native host parser
   built (``data/fastetl.py``) and equal to the Python route on the run's
   behaviors; then xMIND (``nrms_xmindfix_zeroshot``'s data node, 2
   epochs) over a copy of the raw ``data/demo`` files laid out as
   ``MINDsmall_{train,dev}`` with ``glove_statfix.txt`` under
   ``build/smoke_xmind``, whose fixture step writes the translated news,
   and whose zero-shot test must hold translated candidates;
13. the CLI in PLM mode (``plm_mode_phase``): both kinds of
   ``write_fixture_tokenizer`` written from ``data/demo``'s texts under
   ``build/smoke_plm_mode`` (``PLM_MODE_TOKENIZERS``: a WordPiece of
   characters and ``##`` characters, a byte-level BPE of the bytes and a
   few merges, the two longest tokenisations of those texts), then for each
   ``train.run`` with ``data.use_plm`` through it at ``tokenizer_max_len``
   96 on a copy of the raw demo files, the tower random as
   ``PLM_CLI_OVERRIDES`` sets it (two layers at 768, the head's 16 heads of
   48), through ``drive_cli``'s checks (the ETL's ``news_store_plm.npz``
   written, exact launches, the restored test); the same run again with the
   plain attention, both under ``reproducible``: every train step's loss
   and the val and test losses of the two runs equal within
   ``PLM_ROUTE_RTOL`` of the largest (float32, 1e-4); the store widths and
   the (U, L) the kernel saw are printed;
14. the hyperparameter sweep (``sweep_phase``):
   ``newsreclib_tpu_torch.sweep`` over ``demo_grid`` (two learning rates)
   with phase 11's overrides (NRMS at full width, 2 epochs, the demo copy
   under ``build/smoke_demo``), run from ``build/smoke_sweep``: both
   trials have a finite value, the results JSON is written under
   ``build/smoke_sweep/outputs/torch/``, each trial writes its
   checkpoints, and the forward and backward kernel launches are exactly
   twice phase 11's;
15. MANNeR's remat (``remat_phase``): the CR module at ``manner_cr.yaml``'s
   widths, ``REMAT_STEPS`` float32 train steps at batch 64 on
   ``TrainBatcher`` batches with and without ``remat`` from the same
   weights and dropout seeds (the card's generator): losses and gradients
   within ``REMAT_RTOL`` (relative), the generator in the same state after
   every backward pass, the wide forward kernel launched exactly twice a
   news segment with remat (the forward and its recomputation) and once
   without, the backward once; the peak memory of both is printed;
16. the BERT sentiment annotator (``annotator_phase``): random two-layer
   RoBERTa (three labels) and BERT (two labels) classifiers at
   roberta-base's widths, written under ``build/smoke_annotator`` beside
   fixture tokenizers from ``data/demo`` by ``write_fixture_classifier``,
   annotate ``ANNOTATOR_TEXTS`` texts on the card and on the CPU: the same
   labels, scores within ``ANNOTATOR_ATOL``;
17. the training CLI in multi-host mode at world size 1
   (``distributed_cli_phase``): ``trainer.distributed=true
   data.global_rows=true`` on phase 11's demo copy at full NRMS width as
   rank 0 of one (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, a free
   ``MASTER_PORT``), over NCCL, every collective of the step counted
   (``parallel/collectives.py::calls``), the exact launches, and the test
   metrics within ``DIST_CLI_ATOL`` of the same run without
   ``distributed`` (both without dropout, under ``reproducible``);
18. two ranks sharing ``cuda:0`` over gloo (``two_rank_phase``; NCCL
   refuses two ranks on one device), started by the port's launcher: NRMS
   at full width data-parallel (global batch 64, 5 f32 steps), then with
   the word table row-sharded over 2 model ranks, then over a 2-layer
   768-wide tower tensor-parallel over 2 model ranks (batch 16), at lr
   ``TWO_RANK_LR``: each case's losses within ``TWO_RANK_ATOL`` of one
   rank on the same global batches, its parameters within
   ``TWO_RANK_UPDATE_RTOL`` of one rank's update, a planted fault
   (``TWO_RANK_FAULTS``: the gradient all-reduce, or the sharded lookup's,
   dropped on every rank) beyond it, each rank's launches exact (2 a
   step, forward and backward).  One card cannot show a true multi-GPU
   run;
19. the long instances (L above 128, head dims beyond the box; phase 19a,
   ``long_kernel_phase``, runs with the profiled phases after step 7's
   kernel phase, 19b, ``long_phase``, last): both kernels at
   ``kernel_bench.LONG_SHAPES`` (NRMS's user encoder at history 200 in a
   train step and a served batch, the PLM head at 256 tokens, head dims
   100, 150 and 1,024) in float32 and bf16 against ``mhsa_plain``,
   ``mhsa_backward`` and autograd of the plain version, timed at
   ``LONG_TIMED`` with the plain versions and SDPA, and a bf16 shape whose
   qkv passes 2^31 values (``LONG_HUGE``) on its first and last sequences;
   then NRMS at ``data.max_history_len=200``: a cached-serving epoch of the
   serving workload drawn with 5 to 200 clicks (exact launches, the user
   encoder's in the long instances, metrics against the plain attention's),
   ``LONG_TRAIN_STEPS`` ``TrainBatcher`` steps at batch 64 in float32 and
   bf16, kernel route against plain route, step 4's route check on a
   planted-signal batch at history 200 with the planted faults, and the
   demo CLI at history 200 through phase 11's checks;
20. prints one ``{"kernels": [...]}`` line (the wide instances' own
   entries, with their times at ``BOX_SHAPES`` under ``plm_*`` and
   ``hd100_*`` and at ``MANNER_SHAPES`` under ``manner_*``,
   ``manner_tail_*`` and ``manner_a_*``; the D = 400 float32 times under
   ``d400_f32_*``; MINER's launches under ``miner_launches``, the FairRec
   models' under ``fair_launches``, the A-modules' and the ensemble's under
   ``aspect_ensemble_launches``, the PLM phase's under ``plm_launches``;
   the PLM head's own entries ``fused_small_mhsa_plm_head`` /
   ``_backward``: its main path's launches, the times at its largest train
   shape, the other shapes under ``u<U>_l<L>_*``, the served epoch and the
   PLM CLI run; phase 12's launches under ``adressa_cli_launches`` and
   ``xmind_cli_launches``; phase 13's under ``plm_mode_cli_launches`` by
   tokenizer, with the widths under ``plm_mode_widths``; phase 14's under
   ``sweep_launches``, phase 15's under ``remat_launches`` (with and
   without remat) in the wide entries, phase 16's under
   ``annotator_launches``, phase 17's under ``distributed_cli_launches``
   with its collectives, phase 18's per rank under
   ``two_rank_launches_per_rank``; the long instances' own entries
   ``fused_small_mhsa_long`` / ``_backward``: phase 19b's launches, the
   times at the train user encoder's (64, 200, 300, 15) and, under
   ``u<U>_l<L>_d<D>_*``, at the other ``LONG_TIMED`` shapes) and, last,
   ``{"ok": true, ...}``.

Every comparison of training trajectories (kernel route against plain
route) runs under deterministic algorithms (``reproducible``).

Exits non-zero, printing no result, when no card is present or any phase
fails.  Writes nothing but the kernel build, the host parser's build, the
PLM checkpoints, the fixture tokenizers and classifiers, the CLI phases'
data copies and runs and the sweep's under ``build/``; phase 18's ranks are
stopped when the phase ends or fails.

    python3 chip_smoke.py --route-spread [MODEL ...]

builds the kernels, then prints how far each route's losses move from run
to run with and without deterministic algorithms (``route_spread``), and
nothing else.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
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
# Every trajectory comparison runs under deterministic algorithms
# (``reproducible``).  Without them the gradients that CUDA accumulates
# atomically (embedding and index backward) change the summation order from
# run to run, and a bf16 route differs from itself: on an H100
# (``python3 chip_smoke.py --route-spread``: three runs of each route with
# and without them, PERF.md §6) the kernel route of MANNeR CR in bf16
# differed from itself by up to 0.0054 and from the plain route by 0.0017
# to 0.0055; in one full run of this script it read 0.0102, more than
# ROUTE_ATOL.  Under deterministic algorithms each route of NRMS and of
# every zoo model repeats bit for bit in both types, and MANNeR CR's bf16
# kernel route is 0.00177 from the plain one.
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
# Phase 12: the CLI on Adressa (the demo tar alone, copied under build/; with
# the user encoder at L = 50, titles split at 16, and save_recs) and on xMIND
# (nrms_xmindfix_zeroshot's data node over a copy of the raw demo files)
ADRESSA_DATA, ADRESSA_OUT = (os.path.join(ROOT, "build", d) for d in ("smoke_adressa",
                                                                      "smoke_adressa_cli"))
XMIND_DATA, XMIND_OUT = (os.path.join(ROOT, "build", d) for d in ("smoke_xmind",
                                                                  "smoke_xmind_cli"))
ADRESSA_OVERRIDES = ["data=adressa_demo", "model=nrms", "trainer.max_epochs=2",
                     "data.max_history_len=50", f"data.data_dir={ADRESSA_DATA}",
                     f"output_dir={ADRESSA_OUT}", "save_recs=true"]
XMIND_OVERRIDES = ["experiment=nrms_xmindfix_zeroshot", "trainer.max_epochs=2",
                   f"data.data_dir={XMIND_DATA}",
                   f"data.word_embeddings_fpath={os.path.join(XMIND_DATA, 'glove_statfix.txt')}",
                   f"output_dir={XMIND_OUT}"]
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
# keys unmasked by 0.24 to 0.27 and the tolerance attention by 0.25 to 0.30
# (before ``reproducible``; under it the kernel route is 0.091 from the
# plain one and keys unmasked 0.41).  There the route is logged with the
# tolerance attention's gap and not held; MINER's kernel
# route in bf16 is held by the served-score check (the unmasked fault
# beyond), by its float32 route check and by the element checks of the same
# kernel instances (NRMS's).  SentiDebias in bf16 compute: its adversarial
# game (G maximises D's loss) at lr 1e-3, 100 times its configured rate,
# swings between 2 and 10; on an H100 (this script) the kernel route differed
# from the plain one by 1.08 over the 20 steps, and on the CPU, where both
# routes are plain PyTorch and differ only in the order of the attention
# gradient's sums, by 0.94 (keys unmasked: 5.4 and 4.2).  Its float32 route
# is held (8.6e-6 on the H100), its bf16 kernel route by the served scores.
# NRMS with the PLM tower in bf16 compute (the PLM phase): its SupCon loss
# over bf16 news vectors of a random 12-layer tower is in the hundreds and
# saturated, so bf16 rounding moves each step's loss by units and the
# trajectory by as much as the planted faults do: on an H100 (this script,
# lr 1e-5, 20 steps) the kernel route ended 0.755 of the largest loss away
# from the plain one, keys unmasked 0.911 and logits 10% too large 0.723,
# while in float32 the kernel was 1.85e-5 away and the faults 0.890 and
# 0.526.  Its bf16 kernel route is held by the served scores against the
# plain route's (``plm_phase``), its served metrics and the element checks
# at its shapes (zoo kernel phase).
CHAOTIC_ROUTES = {("miner", "bfloat16"), ("senti_debias", "bfloat16"),
                  ("nrms_plm", "bfloat16")}
# Served-score fault checks that cannot be held: SentiDebias in bf16.  After
# its bf16 route its served scores are at most 0.014 in magnitude, and the
# bf16 tolerance attention (2e-2 + 1e-2 |x| at every attention output) moves
# them by 0.0151, more than keys unmasked do (0.0115; one H100 run), so that
# yardstick cannot tell the fault.  The kernel's own gap (6.3e-5) is still
# held within it; keys unmasked are caught by SentiDebias's float32 route
# and served checks and by SentiRec's bf16 checks, which run the same kernel
# instances at the same shapes.
LOOSE_SERVED_ROUTES = {("senti_debias", "bfloat16")}
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
# The FairRec phase: SentiRec, SentiDebias and MANNeR's CR module through the
# zoo phase's checks (SentiDebias with its alternating G / D step: forward
# launches 2 x segments + 2, backward segments + 2 a step, and served
# through its bias-free scores, one user attention a batch), then MANNeR's
# A-modules (category and sentiment) for ASPECT_STEPS SupCon steps on
# m-per-class batches and the ensemble of the CR module and both towers
# served over ZOO_IMPRESSIONS impressions.  MANNeR's attention runs at L =
# title + abstract width (66 and 80 on the workload's batches), 15 heads of
# 20: the wide instances, every launch.
FAIR = ("sentirec", "senti_debias", "manner_cr")
WIDE_MODELS = ("mins", "manner_cr")  # models whose train steps launch the wide instances
ALL_WIDE_MODELS = ("manner_cr",)  # ... at every launch
SERVED_USER_ATTENTIONS = {"senti_debias": 1}  # served: the bias-free user alone
ASPECTS, ASPECT_STEPS = ("category", "sentiment"), 4
ENSEMBLE_WEIGHTS = {"category": 0.1, "sentiment": 0.1}  # manner_ensemble_statfix's
# The PLM phase: NRMS with the PLM tower at roberta-base's widths (12 layers,
# 768 wide, 12 heads, FFN 3,072, 514 positions from 2, LayerNorm eps 1e-5, one
# token type), random from a seed, its vocabulary the workload's 60,000 ids as
# the statfix PLM configs size theirs; the head's MHSA and the user encoder,
# 16 heads of 48, run the wide instances.  The checkpoints go under
# build/smoke_plm.  Train steps at the PLM configs' batch of 8 with layers
# 0-7 and the embeddings frozen (nrms_mindsmall_plm_celoss_bertsent.yaml).
PLM_DIR = os.path.join(ROOT, "build", "smoke_plm")
PLM_TOWER = dict(vocab_size=SERVING["vocab_size"], hidden_dim=768, num_layers=12, num_heads=12,
                 intermediate_dim=3072, max_position=514, type_vocab_size=1, dropout=0.1,
                 layer_norm_eps=1e-5, pad_token_id=1, position_offset=2)
PLM_BATCH, PLM_STEPS = 8, 4
PLM_FROZEN = list(range(8))
# The PLM route check: SupCon (the config's loss) on one TrainBatcher batch
# of 8 at lr 1e-5, a tenth of the config's, with a tolerance relative to the
# plain route's largest loss.  A random tower's SupCon loss is in the
# hundreds (temperature 0.1 over 768-wide vectors) and saturated: at lr 1e-4
# the trajectory is chaotic, and the kernel and plain routes, both right
# (served metrics 3e-8 apart), drifted 0.66% apart over 20 steps; at lr
# 1e-5, 1.85e-5 apart, keys unmasked 0.89 and logits 10% too large 0.53
# (this script, one H100 run each).  ROUTE_ATOL's absolute bounds were set
# on NRMS's CE of at most ln 5.
PLM_ROUTE_LR = 1e-5
PLM_ROUTE_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the training CLI on the demo copy with a random two-layer tower at the
# statfix PLM configs' width, layer 0 and the embeddings frozen
PLM_CLI_OVERRIDES = ["model.use_plm=true", "model.plm_model=__random_init__",
                     "model.plm_num_layers=2", "model.embed_dim=768", "model.num_heads=16",
                     "model.frozen_layers=[0]"]
# Phase 13: the CLI in PLM mode through both fixture tokenizers (vocabulary
# sizes: characters only, bytes and merges up to 300), at the PLM configs'
# tokenizer_max_len, the tower as in PLM_CLI_OVERRIDES
# Phase 17: the CLI through trainer.distributed at world size 1 over NCCL,
# against the same run without it (both without dropout and under
# deterministic algorithms: the same arithmetic, only the dedup table's
# layout differs, host-split against on-device).  Phase 18: two ranks that
# share cuda:0 over gloo (NCCL refuses two ranks on one device) against one
# rank on the same global batches: NRMS data-parallel, NRMS with the word
# table row-sharded over 2 model ranks, and a 2-layer 768-wide tower
# tensor-parallel over 2 model ranks; float32 at TWO_RANK_LR, losses within
# TWO_RANK_ATOL (the same sums in another order), the tower's relative to
# the loss (PLM_ROUTE_RTOL's rule: its random 768-wide tower's losses run to
# 10-16, and sums split over two ranks moved step 5's by 1.2e-5 of it on an
# H100); the parameters' distance from one rank's within TWO_RANK_UPDATE_RTOL
# of one rank's update (in norm: NRMS's losses stay within 1e-4 of ln 5
# whatever the collectives do, the parameters do not), and the planted
# faults of TWO_RANK_FAULTS must exceed it.
DIST_OUT, DIST_REF_OUT = (os.path.join(ROOT, "build", d) for d in ("smoke_dist_cli",
                                                                   "smoke_dist_ref"))
DIST_CLI_ATOL = 1e-4
TWO_RANK_BATCH, TWO_RANK_TP_BATCH, TWO_RANK_STEPS = 64, 16, 5
TWO_RANK_TOWER = dict(vocab_size=SERVING["vocab_size"], hidden_dim=768, num_layers=2,
                      num_heads=12, intermediate_dim=3072, max_position=64, dropout=0.0)
TWO_RANK_ATOL = 1e-4
# lr 1e-3 drove the random tower's losses to 50 and its two-rank parameters
# 1.3e-2 of the update off one rank's on an H100 (the same sums in another
# order, amplified); at 1e-4 the planted faults still move the parameters
TWO_RANK_LR, TWO_RANK_UPDATE_RTOL = 1e-4, 1e-2
TWO_RANK_FAULTS = {"dp": "no_gradient_all_reduce", "rows": "no_lookup_all_reduce"}
TWO_RANK_REF = os.path.join(ROOT, "build", "smoke_two_rank")
PLM_MODE_DIR = os.path.join(ROOT, "build", "smoke_plm_mode")
PLM_MODE_TOKENIZERS = {"wordpiece": 0, "bpe": 300}
PLM_MODE_MAX_LEN = 96
# Phase 14: demo_grid over the CLI phase's NRMS run (2 trials of 2 epochs) on
# the CLI phase's data copy, from this directory (the results JSON lands
# under it, at outputs/torch/sweep_results.json)
SWEEP_DIR = os.path.join(ROOT, "build", "smoke_sweep")
# Phase 15: MANNeR's CR module at manner_cr.yaml's widths, float32 train steps
# at batch 64 with and without remat; losses and gradients relative
REMAT_STEPS, REMAT_RTOL = 3, 1e-5
# Phase 16: random two-layer classifiers at roberta-base's widths beside
# fixture tokenizers from data/demo, annotating ANNOTATOR_TEXTS texts on the
# card and on the CPU
ANNOTATOR_DIR = os.path.join(ROOT, "build", "smoke_annotator")
ANNOTATOR_TEXTS, ANNOTATOR_ATOL, ANNOTATOR_MAX_LEN = 256, 1e-4, 64
ANNOTATOR_CLASSIFIERS = {"bpe": 3, "wordpiece": 2}  # tokenizer kind -> labels
# Phase 19, the long instances (L above 128, head dims beyond the box):
# NRMS's history cap raised to 200 (``data.max_history_len=200``), the
# serving workload drawn with 5 to 200 clicks; ``kernel_bench.LONG_SHAPES``
# checked, the main path's timed (``LONG_TIMED``); a bf16 shape whose qkv
# holds more than 2^31 values, checked on its first and last
# ``LONG_HUGE_CHECKED`` sequences against the plain version of those slices.
# The other shapes' times: ``kernel_bench --shapes long`` (PERF.md, §6).
LONG_HISTORY = 200
LONG_SERVING = dict(SERVING, hist_len=LONG_HISTORY)
LONG_TIMED = [(64, 200, 300, 15), (512, 200, 300, 15)]
LONG_HUGE, LONG_HUGE_CHECKED = (2048, 512, 768, 16), 8
LONG_TRAIN_STEPS = 5
# The planted faults of the route check at history 200: keys unmasked.  The
# 10% logit fault stays within ROUTE_ATOL there (the planted loss falls to 0
# either way); it is left to the element checks of phase 19a
# (``ELEMENT_FAULTS``).
LONG_ROUTE_FAULTS = ("unmasked",)
LONG_CLI_OVERRIDES = [f"data.max_history_len={LONG_HISTORY}"]


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


def global_row_shapes(store, imp):
    """The (U, L) the global-row route gives the kernel on the serving
    workload at batch ``TWO_RANK_BATCH`` (phase 18's data-parallel and
    row-sharded cases): the densified table (``global_u_bucket`` rows at the
    full title width) and the users of one rank of two."""
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.profile_train import DATA

    data = {k: v for k, v in DATA.items() if k != "split_title_len"}
    batcher = TrainBatcher(store, imp, batch_size=TWO_RANK_BATCH, global_rows=True, **data)
    return [(batcher.global_u_bucket(), store.title.shape[1]),
            (TWO_RANK_BATCH // 2, DATA["max_history_len"])]


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


def planted_batch(hist_len=SERVING["hist_len"]):
    """The planted-signal batch of the route checks, on the card: batch 64,
    history ``hist_len`` (50), 5 candidates over 1,024 articles with every
    field."""
    import numpy as np

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch

    cfg = SyntheticConfig(vocab_size=SERVING["vocab_size"])
    return to_device(make_batch(np.random.default_rng(0), batch_size=TRAIN_BATCH,
                                hist_len=hist_len, num_candidates=5,
                                unique_news=1024, cfg=cfg, planted_signal=True), "cuda")


@contextlib.contextmanager
def reproducible():
    """Deterministic algorithms (``torch.use_deterministic_algorithms``,
    warnings only) for a comparison of training trajectories: the same
    route then repeats bit for bit, so two routes differ only by what their
    attention computes (ROUTE_ATOL's comment)."""
    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def route_losses(batches, cdtype, lr, attention, model="nrms"):
    """Per-step losses of a fresh ``model`` cell (``profile_train``'s init,
    Adam, the config file's loss, dropout seed 0; SentiDebias's alternating
    step and its G loss) over ``batches`` with every MHSA's attention set to
    ``attention`` (``set_attention``), and the trained model (SentiDebias:
    its generator), under ``reproducible``."""
    import torch

    from newsreclib_tpu_torch.profile_train import cell_state_and_step

    with reproducible():
        st, stp = cell_state_and_step(model, "cuda", cdtype, lr)
        set_attention(st.model, attention)
        return torch.stack([stp(st, b)[1]["loss"] for b in batches]).cpu(), st.model


def route_spread(models) -> None:
    """``--route-spread [MODEL ...]``: for each model (default NRMS and the
    zoo's) and compute type, the plain and the kernel route three times each
    and keys unmasked once, without and with ``reproducible``.  Prints one
    JSON line each: the largest per-step loss gap of each route's runs from
    its first, of every kernel run from every plain run, and of the fault
    from the first plain run."""
    import torch

    from newsreclib_tpu_torch.profile_train import cell_state_and_step

    planted = [planted_batch()] * ROUTE_STEPS

    def run(model, cdtype, attention, det):
        if det:
            return route_losses(planted, cdtype, PLANTED_LR, attention, model)[0]
        st, stp = cell_state_and_step(model, "cuda", cdtype, PLANTED_LR)
        set_attention(st.model, attention)
        return torch.stack([stp(st, b)[1]["loss"] for b in planted]).cpu()

    def gap(a, b):
        return (a - b).abs().max().item()

    for model in models or ("nrms",) + ZOO + FAIR:
        for dname, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
            for det in (False, True):
                plain = [run(model, cdtype, "plain", det) for _ in range(3)]
                kernel = [run(model, cdtype, None, det) for _ in range(3)]
                unmasked = run(model, cdtype, unmasked_attention, det)
                print(json.dumps(dict(
                    model=model, dtype=dname, reproducible=det,
                    plain_self=max(gap(plain[0], x) for x in plain[1:]),
                    kernel_self=max(gap(kernel[0], x) for x in kernel[1:]),
                    kernel_vs_plain=[gap(k, p) for k in kernel for p in plain],
                    unmasked=gap(unmasked, plain[0]))), flush=True)


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


def cli_phase(card: str, extra=()):
    """The training CLI on the demo data at full NRMS width (module doc,
    phase 11), with the overrides ``extra`` after ``CLI_OVERRIDES``
    (``PLM_CLI_OVERRIDES``: the PLM tower).  Returns the forward and
    backward kernel launches of the run and the phase's wall time in
    seconds."""
    for d in (CLI_DATA, CLI_OUT):
        shutil.rmtree(d, ignore_errors=True)
    demo = os.path.join(ROOT, "data", "demo")
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        os.makedirs(os.path.join(CLI_DATA, split))
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            shutil.copy(os.path.join(demo, split, name), os.path.join(CLI_DATA, split, name))
    shutil.copy(os.path.join(demo, "glove_demo.txt"), CLI_DATA)
    caches = [os.path.join(CLI_DATA, "MINDdemo_train", f) for f in
              ("news_store.npz", "parsed_news.tsv", "train_impressions.npz",
               "transformed_word_embeddings.npy")]
    launches, bwd_launches, wall_s, _, _ = drive_cli(card, CLI_OVERRIDES + list(extra),
                                                     CLI_OUT, caches)
    return launches, bwd_launches, wall_s


def drive_cli(card: str, overrides, out_dir: str, caches):
    """``newsreclib_tpu_torch.train.run`` in-process with ``overrides``, the
    counts set to 0 just before it and read just after, then the checks of
    the CLI phases (module doc, phases 11 and 12): the ETL's ``caches``
    written, both checkpoints, the exact forward and backward launches (the
    train steps', every evaluation's and, with ``save_recs``, the export's:
    its corpus encode of the untrimmed test store and its impression
    batches), finite ``val/*`` and ``test/*`` metrics, and the best
    checkpoint restored into a new trainer giving the same ``test/auc`` and,
    with the plain attention, the same test metrics.  Returns the forward
    and backward launches, the run's wall time in seconds, its metrics and
    the new trainer's ``Run``."""
    import torch

    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.config.compose import compose
    from newsreclib_tpu_torch.models.components.attention import use_plain_attention
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import attention_launches
    from newsreclib_tpu_torch import serving

    cfg = compose(overrides=overrides)
    m = cfg["model"]
    log(f"CLI: NRMS D={m['embed_dim']}, {m['num_heads']} heads, query {m['query_dim']}, "
        + (f"PLM tower of {m['plm_num_layers']} layers, frozen {m['frozen_layers']}, "
           if m.get("use_plm") else
           f"GloVe {cfg['data']['word_embed_dim']}-d, " if cfg["data"].get("word_embeddings_fpath")
           else "random word embeddings, ")
        + f"precision {cfg['trainer'].get('precision') or 'float32'}, "
        f"{cfg['trainer']['max_epochs']} epochs, data {cfg['data']['name']}"
        + (", save_recs" if cfg.get("save_recs") else ""))

    torch.cuda.synchronize()
    mhsa.launches = mhsa.bwd_launches = 0
    t0 = time.perf_counter()
    metrics = train.run(cfg)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches, bwd_launches = mhsa.launches, mhsa.bwd_launches

    missing = [c for c in caches if not os.path.exists(c)]
    if missing:
        raise AssertionError(f"the ETL did not run from the raw files: {missing} missing")
    ckpts = [os.path.join(out_dir, "checkpoints", f"{w}.pt") for w in ("best", "last")]
    if not all(os.path.exists(c) for c in ckpts):
        raise AssertionError(f"checkpoints missing: {ckpts}")
    with open(os.path.join(out_dir, "checkpoints", "last.json")) as f:
        epochs = json.load(f)["epoch"] + 1

    # the launches the run's batches give, counted on the host
    quiet = compose(overrides=list(overrides) + ["loggers=[]"])
    r = train.build_run(quiet)
    train_expected = sum(attention_launches(b) for e in range(epochs)
                         for b in r.train_batcher.epoch(e))
    dc = cfg["data"]
    eval_launches = [serving_launches(b.store, b.imp, dc["max_history_len"],
                                      dc["eval_target_cells"])
                     for b in (r.val_batcher, r.test_batcher)]
    export_launches = 0
    if cfg.get("save_recs"):
        export_launches = serving_launches(r.data.news_store("test"), r.data.impressions("test"),
                                           dc["max_history_len"], serving.TARGET_CELLS)
    expected = train_expected + epochs * eval_launches[0] + eval_launches[1] + export_launches
    log(f"CLI run: {wall_s:.2f} s wall on {card}; {epochs} epochs of {len(r.train_batcher)} "
        f"steps; fused_small_mhsa launches {launches} ({expected} expected: {train_expected} in "
        f"train steps, {eval_launches[0]} a validation, {eval_launches[1]} the test, "
        f"{export_launches} the export), its backward {bwd_launches} ({train_expected} "
        f"expected)")
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
    return launches, bwd_launches, wall_s, metrics, r


@contextlib.contextmanager
def python_parser():
    """The host ETL's pure-Python route for the duration of the block."""
    from newsreclib_tpu_torch.data import fastetl

    saved = fastetl._lib, fastetl._lib_tried
    fastetl._lib, fastetl._lib_tried = None, True
    try:
        yield
    finally:
        fastetl._lib, fastetl._lib_tried = saved


def dataset_cli_phase(card: str) -> dict:
    """Phase 12 (module doc): the training CLI on Adressa, from a copy of
    ``data/adressa_demo/one_week.tar.gz`` alone (with ``save_recs``), and on
    xMIND (``nrms_xmindfix_zeroshot``'s data node) over a copy of the raw
    ``data/demo`` files laid out as ``write_xmind_statfix`` expects them, at
    full NRMS width, each through ``drive_cli``'s checks; the native host
    parser built and equal to the Python route on the Adressa run's
    behaviors; the exported recommendations covering every test
    impression's candidates.  Returns each run's forward and backward
    launches, export launches and wall seconds."""
    from newsreclib_tpu_torch.data import fastetl

    out = {}
    for d in (ADRESSA_DATA, ADRESSA_OUT, XMIND_DATA, XMIND_OUT):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(ADRESSA_DATA)
    shutil.copy(os.path.join(ROOT, "data", "adressa_demo", "one_week.tar.gz"), ADRESSA_DATA)
    adressa_root = os.path.join(ADRESSA_DATA, "Adressa_one_week")
    fwd, bwd, wall_s, metrics, r = drive_cli(
        card, ADRESSA_OVERRIDES, ADRESSA_OUT,
        [os.path.join(adressa_root, f) for f in ("news.tsv", "nid2index.tsv", "word2index.tsv",
                                                 "behaviors_42.tsv", "news_store.npz")])
    lib = fastetl.get_lib()
    if lib is None:
        raise AssertionError("the native host parser (csrc/fastetl.cpp) did not build")
    for split in ("train", "val", "test"):
        native = r.data.impressions(split)
        with python_parser():
            python = r.data.impressions(split)
        for f in ("hist_flat", "hist_offsets", "cand_flat", "cand_offsets", "labels_flat",
                  "user_idx"):
            if not (getattr(native, f) == getattr(python, f)).all():
                raise AssertionError(f"native and Python parsers differ: {split} {f}")
    with open(os.path.join(ADRESSA_OUT, "recommendations.json")) as f:
        recs = json.load(f)
    store, imp = r.data.news_store("test"), r.data.impressions("test")
    row2nid = {v: k for k, v in store.nid2row.items()}
    uncovered = [i for i in range(len(imp)) if not all(
        row2nid[c] in recs.get(f"U{imp.user_ids[i]}", {}) for c in imp.cands(i)[0])]
    if uncovered or not all(math.isfinite(v) for u in recs.values() for v in u.values()):
        raise AssertionError(f"the export misses the candidates of {len(uncovered)} of "
                             f"{len(imp)} test impressions, or holds a non-finite score")
    log(f"Adressa CLI: native parser {fastetl.library_path().name}, equal to the Python route "
        f"on train/val/test; recommendations of {len(recs)} users cover all {len(imp)} test "
        f"impressions; test/auc {metrics['test/auc']:.4f}")
    out["adressa"] = dict(launches=fwd, bwd_launches=bwd, wall_s=wall_s)

    for split in ("train", "dev"):
        os.makedirs(os.path.join(XMIND_DATA, f"MINDsmall_{split}"))
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            shutil.copy(os.path.join(ROOT, "data", "demo", f"MINDdemo_{split}", name),
                        os.path.join(XMIND_DATA, f"MINDsmall_{split}", name))
    shutil.copy(os.path.join(ROOT, "data", "demo", "glove_demo.txt"),
                os.path.join(XMIND_DATA, "glove_statfix.txt"))
    fin = os.path.join(XMIND_DATA, "xMIND", "fin")
    fwd, bwd, wall_s, metrics, r = drive_cli(
        card, XMIND_OVERRIDES, XMIND_OUT,
        [os.path.join(fin, f) for f in ("train/news.tsv", "aligned_embeddings.txt",
                                        "word2index.tsv", "transformed_word_embeddings.npy")])
    n_base = len(r.data.mind.news_store("test").nid2row)
    test_imp = r.data.impressions("test")
    translated = float((test_imp.cand_flat > n_base).mean())
    log(f"xMIND CLI: vocabulary {r.data.vocab_size()} (base {r.data.mind.vocab_size()}), "
        f"{translated:.1%} of the test candidates translated; test/auc {metrics['test/auc']:.4f}")
    if translated < 0.5:
        raise AssertionError(f"zero-shot test: only {translated:.1%} of candidates translated")
    out["xmind"] = dict(launches=fwd, bwd_launches=bwd, wall_s=wall_s)
    return out


@contextlib.contextmanager
def kernel_shapes(seen: dict):
    """Count the ``(U, L)`` of every forward kernel call into ``seen`` for
    the duration of the block (the kernel's own launch count is untouched)."""
    from newsreclib_tpu_torch.ops import mhsa

    forward = mhsa._forward

    def recording(qkv, mask, num_heads):
        key = tuple(qkv.shape[:2])
        seen[key] = seen.get(key, 0) + 1
        return forward(qkv, mask, num_heads)

    mhsa._forward = recording
    try:
        yield seen
    finally:
        mhsa._forward = forward


@contextlib.contextmanager
def plain_attention_models():
    """The training CLI builds its model with the plain attention for the
    duration of the block."""
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.models.components.attention import use_plain_attention

    build = train.build_model
    train.build_model = lambda *a, **k: use_plain_attention(build(*a, **k))
    try:
        yield
    finally:
        train.build_model = build


def logged_losses(run_dir: str) -> list:
    """Every train, val and test loss in a run's ``metrics.csv``, in order."""
    import csv

    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return [float(row[k]) for row in csv.DictReader(f)
                for k in ("train/loss", "val/loss", "test/loss") if row.get(k)]


def plm_mode_phase(card: str) -> dict:
    """Phase 13 (module doc): the CLI in PLM mode through each fixture
    tokenizer.  Returns, by tokenizer, the run's forward and backward
    launches, its wall seconds, the store's widths and the kernel's
    ``(U, L)`` counts."""
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.config.compose import compose
    from newsreclib_tpu_torch.data.plm_tokenizer import load_tokenizer
    from newsreclib_tpu_torch.data.testing import write_fixture_tokenizer

    shutil.rmtree(PLM_MODE_DIR, ignore_errors=True)
    demo = os.path.join(ROOT, "data", "demo")
    texts = []
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        with open(os.path.join(demo, split, "news.tsv"), encoding="utf-8") as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                texts += fields[3:5]
    out = {}
    for kind, vocab_size in PLM_MODE_TOKENIZERS.items():
        tok_dir = write_fixture_tokenizer(os.path.join(PLM_MODE_DIR, kind), texts, kind,
                                          vocab_size)
        vocab = load_tokenizer(tok_dir).max_id() + 1
        data = os.path.join(PLM_MODE_DIR, f"data_{kind}")
        for split in ("MINDdemo_train", "MINDdemo_dev"):
            os.makedirs(os.path.join(data, split))
            for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
                shutil.copy(os.path.join(demo, split, name), os.path.join(data, split, name))
        shutil.copy(os.path.join(demo, "glove_demo.txt"), data)
        run_dir = os.path.join(PLM_MODE_DIR, f"run_{kind}")
        overrides = CLI_OVERRIDES + PLM_CLI_OVERRIDES + [
            f"data.data_dir={data}", f"data.word_embeddings_fpath={data}/glove_demo.txt",
            f"output_dir={run_dir}", "data.use_plm=true", f"data.plm_tokenizer={tok_dir}",
            f"data.tokenizer_max_len={PLM_MODE_MAX_LEN}", f"model.plm_vocab_size={vocab}",
            "trainer.log_every_n_steps=1"]
        caches = [os.path.join(data, s, "news_store_plm.npz")
                  for s in ("MINDdemo_train", "MINDdemo_dev")]
        with reproducible(), kernel_shapes({}) as seen:
            fwd, bwd, wall_s, metrics, r = drive_cli(card, overrides, run_dir, caches)
        with reproducible(), plain_attention_models():
            train.run(compose(overrides=overrides + [f"output_dir={run_dir}_plain"]))
        kernel, plain = (logged_losses(d) for d in (run_dir, run_dir + "_plain"))
        diff = (max(abs(a - b) for a, b in zip(kernel, plain)) / max(map(abs, plain))
                if len(kernel) == len(plain) else math.inf)
        store = r.data.news_store("train")
        widths = {"title": int(store.title.shape[1]), "abstract": int(store.abstract.shape[1]),
                  "title_trimmed": int(store.trim_titles(margin=0).title.shape[1])}
        log(f"PLM mode ({kind}, vocabulary {vocab}): store widths {widths}; the kernel saw "
            f"(U, L) {json.dumps({f'{u}x{l}': n for (u, l), n in sorted(seen.items())})}; "
            f"kernel vs plain attention route, {len(kernel)} logged train, val and test "
            f"losses: max abs diff over the largest plain loss {diff:.3g} (tolerance "
            f"{PLM_ROUTE_RTOL['float32']}); train/loss {metrics['train/loss']:.6f}, test/auc "
            f"{metrics['test/auc']:.4f}")
        if not diff <= PLM_ROUTE_RTOL["float32"]:
            raise AssertionError(f"PLM mode ({kind}): the kernel route's losses {kernel} "
                                 f"differ from the plain route's {plain}")
        if widths["title"] != PLM_MODE_MAX_LEN or widths["abstract"] != PLM_MODE_MAX_LEN:
            raise AssertionError(f"PLM mode ({kind}): store widths {widths}, not "
                                 f"{PLM_MODE_MAX_LEN}")
        out[kind] = dict(launches=fwd, bwd_launches=bwd, wall_s=wall_s, widths=widths,
                         seen_l=sorted({l for _, l in seen}))
    return out


def demo_texts():
    """The titles and abstracts of ``data/demo``'s news files."""
    texts = []
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        with open(os.path.join(ROOT, "data", "demo", split, "news.tsv"), encoding="utf-8") as f:
            for line in f:
                texts += line.rstrip("\n").split("\t")[3:5]
    return texts


def sweep_phase(card: str, cli_fwd: int, cli_bwd: int) -> dict:
    """Phase 14 (module doc): ``newsreclib_tpu_torch.sweep`` over
    ``demo_grid`` with the CLI phase's overrides (its data copy, NRMS at
    full width, 2 epochs), run from ``SWEEP_DIR``, the counts set to 0 just
    before it and read just after: both trials have a finite value, the
    results JSON is written under ``SWEEP_DIR``, and the forward and
    backward launches are twice the CLI run's (``cli_fwd``, ``cli_bwd``).
    Returns the launches, the wall seconds and the results."""
    import torch

    from newsreclib_tpu_torch import sweep
    from newsreclib_tpu_torch.ops import mhsa

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    os.makedirs(SWEEP_DIR)
    overrides = [o for o in CLI_OVERRIDES if not o.startswith("output_dir=")]
    overrides.append(f"output_dir={os.path.join(SWEEP_DIR, 'run')}")
    cwd = os.getcwd()
    os.chdir(SWEEP_DIR)
    try:
        torch.cuda.synchronize()
        mhsa.launches = mhsa.bwd_launches = 0
        t0 = time.perf_counter()
        results = sweep.main(["hparams_search=demo_grid", *overrides])
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        fwd, bwd = mhsa.launches, mhsa.bwd_launches
    finally:
        os.chdir(cwd)
    path = os.path.join(SWEEP_DIR, "outputs", "torch", "sweep_results.json")
    with open(path) as f:
        written = json.load(f)
    values = [t["value"] for t in written["trials"]]
    log(f"sweep demo_grid: {len(values)} trials in {wall_s:.2f} s wall on {card}; "
        f"{written['metric']} {values}, best {written['best']}; results in "
        f"{os.path.relpath(path, ROOT)}; fused_small_mhsa launches {fwd} ({2 * cli_fwd} "
        f"expected: twice the CLI run's), its backward {bwd} ({2 * cli_bwd} expected)")
    if written != json.loads(json.dumps(results)) or len(values) != 2:
        raise AssertionError(f"the sweep's results file differs from its return: {written}")
    if not all(v is not None and math.isfinite(v) for v in values):
        raise AssertionError(f"a sweep trial has no value: {written['trials']}")
    if fwd != 2 * cli_fwd or bwd != 2 * cli_bwd:
        raise AssertionError(f"{fwd} forward and {bwd} backward kernel launches in the sweep "
                             f"({2 * cli_fwd} and {2 * cli_bwd} expected)")
    for t in range(2):
        if not os.path.exists(os.path.join(SWEEP_DIR, "run", f"trial_{t}", "checkpoints",
                                           "best.pt")):
            raise AssertionError(f"trial {t} wrote no checkpoint")
    return dict(launches=fwd, bwd_launches=bwd, wall_s=wall_s, values=values)


def remat_run(store, imp, remat: bool) -> dict:
    """``REMAT_STEPS`` float32 train steps of MANNeR's CR module (the
    ``profile_train`` cell at batch 64, seed 0, Adam lr 1e-4) with or
    without ``remat``, under ``reproducible``: per step the loss, every
    gradient (on the host) and the dropout generator's state after the
    backward pass; the forward, backward and wide launches, the news
    segments and the peak of allocated memory over the steps."""
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import DATA, LEARNING_RATE, build_cell_model, \
        cell_config
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer

    loss_fn = factory.build_loss(cell_config("manner_cr"))
    batches = [to_device(b, "cuda") for _, b in zip(
        range(REMAT_STEPS), TrainBatcher(store, imp, batch_size=TRAIN_BATCH, **DATA).epoch(0))]
    state = create_train_state(build_cell_model("manner_cr", "cuda", remat),
                               make_optimizer(LEARNING_RATE), dropout_seed=0)
    out = dict(losses=[], grads=[], generators=[])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mhsa.launches = mhsa.bwd_launches = mhsa.wide_launches = mhsa.wide_bwd_launches = 0
    with reproducible():
        for b in batches:
            g = state.dropout_generator()
            scores, _ = state.model(b, deterministic=False, generator=g)
            loss = loss_fn(scores.float(), b.labels, b.cand_mask, b.impression_valid)
            loss.backward()
            out["losses"].append(loss.item())
            out["grads"].append({n: p.grad.detach().cpu() for n, p in
                                 state.model.named_parameters() if p.grad is not None})
            out["generators"].append(g.get_state())
            state.apply_gradients()
    torch.cuda.synchronize()
    out.update(peak_mb=torch.cuda.max_memory_allocated() / 2**20, fwd=mhsa.launches,
               bwd=mhsa.bwd_launches, wide=mhsa.wide_launches, wide_bwd=mhsa.wide_bwd_launches,
               segments=sum(1 + (b.news2 is not None) for b in batches))
    return out


def remat_phase(card: str, store, imp) -> dict:
    """Phase 15 (module doc): MANNeR-CR with and without remat from the
    same weights and dropout seeds: losses and gradients within
    ``REMAT_RTOL`` of the largest of their tensor, the dropout generator in
    the same state after every backward pass, the wide forward kernel
    launched exactly twice a news segment with remat and once without (every
    launch wide), the backward once either way; prints the largest
    differences and the peak memory of both.  Returns the launches and peaks
    of both runs."""
    plain, remat = remat_run(store, imp, False), remat_run(store, imp, True)
    loss_diff = max(abs(a - b) / abs(b) for a, b in zip(remat["losses"], plain["losses"]))
    grad_diff = max((a[k] - b[k]).abs().max().item() / max(b[k].abs().max().item(), 1e-30)
                    for a, b in zip(remat["grads"], plain["grads"]) for k in b)
    same_generators = all(a.equal(b) for a, b in zip(remat["generators"], plain["generators"]))
    log(f"MANNeR-CR remat ({REMAT_STEPS} float32 steps at batch {TRAIN_BATCH}, "
        f"{plain['segments']} news segments) on {card}: losses {remat['losses']} against "
        f"{plain['losses']} without, largest relative difference {loss_diff:.3g}; gradients "
        f"{grad_diff:.3g} of their tensor's largest (tolerance {REMAT_RTOL}); dropout "
        f"generator states equal: {same_generators}; wide forward launches {remat['wide']} "
        f"(without: {plain['wide']}), backward {remat['wide_bwd']} (without: "
        f"{plain['wide_bwd']}); peak allocated {remat['peak_mb']:.1f} MB with remat, "
        f"{plain['peak_mb']:.1f} MB without")
    if not (loss_diff <= REMAT_RTOL and grad_diff <= REMAT_RTOL and same_generators):
        raise AssertionError("MANNeR-CR with remat differs from the model without")
    if set(remat["grads"][0]) != set(plain["grads"][0]):
        raise AssertionError("remat changed which parameters get a gradient")
    segments = plain["segments"]
    for run, per_segment in ((plain, 1), (remat, 2)):
        if not (run["wide"] == run["fwd"] == per_segment * segments
                and run["wide_bwd"] == run["bwd"] == segments):
            raise AssertionError(f"{run['fwd']} forward ({run['wide']} wide) and {run['bwd']} "
                                 f"backward ({run['wide_bwd']} wide) launches over {segments} "
                                 f"segments; {per_segment} a segment expected forward, 1 back")
    return {name: dict(launches=run["wide"], bwd_launches=run["wide_bwd"],
                       peak_mb=run["peak_mb"]) for name, run in (("no_remat", plain),
                                                                  ("remat", remat))} | dict(
        segments=segments, loss_rel_diff=loss_diff, grad_rel_diff=grad_diff)


def annotator_phase(card: str) -> dict:
    """Phase 16 (module doc): a random two-layer RoBERTa classifier (three
    labels, byte-level BPE) and a BERT one (two labels, WordPiece) at
    roberta-base's widths written under ``ANNOTATOR_DIR`` by
    ``write_fixture_classifier``; ``BERTSentimentAnnotator`` annotates
    ``ANNOTATOR_TEXTS`` texts of ``data/demo`` (an empty one and one beyond
    ``ANNOTATOR_MAX_LEN`` tokens among them) on the card and with
    ``device="cpu"``: the labels equal and the scores within
    ``ANNOTATOR_ATOL``.  The tower's attention is plain torch: no kernel
    launch.  Returns the seconds of both devices and the launches by
    classifier."""
    import torch

    from newsreclib_tpu_torch.data.sentiment import BERTSentimentAnnotator
    from newsreclib_tpu_torch.data.testing import write_fixture_classifier
    from newsreclib_tpu_torch.ops import mhsa

    shutil.rmtree(ANNOTATOR_DIR, ignore_errors=True)
    corpus = demo_texts()
    texts = corpus[:ANNOTATOR_TEXTS - 2] + ["", " ".join(corpus[:60])]
    out = {}
    for kind, labels in ANNOTATOR_CLASSIFIERS.items():
        d = write_fixture_classifier(os.path.join(ANNOTATOR_DIR, kind), corpus, kind,
                                     num_labels=labels, hidden_dim=768, num_layers=2,
                                     num_heads=12, intermediate_dim=3072,
                                     max_len=ANNOTATOR_MAX_LEN)
        results, seconds = {}, {}
        for device in ("cuda", "cpu"):
            annotator = BERTSentimentAnnotator(model_name=d, device=device)
            annotator.annotate_many(texts[:8])  # warm-up
            if device == "cuda":
                torch.cuda.synchronize()
                mhsa.launches = 0
            t0 = time.perf_counter()
            results[device] = annotator.annotate_many(texts)
            seconds[device] = time.perf_counter() - t0
            if device == "cuda":
                launches = mhsa.launches
        card_r, cpu_r = results["cuda"], results["cpu"]
        same = sum(a[0] == b[0] for a, b in zip(card_r, cpu_r))
        err = max(abs(a[1] - b[1]) for a, b in zip(card_r, cpu_r))
        counts = {c: sum(r[0] == c for r in card_r) for c in ("negative", "neutral", "positive")}
        log(f"annotator ({kind}, {labels} labels, 2 layers of 768): {len(texts)} texts in "
            f"{seconds['cuda']:.3f} s on {card}, {seconds['cpu']:.3f} s on the CPU; labels "
            f"equal {same}/{len(texts)} ({counts}), scores max abs diff {err:.3g} (tolerance "
            f"{ANNOTATOR_ATOL}); fused_small_mhsa launches {launches}")
        if same != len(texts) or not err <= ANNOTATOR_ATOL or len(card_r) != len(texts):
            raise AssertionError(f"annotator ({kind}): the card's labels or scores differ from "
                                 "the CPU's")
        out[kind] = dict(card_s=seconds["cuda"], cpu_s=seconds["cpu"], launches=launches,
                         max_abs_err=err)
    return out


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
    users = SERVED_USER_ATTENTIONS.get(name, USER_ATTENTIONS.get(name, 0))
    return TEXT_ATTENTIONS[name] * chunks + users * sum(
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


def zoo_phase(card: str, store, imp, models=ZOO):
    """MINS, CenNewsRec, CAUM and MINER (``models``: the FairRec phase runs
    SentiRec, SentiDebias and MANNeR's CR module through it), each at its
    config file's widths, in float32 and bf16 compute (module doc, step 7;
    the FairRec models, step 8):

    * ZOO_STEPS train steps (Adam lr 1e-4, dropout 0.2, the config's loss;
      SentiDebias's alternating step) on ``TrainBatcher`` batches (batch 64,
      K = 4, history 50, split at 16): the kernel route must launch the
      forward and the backward kernel exactly as often as the step's
      attention calls (``profile_train.attention_launches``), and the wide
      instances for exactly the models of ``WIDE_MODELS``, every launch of
      MANNeR's;
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
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import DATA, attention_launches, cell_state_and_step
    from newsreclib_tpu_torch.serving import CachedScorer

    sub = imp.subset(ZOO_IMPRESSIONS)
    planted = [planted_batch()] * ROUTE_STEPS
    counts = np.zeros(4, dtype=np.int64)  # forward, backward, wide forward, wide backward
    by_model = {name: np.zeros(4, dtype=np.int64) for name in models}
    for name in models:
        for dname, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
            state, step = cell_state_and_step(name, "cuda", cdtype, 1e-4)
            batches = TrainBatcher(store, imp, batch_size=TRAIN_BATCH, **DATA).epoch(0)
            calls, bwd_calls, out = 0, 0, []
            torch.cuda.synchronize()
            mhsa.launches = mhsa.bwd_launches = 0
            mhsa.wide_launches = mhsa.wide_bwd_launches = 0
            t0 = time.perf_counter()
            for _ in range(ZOO_STEPS):
                b = next(batches)
                calls += attention_launches(b, name)
                bwd_calls += attention_launches(b, name, backward=True)
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
                f"{got[1]} backward ({calls} / {bwd_calls} attention calls; {got[2]} / "
                f"{got[3]} wide); losses {[round(x, 5) for x in out.tolist()]}")
            if got[0] != calls or got[1] != bwd_calls:
                raise AssertionError(f"zoo {name} {dname}: {got[0]} forward and {got[1]} "
                                     f"backward kernel launches ({calls} and {bwd_calls} "
                                     "expected)")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"zoo {name} {dname} train losses not finite: {out}")
            if (got[2] > 0) != (name in WIDE_MODELS) or (
                    name in ALL_WIDE_MODELS and tuple(got[2:]) != tuple(got[:2])):
                raise AssertionError(f"zoo {name}: {got[2]} / {got[3]} wide launches")
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
            spread = (f"; not held (CHAOTIC_ROUTES): the tolerance attention "
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
                if launches != want or (route == "kernel" and name in ALL_WIDE_MODELS
                                        and mhsa.wide_launches != launches):
                    raise AssertionError(f"zoo {name} {dname} {route} serving epoch: {launches}"
                                         f" kernel launches, {mhsa.wide_launches} wide ({want}"
                                         " expected)")
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
            loose = (name, dname) in LOOSE_SERVED_ROUTES
            log(f"zoo {name} {dname}: served metrics over {ZOO_IMPRESSIONS} impressions "
                f"(auc {got['auc']:.4f}), {served_launches} kernel launches; kernel vs plain "
                f"attention max abs diff {diff:.3g} (tolerance {METRIC_ATOL[dname]}); "
                f"{want_s.numel()} served scores (max |plain| {want_s.abs().max().item():.4g}), "
                f"max abs diff from the plain route's: {json.dumps(gaps)}, over the tolerance "
                f"attention's {limit:.4g}: {json.dumps(ratio)} (kernel within 1, faults "
                f"{list(ZOO_FAULTS[dname])} beyond{'; not held (LOOSE_SERVED_ROUTES)' * loose})")
            if bad or set(got) != set(want) or diff > METRIC_ATOL[dname]:
                raise AssertionError(f"zoo {name} {dname} served metrics differ: {got} vs {want}")
            if not bool(torch.isfinite(scores["kernel"]).all()) or not ratio["kernel"] <= 1:
                raise AssertionError(f"zoo {name} {dname}: served scores differ from the "
                                     f"plain route's: {ratio}")
            missed = [f for f in ZOO_FAULTS[dname] if not ratio[f] > 1 and not loose]
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
    at its config file's widths (module doc, step 9):

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


def aspect_phase(card: str, store, imp):
    """MANNeR's A-modules and ensemble (module doc, step 8):

    * for each aspect of ``ASPECTS``, an A-module at ``manner_a.yaml``'s
      widths trained ``ASPECT_STEPS`` SupCon steps (Adam lr 1e-4, dropout
      0.2, float32) on ``MPerClassNewsBatcher`` batches of the store (64
      articles, 8 a class; title and abstract side by side, L = 80): one
      forward and one backward launch a step, both wide; the same steps on
      the plain attention give the same losses (``ROUTE_ATOL``); the trained
      embeddings of the first batch differ from the plain route's by no
      more than those trained with ``tolerance_attention``, and with keys
      unmasked by more (the SupCon loss of a fresh tower barely moves in a
      few steps, so the losses cannot tell that fault);
    * the ensemble of a CR module at ``manner_cr.yaml``'s widths and both
      towers (``ENSEMBLE_WEIGHTS``) serves one ``CachedScorer`` epoch over
      the first ZOO_IMPRESSIONS impressions: one wide launch a corpus chunk
      for each of the three modules, metrics within ``METRIC_ATOL`` of the
      plain route's, served scores no further from the plain route's than
      those of ``tolerance_attention``, the unmasked fault's further.

    Returns the forward, backward, wide forward and wide backward launches
    of the A-module steps and of the served epoch, and the ensemble's
    metrics."""
    import numpy as np
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.news_batching import MPerClassNewsBatcher
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.models.fair_rec import evaluate_ensemble
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import build_cell_model, cell_config, cell_info
    from newsreclib_tpu_torch.training.aspect import make_aspect_train_step
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer

    cfg = cell_config("manner_a")
    counts = np.zeros(4, dtype=np.int64)
    towers = {}
    for aspect in ASPECTS:
        batcher = MPerClassNewsBatcher(store, aspect, batch_size=cfg["news_batch_size"],
                                       m_per_class=cfg["m_per_class"], seed=0)
        batches = [to_device(b, "cuda") for _, b in zip(range(ASPECT_STEPS), batcher.epoch(0))]
        losses, embs = {}, {}
        for route, attention in (("kernel", None), ("plain", "plain"),
                                 ("tolerance", tolerance_attention("float32")),
                                 ("unmasked", unmasked_attention)):
            model = set_attention(factory.build_manner_a(cfg, cell_info(), device="cuda",
                                                         seed=0), attention)
            state = create_train_state(model, make_optimizer(1e-4), dropout_seed=0)
            step = make_aspect_train_step(cfg.get("temperature") or 0.1)
            mhsa.launches = mhsa.bwd_launches = mhsa.wide_launches = mhsa.wide_bwd_launches = 0
            with reproducible():
                losses[route] = torch.stack([step(state, b)[1]["loss"] for b in batches]).cpu()
            got = np.array([mhsa.launches, mhsa.bwd_launches, mhsa.wide_launches,
                            mhsa.wide_bwd_launches])
            want = [ASPECT_STEPS] * 4 if route == "kernel" else [0] * 4
            if list(got) != want:
                raise AssertionError(f"A-module {aspect} {route}: launches {got.tolist()} "
                                     f"({want} expected)")
            with torch.no_grad():
                embs[route] = model.eval()(batches[0].news).float()
            if route == "kernel":
                counts += got
                towers[aspect] = model
        diff = (losses["kernel"] - losses["plain"]).abs().max().item()
        gaps = {r: (embs[r] - embs["plain"]).abs().max().item()
                for r in ("kernel", "tolerance", "unmasked")}
        limit = gaps.pop("tolerance")
        ratio = {r: g / limit for r, g in gaps.items()}
        log(f"A-module {aspect}: {ASPECT_STEPS} SupCon steps on m-per-class batches "
            f"({batches[0].news.title.shape[0]} articles, L = "
            f"{batches[0].news.title.shape[1] + batches[0].news.abstract.shape[1]}) on {card}, "
            f"losses {[round(x, 5) for x in losses['kernel'].tolist()]}; kernel vs plain max "
            f"abs diff {diff:.3g} (tolerance {ROUTE_ATOL['float32']}); trained embeddings' "
            f"max abs diff from the plain route's over the tolerance attention's "
            f"{limit:.4g}: {json.dumps(ratio)} (kernel within 1, unmasked beyond)")
        if not bool(torch.isfinite(losses["kernel"]).all()) or diff > ROUTE_ATOL["float32"]:
            raise AssertionError(f"A-module {aspect}: {losses}")
        if not ratio["kernel"] <= 1 or not ratio["unmasked"] > 1:
            raise AssertionError(f"A-module {aspect}: trained embeddings against the plain "
                                 f"route's: {ratio}")

    sub = imp.subset(ZOO_IMPRESSIONS)
    cr = build_cell_model("manner_cr", "cuda").eval()
    modules = {a: (towers[a].eval(), ENSEMBLE_WEIGHTS[a]) for a in ASPECTS}
    mhsa.launches = mhsa.wide_launches = 0
    metrics = evaluate_ensemble(cr, modules, store, sub, max_history_len=SERVING["hist_len"],
                                target_cells=TARGET_CELLS, device="cuda")
    launches, wide = mhsa.launches, mhsa.wide_launches
    probe = 1 + len(ASPECTS)  # evaluate_ensemble's one-row width probes
    want = zoo_serving_launches("manner_cr", store, sub) * (1 + len(ASPECTS)) + probe
    plain = evaluate_ensemble(plain_copy(cr), {a: (plain_copy(m), w) for a, (m, w)
                                               in modules.items()},
                              store, sub, max_history_len=SERVING["hist_len"],
                              target_cells=TARGET_CELLS, device="cuda")
    diff = max(abs(metrics[k] - plain[k]) for k in plain)
    log(f"MANNeR ensemble (CR + {len(ASPECTS)} A-modules, weights {ENSEMBLE_WEIGHTS}): served "
        f"metrics over {ZOO_IMPRESSIONS} impressions (auc {metrics['auc']:.4f}), {launches} "
        f"kernel launches ({want} expected, {wide} wide); kernel vs plain attention max abs "
        f"diff {diff:.3g} (tolerance {METRIC_ATOL['float32']})")
    if launches != want or wide != launches:
        raise AssertionError(f"MANNeR ensemble: {launches} launches, {wide} wide ({want})")
    if set(metrics) != set(plain) or diff > METRIC_ATOL["float32"] or not all(
            math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"MANNeR ensemble metrics differ: {metrics} vs {plain}")
    counts[0] += launches
    counts[2] += wide

    from newsreclib_tpu_torch.models.fair_rec import MANNeREnsemble

    ens = MANNeREnsemble(cr, ASPECTS, [towers[a] for a in ASPECTS],
                         [ENSEMBLE_WEIGHTS[a] for a in ASPECTS], cr_dim=D, aspect_dims=(D, D))
    routes = (("kernel", None), ("plain", "plain"), ("tolerance", tolerance_attention("float32")),
              ("unmasked", unmasked_attention))
    scores = {r: served_scores(ens, store, sub, None, fn) for r, fn in routes}
    want_s = scores.pop("plain")
    gaps = {r: (x - want_s).abs().max().item() for r, x in scores.items()}
    limit = gaps.pop("tolerance")
    ratio = {r: g / limit for r, g in gaps.items()}
    log(f"MANNeR ensemble: {want_s.numel()} served scores, max abs diff from the plain "
        f"route's over the tolerance attention's {limit:.4g}: {json.dumps(ratio)} (kernel "
        "within 1, unmasked beyond)")
    if not ratio["kernel"] <= 1 or not ratio["unmasked"] > 1:
        raise AssertionError(f"MANNeR ensemble served scores: {ratio}")
    return counts, metrics


def write_safetensors(path: str, tensors) -> None:
    """``tensors`` as a ``.safetensors`` file of the format's documented
    layout (8-byte little-endian header length, the JSON header of dtypes,
    shapes and offsets, the little-endian buffer), as Hugging Face's
    ``save_pretrained`` writes by default; the port reads it with
    ``plm.read_safetensors``."""
    import struct

    import torch

    names = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16"}
    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().to("cpu").contiguous()
        data = t.view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    text = json.dumps(header).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for data in blobs:
            f.write(data)


def plm_checkpoints():
    """The PLM phase's tower (``PLM_TOWER``, random from seed 0) written as a
    ``BertModel`` directory by ``save_as_hf_bert`` and as a roberta-base
    layout directory (``RobertaForMaskedLM``: the ``roberta.`` prefix, a
    pooler and an LM head the loader leaves out, ``model.safetensors``),
    both loaded back with ``load_hf_torch_weights`` and held on the card
    against the tower, tensor for tensor, exactly.  Returns the RoBERTa
    directory and the tower's state on the card."""
    import torch

    from newsreclib_tpu_torch.models.components import plm

    shutil.rmtree(PLM_DIR, ignore_errors=True)
    os.makedirs(PLM_DIR)
    tower = plm.TransformerEncoder(**PLM_TOWER, generator=torch.Generator().manual_seed(0))
    state = tower.state_dict()
    bert_dir = plm.save_as_hf_bert(state, PLM_TOWER, os.path.join(PLM_DIR, "bert"))
    roberta_dir = os.path.join(PLM_DIR, "roberta")
    os.makedirs(roberta_dir)
    with open(os.path.join(roberta_dir, "config.json"), "w") as f:
        json.dump({"architectures": ["RobertaForMaskedLM"], "model_type": "roberta",
                   "vocab_size": PLM_TOWER["vocab_size"], "hidden_size": PLM_TOWER["hidden_dim"],
                   "num_hidden_layers": PLM_TOWER["num_layers"],
                   "num_attention_heads": PLM_TOWER["num_heads"],
                   "intermediate_size": PLM_TOWER["intermediate_dim"],
                   "max_position_embeddings": PLM_TOWER["max_position"],
                   "type_vocab_size": PLM_TOWER["type_vocab_size"],
                   "hidden_dropout_prob": PLM_TOWER["dropout"],
                   "layer_norm_eps": PLM_TOWER["layer_norm_eps"],
                   "pad_token_id": PLM_TOWER["pad_token_id"]}, f)
    hidden = PLM_TOWER["hidden_dim"]
    heads = {"roberta.pooler.dense.weight": torch.ones(hidden, hidden),
             "lm_head.dense.weight": torch.ones(hidden, hidden),
             "lm_head.bias": torch.ones(PLM_TOWER["vocab_size"])}
    write_safetensors(os.path.join(roberta_dir, "model.safetensors"),
                      {**{"roberta." + theirs: state[ours] for ours, theirs in
                          plm.hf_names(PLM_TOWER["num_layers"]).items()}, **heads})
    card_state = {k: v.cuda() for k, v in state.items()}
    for d, offset in ((bert_dir, 0), (roberta_dir, PLM_TOWER["position_offset"])):
        loaded, kw = plm.load_hf_torch_weights(d)
        same = set(loaded) == set(card_state) and all(
            torch.equal(loaded[k].cuda(), v) for k, v in card_state.items())
        want_kw = {k: v for k, v in PLM_TOWER.items() if k not in ("position_offset",
                                                                   "pad_token_id")}
        log(f"PLM weights round trip through {os.path.basename(d)}/ "
            f"({len(loaded)} tensors): {'identical' if same else 'DIFFERENT'} on the card; "
            f"position offset {kw['position_offset']}")
        if not same or kw["position_offset"] != offset or any(
                kw[k] != v for k, v in want_kw.items()):
            raise AssertionError(f"the PLM checkpoint in {d} does not load back: {kw}")
    return roberta_dir, card_state


def plm_state_and_step(base, cfg, cdtype, lr, frozen=None):
    """``(state, train_step)`` of a copy of ``base`` with Adam at ``lr``
    (``frozen_layers`` ``frozen`` through the training CLI's
    ``build_optimizer``) and ``cfg``'s loss."""
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.training.state import create_train_state
    from newsreclib_tpu_torch.training.steps import make_train_step

    model = copy.deepcopy(base)
    mc = dict(cfg, optimizer={"lr": lr}, frozen_layers=frozen)
    opt = train.build_optimizer({"model": mc, "trainer": {}}, 1, model)
    return (create_train_state(model, opt, dropout_seed=0),
            make_train_step(factory.build_loss(cfg), cdtype))


def plm_phase(card: str, store, imp):
    """NRMS with the PLM tower at roberta-base's widths (module doc, step 10):

    * ``plm_checkpoints``: the weights round trip through both layouts;
    * the main path, with every count at 0 before it and read after it: one
      ``CachedScorer`` epoch over the whole workload in float32 (the
      training CLI's evaluation) after a warm-up one, then ``PLM_STEPS``
      ``TrainBatcher`` steps at batch 8 (``profile_train.PLM_DATA``) with
      ``PLM_FROZEN`` layers and the embeddings frozen; launches exact (one
      per corpus chunk and per impression batch served, one per news segment
      and one for the user encoder a step, each way), every one a wide
      instance's; the frozen tensors bit-identical after the steps, every
      other tensor moved (but the key biases, whose gradient is float32
      noise);
    * served metrics over the first ``COMPARE_IMPRESSIONS`` impressions
      against the plain attention's, float32 and bf16 (``METRIC_ATOL``), and
      the served scores no further from the plain route's than those of
      ``tolerance_attention``, the faults of ``ROUTE_FAULTS`` further;
    * the route check on one ``TrainBatcher`` batch of 8 with both title
      segments, taken ``ROUTE_STEPS`` times at ``PLM_ROUTE_LR`` with the
      kernels, the plain attention and the planted faults of
      ``ROUTE_FAULTS``, float32 and bf16: 3 forward and 3 backward launches
      a step (two title segments and the user encoder), all wide; the
      per-step losses of the kernel route within ``PLM_ROUTE_RTOL`` of the
      plain route's largest, the faults' beyond it (bf16: logged with the
      routes' own spread, not held: ``CHAOTIC_ROUTES``).

    Returns the main path's forward, backward, wide forward and wide backward
    launches, the served epoch's seconds and peak MB, and the head's
    attention shapes (U, L) of the train steps."""
    import numpy as np
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models import factory
    from newsreclib_tpu_torch.models.components.plm import plm_freeze_labels
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import (
        PLM_CELL,
        PLM_DATA,
        attention_launches,
        cell_config,
        cell_info,
    )
    from newsreclib_tpu_torch.serving import CachedScorer

    t0 = time.perf_counter()
    checkpoint, tower_state = plm_checkpoints()
    # the model node of nrms_statfix_plm_supconloss with the checkpoint's tower
    cfg = dict(cell_config(PLM_CELL), plm_model=checkpoint)
    model = factory.build_model(cfg, cell_info(), device="cuda").eval()
    loaded = model.text_encoder_module.encoder.state_dict()
    if not all(torch.equal(loaded[k], v) for k, v in tower_state.items()):
        raise AssertionError("the factory did not load the checkpoint's tower")
    log(f"PLM: NRMS over a {PLM_TOWER['num_layers']}-layer tower {PLM_TOWER['hidden_dim']} wide "
        f"({PLM_TOWER['num_heads']} heads, FFN {PLM_TOWER['intermediate_dim']}, positions from "
        f"{PLM_TOWER['position_offset']}), head {cfg['num_heads']} heads, query "
        f"{cfg['query_dim']}, loss {cfg['loss']}; checkpoints written and loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    # the main path: a served epoch, then train steps with frozen layers
    scorer = CachedScorer(model, device="cuda")
    scorer.evaluate(store, imp, **EVAL)  # warm-up: builds the device caches
    state, step = plm_state_and_step(model, cfg, None, 1e-4, PLM_FROZEN)
    batches = [b for _, b in zip(range(PLM_STEPS), TrainBatcher(
        store, imp, batch_size=PLM_BATCH, **PLM_DATA).epoch(0))]
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mhsa.launches = mhsa.bwd_launches = mhsa.wide_launches = mhsa.wide_bwd_launches = 0
    t0 = time.perf_counter()
    metrics = scorer.evaluate(store, imp, **EVAL)
    epoch_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    served = mhsa.launches
    t0 = time.perf_counter()
    losses = torch.stack([step(state, to_device(b, "cuda"))[1]["loss"] for b in batches]).cpu()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / PLM_STEPS * 1e3
    got = np.array([mhsa.launches, mhsa.bwd_launches, mhsa.wide_launches,
                    mhsa.wide_bwd_launches])
    steps_fwd = sum(attention_launches(b, PLM_CELL) for b in batches)
    steps_bwd = sum(attention_launches(b, PLM_CELL, backward=True) for b in batches)
    want = np.array([serving_launches(store, imp) + steps_fwd, steps_bwd] * 2)
    shapes = sorted({tuple(seg.title.shape) for b in batches for seg in (b.news, b.news2)
                     if seg is not None}, reverse=True)
    log(f"PLM served epoch (float32): {epoch_s:.4f} s for {len(imp)} impressions -> "
        f"{len(imp) / epoch_s:.1f} impressions/s on {card}; peak {peak_mb:.0f} MB; "
        f"{served} launches; metrics {json.dumps(metrics, sort_keys=True)}")
    log(f"PLM train steps (float32, batch {PLM_BATCH}, layers {PLM_FROZEN} and the embeddings "
        f"frozen): {step_ms:.2f} ms a step on {card}; news segments {shapes}; losses "
        f"{[round(x, 4) for x in losses.tolist()]}; main path launches forward / backward / "
        f"wide forward / wide backward {got.tolist()} ({want.tolist()} expected)")
    if not np.array_equal(got, want):
        raise AssertionError(f"PLM main path launches {got.tolist()} ({want.tolist()} expected)")
    bad = [k for k, v in metrics.items() if not math.isfinite(v)]
    if bad or len(metrics) < 10 or not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"PLM metrics or losses not finite: {metrics}, {losses}")
    labels = plm_freeze_labels(before, PLM_FROZEN, freeze_embeddings=True)
    after = state.model.state_dict()
    frozen = [k for k, v in labels.items() if v == "freeze"]
    changed = [k for k in frozen if not torch.equal(after[k], before[k])]
    still = [k for k, v in labels.items() if v == "train" and not k.endswith(".k.bias")
             and torch.equal(after[k], before[k])]
    log(f"PLM freezing: {len(frozen)} frozen tensors, {len(changed)} changed; "
        f"{len(labels) - len(frozen)} trained, {len(still)} of them unmoved")
    layers = set(PLM_FROZEN) & set(range(PLM_TOWER["num_layers"]))
    if len(frozen) != 16 * len(layers) + 5 or changed or still:
        raise AssertionError(f"PLM freezing: changed {changed}, unmoved {still}")
    del state, before, after

    sub = imp.subset(COMPARE_IMPRESSIONS)
    for name, m in (("float32", model), ("bfloat16", copy.deepcopy(model).to(torch.bfloat16))):
        got_m = CachedScorer(m, device="cuda").evaluate(store, sub, **EVAL)
        want_m = CachedScorer(plain_copy(m), device="cuda").evaluate(store, sub, **EVAL)
        diff = max(abs(got_m[k] - want_m[k]) for k in want_m)
        log(f"PLM served metrics, kernel vs plain attention, first {COMPARE_IMPRESSIONS} "
            f"impressions, {name}: max abs diff {diff:.3g} (tolerance {METRIC_ATOL[name]})")
        if set(got_m) != set(want_m) or diff > METRIC_ATOL[name]:
            raise AssertionError(f"PLM served metrics differ ({name}): {got_m} vs {want_m}")
        del m
        # served scores: the kernel within the tolerance attention's gap from
        # the plain route, the planted faults of ROUTE_FAULTS beyond it
        cdtype = None if name == "float32" else name
        routes = (("kernel", None), ("plain", "plain"),
                  ("tolerance", tolerance_attention(name)), *FAULTS.items())
        scores = {r: served_scores(model, store, sub, cdtype, fn) for r, fn in routes}
        want_s = scores.pop("plain")
        gaps = {r: (v - want_s).abs().max().item() for r, v in scores.items()}
        limit = gaps.pop("tolerance")
        ratio = {r: g / limit for r, g in gaps.items()}
        log(f"PLM served scores, {name}: {want_s.numel()} (max |plain| "
            f"{want_s.abs().max().item():.4g}), max abs diff from the plain route's "
            f"{json.dumps(gaps)}, over the tolerance attention's {limit:.4g}: "
            f"{json.dumps(ratio)} (kernel within 1, faults {list(ROUTE_FAULTS[name])} beyond)")
        missed = [f for f in ROUTE_FAULTS[name] if not ratio[f] > 1]
        if not bool(torch.isfinite(scores["kernel"]).all()) or not ratio["kernel"] <= 1 or missed:
            raise AssertionError(f"PLM served scores ({name}): {ratio}")
        del scores

    fixed = next(b for b in TrainBatcher(store, imp, batch_size=PLM_BATCH, **PLM_DATA).epoch(1)
                 if b.news2 is not None)
    route = [to_device(fixed, "cuda")] * ROUTE_STEPS
    lr = PLM_ROUTE_LR
    for name, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
        def run(attention):
            with reproducible():
                st, stp = plm_state_and_step(model, cfg, cdtype, lr)
                set_attention(st.model, attention)
                return torch.stack([stp(st, b)[1]["loss"] for b in route]).cpu()

        mhsa.launches = mhsa.bwd_launches = mhsa.wide_launches = mhsa.wide_bwd_launches = 0
        kernel = run(None)
        counts = [mhsa.launches, mhsa.bwd_launches, mhsa.wide_launches, mhsa.wide_bwd_launches]
        plain = run("plain")
        scale = plain.abs().max().item()

        def gap(losses):
            return (losses - plain).abs().max().item() / scale

        diff = gap(kernel)
        faults = {f: gap(run(fn)) for f, fn in FAULTS.items()}
        chaotic = (PLM_CELL, name) in CHAOTIC_ROUTES
        spread = (f"; not held (CHAOTIC_ROUTES): the tolerance attention "
                  f"{gap(run(tolerance_attention(name))):.3g}") if chaotic else ""
        log(f"PLM train losses over {ROUTE_STEPS} steps on one batch of {PLM_BATCH} at lr "
            f"{lr}, kernel vs plain attention, {name}: max abs diff over the largest plain "
            f"loss {diff:.3g} (tolerance {PLM_ROUTE_RTOL[name]}{spread}); planted faults vs "
            f"plain: {json.dumps(faults)}; kernel {kernel[0].item():.5f} -> "
            f"{kernel[-1].item():.5f}; kernel launches {counts} ({3 * ROUTE_STEPS} each way "
            "expected, all wide)")
        if counts != [3 * ROUTE_STEPS] * 4:
            raise AssertionError(f"PLM route launches {counts}")
        if not bool(torch.isfinite(kernel).all()) or (not chaotic
                                                      and diff > PLM_ROUTE_RTOL[name]):
            raise AssertionError(f"PLM train losses differ ({name}): {kernel} vs {plain}")
        missed = [f for f in ROUTE_FAULTS[name]
                  if not chaotic and not faults[f] > PLM_ROUTE_RTOL[name]]
        if missed:
            raise AssertionError(f"the PLM route check ({name}) does not tell the planted "
                                 f"faults {missed} from the plain attention: {faults}")
    return got, epoch_s, peak_mb, shapes


def zoo_kernel_phase():
    """The kernels at the zoo's user-encoder shapes (``kernel_bench.ZOO_SHAPES``),
    at ``BOX_SHAPES``, ``MANNER_SHAPES`` and the PLM head's train shapes
    (``kernel_bench.plm_statfix_shapes``) in float32 and bfloat16: forward and backward held
    against ``mhsa_plain`` / autograd of it and timed with the plain versions
    and SDPA; the same check must reject each planted fault of
    ``ELEMENT_FAULTS``."""
    import torch

    from newsreclib_tpu_torch.kernel_bench import (
        MANNER_SHAPES,
        ZOO_SHAPES,
        check_backward,
        dtype_name,
        measure_backward,
        measure_shape,
        plm_statfix_shapes,
    )
    from newsreclib_tpu_torch.ops import mhsa

    planted = element_faults()
    fwd, bwd = [], []
    shapes = ZOO_SHAPES + list(BOX_SHAPES.values()) + MANNER_SHAPES + plm_statfix_shapes()
    for dtype in (torch.float32, torch.bfloat16):
        dname = dtype_name(dtype)
        for u, l, d, h in shapes:
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


def distributed_cli_phase(card: str) -> dict:
    """Phase 17 (module doc): the training CLI with ``trainer.distributed=true
    data.global_rows=true`` as rank 0 of a world of one (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and a free ``MASTER_PORT`` set), on phase
    11's demo copy at full NRMS width, against the same run without
    ``distributed``.  Checks: the backend is NCCL; every collective of the
    multi-host step ran as often as the steps give; the forward and backward
    kernel launches are exact; the test metrics agree within
    ``DIST_CLI_ATOL``.  Returns the launches, the collectives, the steps and
    both runs' wall times and steps a second."""
    import torch

    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.config.compose import compose
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.parallel import collectives
    from newsreclib_tpu_torch.parallel.launch import free_port
    from newsreclib_tpu_torch.profile_train import attention_launches

    base = CLI_OVERRIDES[:-1] + ["model.dropout_probability=0"]
    dist = ["trainer.distributed=true", "data.global_rows=true"]
    for d in (DIST_OUT, DIST_REF_OUT):
        shutil.rmtree(d, ignore_errors=True)
    with reproducible():
        t0 = time.perf_counter()
        ref = train.run(compose(overrides=base + [f"output_dir={DIST_REF_OUT}"]))
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(free_port())}
        seen = {}
        setup = train.setup_parallelism

        def capture(*a, **k):
            seen["mesh"] = setup(*a, **k)
            return seen["mesh"]

        os.environ.update(env)
        train.setup_parallelism = capture
        try:
            cfg = compose(overrides=base + dist + [f"output_dir={DIST_OUT}"])
            torch.cuda.synchronize()
            collectives.reset_counts()
            mhsa.launches = mhsa.bwd_launches = 0
            t0 = time.perf_counter()
            metrics = train.run(cfg)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches, bwd_launches = mhsa.launches, mhsa.bwd_launches
            calls = dict(collectives.calls)
        finally:
            train.setup_parallelism = setup
            for k in env:
                os.environ.pop(k, None)
    mesh = seen["mesh"]
    with open(os.path.join(DIST_OUT, "checkpoints", "last.json")) as f:
        epochs = json.load(f)["epoch"] + 1
    quiet = compose(overrides=base + dist + [f"output_dir={DIST_OUT}", "loggers=[]"])
    rd = train.load_run_data(quiet)
    dc = quiet["data"]
    batcher = TrainBatcher(rd.store_train, rd.train_imp, batch_size=dc["batch_size"],
                           max_history_len=dc["max_history_len"],
                           neg_sampling_ratio=dc["neg_sampling_ratio"], seed=quiet.get("seed", 0),
                           u_bucket_min=dc.get("u_bucket_min", 512), global_rows=True)
    steps = epochs * len(batcher)
    train_expected = sum(attention_launches(b) for e in range(epochs) for b in batcher.epoch(e))
    evals = [serving_launches(store, imp, dc["max_history_len"], dc["eval_target_cells"])
             for store, imp in ((rd.store_train, rd.val_imp), (rd.store_test, rd.test_imp))]
    expected = train_expected + epochs * evals[0] + evals[1]
    want_calls = {"all_reduce_gradients": steps, "gather_scores": steps,
                  "gather_loss_inputs": 3 * steps, "gather_batch": 7 * steps, "broadcast": epochs + 1}
    diffs = {k: abs(metrics[k] - ref[k]) for k in ref if k.startswith("test/")}
    worst = max(diffs.values())
    log(f"distributed CLI (phase 17): rank {mesh.rank} of {mesh.world} over {mesh.backend}, "
        f"{wall_s:.2f} s wall ({ref_s:.2f} s without distributed) on {card}; {epochs} epochs of "
        f"{len(batcher)} steps; train/steps_per_sec {metrics['train/steps_per_sec']:.2f} "
        f"({ref['train/steps_per_sec']:.2f} without); collectives {json.dumps(calls)} "
        f"({json.dumps(want_calls)} expected); fused_small_mhsa launches {launches} "
        f"({expected} expected: {train_expected} in train steps), its backward {bwd_launches} "
        f"({train_expected} expected); test metrics vs the run without distributed: max abs "
        f"diff {worst:.3g} (tolerance {DIST_CLI_ATOL}), test/auc {metrics['test/auc']:.6f}")
    if mesh.backend != "nccl" or mesh.world != 1 or mesh.replicated_batches:
        raise AssertionError(f"not a multi-host NCCL rank: {mesh}")
    if calls != want_calls:
        raise AssertionError(f"collectives {calls}, {want_calls} expected")
    if launches != expected or bwd_launches != train_expected:
        raise AssertionError(f"{launches} forward and {bwd_launches} backward kernel launches "
                             f"({expected} and {train_expected} expected)")
    bad = [k for k, v in metrics.items() if k.startswith(("val/", "test/")) and
           not math.isfinite(v)]
    if bad or set(diffs) != {k for k in metrics if k.startswith("test/")} or \
            worst > DIST_CLI_ATOL:
        raise AssertionError(f"distributed test metrics {metrics} vs {ref}")
    return {"launches": launches, "bwd_launches": bwd_launches, "wall_s": wall_s,
            "ref_wall_s": ref_s, "steps": steps, "collectives": calls,
            "steps_per_sec": metrics["train/steps_per_sec"],
            "ref_steps_per_sec": ref["train/steps_per_sec"], "max_metric_diff": worst}


def two_rank_model(kind: str):
    """Phase 18's model, the same initial weights in every process: NRMS at
    full width (``dp``, ``rows``) or over a 2-layer 768-wide tower (``tp``),
    dropout 0, float32; and its global batch size."""
    import torch

    from newsreclib_tpu_torch.models.components.plm import PLMTextEncoder, TransformerEncoder
    from newsreclib_tpu_torch.models.general_rec import NRMS

    g = torch.Generator().manual_seed(0)
    if kind == "tp":
        tower = PLMTextEncoder(TransformerEncoder(**TWO_RANK_TOWER, generator=g), num_heads=16,
                               query_dim=200, dropout=0.0, generator=g)
        return NRMS(SERVING["vocab_size"], num_heads=16, query_dim=200, dropout=0.0,
                    text_encoder_module=tower, text_encoder_dim=768, device="cuda",
                    generator=g), TWO_RANK_TP_BATCH
    return NRMS(SERVING["vocab_size"], embed_dim=D, num_heads=15, query_dim=200, dropout=0.0,
                device="cuda", generator=g), TWO_RANK_BATCH


def two_rank_run(kind: str, store, imp, mesh=None) -> dict:
    """``TWO_RANK_STEPS`` global-row train steps of ``two_rank_model(kind)``
    at ``TWO_RANK_LR`` through ``Trainer`` (on ``mesh``, or on one device),
    under deterministic algorithms: the logged (global) losses, this
    process's kernel launches, and the full parameters before and after (on
    the host; a collective on a sharded mesh)."""
    import numpy as np
    import torch

    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.parallel.mesh import gather_state
    from newsreclib_tpu_torch.profile_train import DATA
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    class Losses:
        def __init__(self):
            self.losses = []

        def log_metrics(self, m, step):
            if "train/loss" in m and "epoch" in m and len(self.losses) < TWO_RANK_STEPS:
                self.losses.append(m["train/loss"])

    def on_host(sd):
        return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}

    model, batch = two_rank_model(kind)
    start = on_host(model.state_dict())
    data = {k: v for k, v in DATA.items() if k != "split_title_len"}
    batcher = TrainBatcher(store, imp, batch_size=batch, global_rows=True, **data)
    corpus = store.features_for(np.arange(store.title.shape[0]))
    cap = Losses()
    cfg = TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None,
                        limit_train_batches=TWO_RANK_STEPS, tp_transformer=kind == "tp")
    with reproducible():
        trainer = Trainer(create_train_state(model, make_optimizer(TWO_RANK_LR)),
                          cross_entropy_loss, cfg, loggers=[cap], mesh=mesh, corpus=corpus,
                          u_bucket=batcher.global_u_bucket())
        torch.cuda.synchronize()
        mhsa.launches = mhsa.bwd_launches = 0
        t0 = time.perf_counter()
        trainer.train_epoch(batcher, 0)
        torch.cuda.synchronize()
    s = time.perf_counter() - t0
    launches, bwd_launches = mhsa.launches, mhsa.bwd_launches
    end = on_host(gather_state(trainer.state, with_opt=False)["params"])
    return {"losses": cap.losses, "launches": launches, "bwd_launches": bwd_launches, "s": s,
            "start": start, "end": end,
            "sharded": sorted(trainer.state.sharded)[:4] + (["..."] if
                                                            len(trainer.state.sharded) > 4 else [])}


def update_distance(end, ref) -> float:
    """The distance of the parameters ``end`` from the one-rank run's over
    the one-rank run's update (``ref``'s "start" -> "end"), in norm over
    every parameter but the attention key biases: their gradient is
    structurally zero, float32 noise that Adam turns into updates of up to
    the learning rate on either route."""
    off = update = 0.0
    for k, want in ref["end"].items():
        keep = slice(None)
        if k.endswith("qkv.bias"):
            d = want.shape[0] // 3
            keep = [*range(d), *range(2 * d, 3 * d)]
        elif k.endswith(".k.bias"):
            continue
        a, b, s0 = (t[k][keep].double() for t in (end, ref["end"], ref["start"]))
        off += float(((a - b) ** 2).sum())
        update += float(((b - s0) ** 2).sum())
    return math.sqrt(off / update)


@contextlib.contextmanager
def planted_collective_fault(fault: str):
    """Phase 18's planted faults, on every rank (a rank that skipped a
    collective alone would hang the other): ``no_gradient_all_reduce``, each
    data rank steps on its own gradient; ``no_lookup_all_reduce``, each
    model rank looks up its own rows of the sharded table only."""
    from newsreclib_tpu_torch.parallel import collectives, embedding

    saved = collectives.all_reduce_gradients, embedding.all_reduce_
    if fault == "no_gradient_all_reduce":
        collectives.all_reduce_gradients = lambda params, group: None
    elif fault == "no_lookup_all_reduce":
        embedding.all_reduce_ = lambda t, group, name: t
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        collectives.all_reduce_gradients, embedding.all_reduce_ = saved


def two_rank_worker(rank: int, world: int, store, imp) -> dict:
    """One of phase 18's two ranks: both share ``cuda:0`` over gloo.  Each
    case's run, its distance from the one-rank run (``TWO_RANK_REF``), and
    the same with the case's planted fault."""
    import torch

    sys.path.insert(0, ROOT)
    from newsreclib_tpu_torch.parallel.mesh import destroy, init_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    out = {}
    try:
        for kind, model_axis in (("dp", 1), ("rows", 2), ("tp", 2)):
            mesh = init_mesh(rank, world, model_axis, device, backend="gloo")
            ref = torch.load(os.path.join(TWO_RANK_REF, f"{kind}.pt"))
            run = two_rank_run(kind, store, imp, mesh)
            run["update_distance"] = update_distance(run.pop("end"), ref)
            run.pop("start")
            run["backend"] = mesh.backend
            if kind in TWO_RANK_FAULTS:
                with planted_collective_fault(TWO_RANK_FAULTS[kind]):
                    faulty = two_rank_run(kind, store, imp, mesh)
                run["fault_distance"] = update_distance(faulty["end"], ref)
            out[kind] = run
            del ref
            torch.cuda.empty_cache()
    finally:
        destroy()
    return out


def two_rank_phase(card: str, store, imp) -> dict:
    """Phase 18 (module doc): one rank per case first (its parameters kept
    in ``TWO_RANK_REF``), then two ranks sharing ``cuda:0`` over gloo: each
    case's per-step losses and parameters against one rank's on the same
    global batches, the planted faults refused, and each rank's
    ``fused_small_mhsa`` launches (2 a step, forward and backward: the
    news table's encode, whole on every rank, and the rank's users).
    Returns the runs' launches, distances and times."""
    import torch

    from newsreclib_tpu_torch.parallel.launch import spawn

    os.makedirs(TWO_RANK_REF, exist_ok=True)
    ones = {}
    for kind in ("dp", "rows", "tp"):
        one = two_rank_run(kind, store, imp)
        torch.save({"start": one.pop("start"), "end": one.pop("end")},
                   os.path.join(TWO_RANK_REF, f"{kind}.pt"))
        ones[kind] = one
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(two_rank_worker, 2, (store, imp), timeout=600)
    wall_s = time.perf_counter() - t0
    out = {"wall_s": wall_s}
    for kind in ("dp", "rows", "tp"):
        one = ones[kind]
        want = 2 * TWO_RANK_STEPS
        got = [r[kind] for r in ranks]
        scale = max(abs(v) for v in one["losses"]) if kind == "tp" else 1.0
        diff = max(max(abs(a - b) for a, b in zip(r["losses"], one["losses"]))
                   for r in got) / scale
        dist = max(r["update_distance"] for r in got)
        fault = min(r["fault_distance"] for r in got) if kind in TWO_RANK_FAULTS else None
        log(f"two ranks on cuda:0 over {got[0]['backend']} (phase 18), {kind}: losses "
            f"{[round(v, 6) for v in got[0]['losses']]}, one rank "
            f"{[round(v, 6) for v in one['losses']]}: max {'relative' if kind == 'tp' else 'abs'}"
            f" diff {diff:.3g} (tolerance {TWO_RANK_ATOL}); parameters off one rank's by "
            f"{[r['update_distance'] for r in got]} of its update (tolerance "
            f"{TWO_RANK_UPDATE_RTOL})"
            + (f", with {TWO_RANK_FAULTS[kind]} planted "
               f"{[r['fault_distance'] for r in got]}" if fault is not None else "")
            + f"; launches per rank {[r['launches'] for r in got]} forward, "
            f"{[r['bwd_launches'] for r in got]} backward ({want} expected, one rank alone "
            f"{one['launches']}); {[round(r['s'], 2) for r in got]} s per rank, one rank "
            f"{one['s']:.2f} s; sharded {got[0]['sharded']}")
        if got[0]["backend"] != "gloo" or any(len(r["losses"]) != TWO_RANK_STEPS for r in got):
            raise AssertionError(f"phase 18 {kind}: {got}")
        if diff > TWO_RANK_ATOL or not all(math.isfinite(v) for v in one["losses"]):
            raise AssertionError(f"phase 18 {kind}: losses {got} vs {one['losses']}")
        if not dist <= TWO_RANK_UPDATE_RTOL:
            raise AssertionError(f"phase 18 {kind}: parameters {dist} of the update off")
        if fault is not None and not fault > TWO_RANK_UPDATE_RTOL:
            raise AssertionError(f"phase 18 {kind}: the parameter check does not tell the "
                                 f"planted {TWO_RANK_FAULTS[kind]} from the run ({fault})")
        if any(r["launches"] != want or r["bwd_launches"] != want for r in got) or \
                one["launches"] != want:
            raise AssertionError(f"phase 18 {kind}: launches {got}, {want} a rank expected")
        if kind != "dp" and not got[0]["sharded"]:
            raise AssertionError(f"phase 18 {kind}: nothing was sharded")
        out[kind] = {"launches_per_rank": [r["launches"] for r in got],
                     "bwd_launches_per_rank": [r["bwd_launches"] for r in got],
                     "max_loss_diff": diff, "update_distance": dist, "fault_distance": fault}
    log(f"phase 18: {wall_s:.1f} s for the two ranks (start, three cases, two planted "
        f"faults)")
    return out


def long_kernel_phase():
    """Phase 19a (module doc): both long kernels at ``kernel_bench.LONG_SHAPES``
    in float32 and bfloat16, forward against ``mhsa_plain``, backward against
    ``mhsa_backward`` and autograd of ``mhsa_plain`` (a fully masked sequence
    gets no q or k gradient), timed at ``LONG_TIMED`` with the plain
    versions and SDPA and made to reject the planted faults of
    ``ELEMENT_FAULTS``; then the bf16 ``LONG_HUGE``, whose qkv passes 2^31
    values, on its first and last ``LONG_HUGE_CHECKED`` sequences.  Returns
    the forward and backward records and the largest errors each way."""
    import torch

    from newsreclib_tpu_torch.kernel_bench import (
        ATOL,
        LONG_SHAPES,
        RTOL,
        check_backward,
        dtype_name,
        measure_backward,
        measure_shape,
        mhsa_inputs,
    )
    from newsreclib_tpu_torch.ops import mhsa

    def held(got, want, what):
        name = dtype_name(got.dtype)
        err = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got).all()) or not bool(
                (err <= ATOL[name] + RTOL[name] * want.float().abs()).all()):
            raise AssertionError(f"long instance {what} != plain: max abs err "
                                 f"{err.max().item()}")
        return err.max().item()

    t_phase = time.perf_counter()
    planted = element_faults()
    fwd, bwd, errs = [], [], [0.0, 0.0]
    for dtype in (torch.float32, torch.bfloat16):
        for u, l, d, h in LONG_SHAPES:
            assert mhsa.long_instance(l, d, h)
            if (u, l, d, h) in LONG_TIMED:
                rec = measure_shape(u, l, dtype, [("kernel", mhsa.fused_small_mhsa)], d=d, h=h)
                log("long_kernel_shape " + json.dumps(rec))
                fwd.append(rec)
                rec = measure_backward(u, l, dtype, d=d, h=h)
                log("long_backward_shape " + json.dumps(rec))
                bwd.append(rec)
                shape_errs = [fwd[-1]["max_abs_err"], rec["max_abs_err"]]
                for fault in ELEMENT_FAULTS[dtype_name(dtype)]:
                    try:
                        check_backward(u, l, dtype, d=d, h=h, **planted[fault])
                    except AssertionError as e:
                        log(f"planted fault {fault} at {(u, l, d, h)} {dtype}: caught ({e})")
                    else:
                        raise AssertionError(f"the element check at {(u, l, d, h)} {dtype} "
                                             f"does not tell the planted fault {fault} from "
                                             "the plain version")
            else:
                shape_errs = list(check_backward(u, l, dtype, d=d, h=h)[:2])
            qkv, mask = mhsa_inputs(u, l, dtype, seed=u + l, d=d)
            g = torch.randn((u, l, d), generator=torch.Generator(device="cuda").manual_seed(u),
                            device="cuda").to(dtype)
            got = mhsa._backward(qkv, mask, h, g)
            shape_errs.append(held(got, mhsa.mhsa_backward(qkv, mask, h, g),
                                   f"backward at {(u, l, d, h)}"))
            if not bool((got[0, :, :2 * d] == 0).all()):
                raise AssertionError(f"the fully masked sequence got a q or k gradient at "
                                     f"{(u, l, d, h)} {dtype}")
            errs = [max(errs[0], shape_errs[0]), max(errs[1], *shape_errs[1:])]
            log(f"long instance at {(u, l, d, h)} {dtype}: forward and backward held; max abs "
                f"err: output {shape_errs[0]:.3g}, gradient against autograd of mhsa_plain "
                f"{shape_errs[1]:.3g} and against mhsa_backward {shape_errs[2]:.3g}")

    u, l, d, h = LONG_HUGE
    gen = torch.Generator(device="cuda").manual_seed(1)
    qkv = torch.randn((u, l, 3 * d), generator=gen, device="cuda", dtype=torch.bfloat16)
    mask = torch.rand((u, l), generator=gen, device="cuda") < 0.7
    mask[:, 0] = True
    mask[0] = False
    g = torch.randn((u, l, d), generator=gen, device="cuda", dtype=torch.bfloat16)
    if qkv.numel() <= 2**31:
        raise AssertionError(f"{LONG_HUGE} holds no more than 2^31 values")
    t0 = time.perf_counter()
    out = mhsa.fused_small_mhsa(qkv, mask, h)
    dqkv = mhsa._backward(qkv, mask, h, g)
    torch.cuda.synchronize()
    huge_s = time.perf_counter() - t0
    n = LONG_HUGE_CHECKED
    for part in (slice(0, n), slice(u - n, u)):
        errs[0] = max(errs[0], held(out[part], mhsa.mhsa_plain(qkv[part], mask[part], h),
                                    f"forward at {LONG_HUGE}, sequences {part}"))
        errs[1] = max(errs[1], held(dqkv[part], mhsa.mhsa_backward(qkv[part], mask[part], h,
                                                                    g[part]),
                                    f"backward at {LONG_HUGE}, sequences {part}"))
    log(f"long instance at {LONG_HUGE} bfloat16 ({qkv.numel()} qkv values, > 2^31): forward "
        f"and backward {huge_s:.2f} s, held on sequences 0-{n - 1} and {u - n}-{u - 1}")
    del qkv, mask, g, out, dqkv
    torch.cuda.empty_cache()
    log(f"long kernel phase (19a): {time.perf_counter() - t_phase:.1f} s")
    return fwd, bwd, errs


def long_phase(card: str) -> dict:
    """Phase 19b (module doc): the long instances on the main path at
    ``data.max_history_len=200``, every count set to 0 just before each run
    and read just after: one cached-serving epoch of the serving workload
    drawn with up to 200 clicks (bf16, exact launches, the user encoder's
    all long; metrics against the plain attention's in bf16 over the epoch
    and in float32 over ``COMPARE_IMPRESSIONS``); ``LONG_TRAIN_STEPS``
    ``TrainBatcher`` steps at batch 64 and history 200 in float32 and bf16
    compute from the same weights under ``reproducible``, kernel route
    against plain route (``ROUTE_ATOL``) with exact launches, then phase 4's
    route check on a planted-signal batch at history 200 (the planted
    faults of ``LONG_ROUTE_FAULTS`` beyond the tolerance); the demo CLI with
    ``LONG_CLI_OVERRIDES`` through ``cli_phase``'s checks (exact launches,
    the restored test with the plain attention), every user-encoder call at
    L = 200 in the long instances.  Returns the launches and timings."""
    import numpy as np
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.data.synthetic import make_serving_workload
    from newsreclib_tpu_torch.models.general_rec import NRMS
    from newsreclib_tpu_torch.ops import mhsa
    from newsreclib_tpu_torch.profile_train import DATA, attention_launches
    from newsreclib_tpu_torch.serving import CachedScorer, corpus_segments

    def reset():
        torch.cuda.synchronize()
        for k in ("launches", "bwd_launches", "wide_launches", "wide_bwd_launches",
                  "long_launches", "long_bwd_launches"):
            setattr(mhsa, k, 0)

    def counts():
        torch.cuda.synchronize()
        return dict(fwd=mhsa.launches, bwd=mhsa.bwd_launches, long=mhsa.long_launches,
                    long_bwd=mhsa.long_bwd_launches)

    t_phase = time.perf_counter()
    out = {}
    store, imp = make_serving_workload(np.random.default_rng(0), **LONG_SERVING)
    evl = dict(EVAL, max_history_len=LONG_HISTORY)
    model = NRMS(SERVING["vocab_size"], device="cuda",
                 generator=torch.Generator().manual_seed(0)).eval()
    model_bf16 = copy.deepcopy(model).to(torch.bfloat16)
    scorer = CachedScorer(model_bf16, device="cuda")
    scorer.evaluate(store, imp, **evl)  # warm-up: builds the device caches
    reset()
    t0 = time.perf_counter()
    metrics = scorer.evaluate(store, imp, **evl)
    epoch_s = time.perf_counter() - t0
    got = counts()
    encode = sum(math.ceil(len(rows) / ENCODE_BATCH)
                 for rows, _ in corpus_segments(store, 16, ENCODE_BATCH))
    expected = serving_launches(store, imp, LONG_HISTORY)
    log(f"long serving epoch (history up to {LONG_HISTORY}): {epoch_s:.4f} s for {len(imp)} "
        f"impressions on {card}; launches {json.dumps(got)} ({expected} expected, "
        f"{expected - encode} of them the user encoder's, long)")
    if got["fwd"] != expected or got["long"] != expected - encode or got["bwd"]:
        raise AssertionError(f"long serving epoch launches {got} ({expected} expected, "
                             f"{expected - encode} long)")
    want = CachedScorer(plain_copy(model_bf16), device="cuda").evaluate(store, imp, **evl)
    sub = imp.subset(COMPARE_IMPRESSIONS)
    got32 = CachedScorer(model, device="cuda").evaluate(store, sub, **evl)
    want32 = CachedScorer(plain_copy(model), device="cuda").evaluate(store, sub, **evl)
    for name, a, b in (("bfloat16", metrics, want), ("float32", got32, want32)):
        diff = max(abs(a[k] - b[k]) for k in b)
        log(f"long served metrics, kernel vs plain attention, {name}: max abs diff {diff:.3g} "
            f"(tolerance {METRIC_ATOL[name]})")
        if set(a) != set(b) or diff > METRIC_ATOL[name] or not all(
                math.isfinite(v) for v in a.values()):
            raise AssertionError(f"long served metrics differ ({name}): {a} vs {b}")
    out["serving"] = dict(got, epoch_s=epoch_s, metrics=metrics)

    data = dict(DATA, max_history_len=LONG_HISTORY)
    batches = [b for _, b in zip(range(LONG_TRAIN_STEPS),
                                 TrainBatcher(store, imp, batch_size=TRAIN_BATCH,
                                              **data).epoch(0))]
    expected = sum(attention_launches(b) for b in batches)
    users = {tuple(b.hist_idx.shape) for b in batches}
    batches = [to_device(b, "cuda") for b in batches]
    planted = [planted_batch(LONG_HISTORY)] * ROUTE_STEPS
    out["train"] = {}
    for name, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
        reset()
        t0 = time.perf_counter()
        kernel = route_losses(batches, cdtype, PLANTED_LR, None)[0]
        wall_s = time.perf_counter() - t0
        got = counts()
        plain = route_losses(batches, cdtype, PLANTED_LR, "plain")[0]
        diff = (kernel - plain).abs().max().item()
        log(f"long train steps ({LONG_TRAIN_STEPS} at batch {TRAIN_BATCH}, histories "
            f"{sorted(users)}), {name}: launches {json.dumps(got)} ({expected} expected each "
            f"way, {LONG_TRAIN_STEPS} long); kernel vs plain route max abs diff {diff:.3g} "
            f"(tolerance {ROUTE_ATOL[name]}); losses {kernel.tolist()}; {wall_s:.2f} s")
        if (got["fwd"], got["bwd"], got["long"], got["long_bwd"]) != (
                expected, expected, LONG_TRAIN_STEPS, LONG_TRAIN_STEPS):
            raise AssertionError(f"long train launches {got} ({expected} each way, "
                                 f"{LONG_TRAIN_STEPS} long expected)")
        if not bool(torch.isfinite(kernel).all()) or diff > ROUTE_ATOL[name]:
            raise AssertionError(f"long train losses differ ({name}): {kernel} vs {plain}")
        # the route check of phase 4 on a planted-signal batch at history 200
        kernel = route_losses(planted, cdtype, PLANTED_LR, None)[0]
        plain = route_losses(planted, cdtype, PLANTED_LR, "plain")[0]
        route = (kernel - plain).abs().max().item()
        faults = {f: (route_losses(planted, cdtype, PLANTED_LR, FAULTS[f])[0]
                      - plain).abs().max().item() for f in LONG_ROUTE_FAULTS}
        log(f"long route check, {ROUTE_STEPS} steps on a planted-signal batch at history "
            f"{LONG_HISTORY}, {name}: kernel vs plain max abs diff {route:.3g} (tolerance "
            f"{ROUTE_ATOL[name]}); planted faults {json.dumps(faults)}; kernel "
            f"{kernel[0].item():.5f} -> {kernel[-1].item():.5f}")
        if not bool(torch.isfinite(kernel).all()) or route > ROUTE_ATOL[name]:
            raise AssertionError(f"long route losses differ ({name}): {kernel} vs {plain}")
        missed = [f for f, v in faults.items() if not v > ROUTE_ATOL[name]]
        if missed:
            raise AssertionError(f"the long route check ({name}) does not tell the planted "
                                 f"faults {missed} from the plain attention: {faults}")
        out["train"][name] = dict(got, diff=diff, route_diff=route, wall_s=wall_s)

    reset()
    with kernel_shapes({}) as seen:
        fwd, bwd, wall_s = cli_phase(card, LONG_CLI_OVERRIDES)
    got = counts()
    at_history = sum(n for (_, l), n in seen.items() if l == LONG_HISTORY)
    log(f"long CLI run (history {LONG_HISTORY}): launches {json.dumps(got)}, the kernel saw "
        f"(U, L) {json.dumps({f'{u}x{l}': n for (u, l), n in sorted(seen.items())})}")
    if not at_history or got["long"] != at_history or got["long"] != sum(
            n for (_, l), n in seen.items() if mhsa.long_instance(l, D, 15)):
        raise AssertionError(f"the long CLI run's user encoder did not run in the long "
                             f"instances: {got}, shapes {seen}")
    out["cli"] = dict(got, wall_s=wall_s)
    log(f"long phase (19b): {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    # cuBLAS repeats its results only with a fixed workspace (``reproducible``);
    # set before the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from newsreclib_tpu_torch.data.synthetic import make_serving_workload
    from newsreclib_tpu_torch.kernel_bench import EXTRA_SHAPES, MANNER_SHAPES, card_line
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
    if sys.argv[1:2] == ["--route-spread"]:
        route_spread(sys.argv[2:])
        return 0

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
    row_shapes = global_row_shapes(store, imp)
    checked = list(shapes)
    for s in train_shapes + EXTRA_SHAPES + row_shapes:
        if s not in checked:
            checked.append(s)
    records = kernel_phase(checked)
    bwd_records = backward_phase(train_shapes + [s for s in row_shapes if s not in train_shapes])
    bwd_main, bwd_f32 = (next(r for r in bwd_records if r["dtype"] == name)
                         for name in ("bfloat16", "float32"))
    zoo_fwd, zoo_bwd = zoo_kernel_phase()
    long_fwd, long_bwd, long_errs = long_kernel_phase()
    # after the profiled phases: with the CLI phase before them, a profiler
    # window recorded no device time, and with the zoo phase before them six
    # windows in a row recorded fewer kernels than calls (one H100 run each)
    zoo_counts, zoo_by_model = zoo_phase(card, store, imp)
    fair_counts, fair_by_model = zoo_phase(card, store, imp, FAIR)
    aspect_counts, ensemble_metrics = aspect_phase(card, store, imp)
    plm_counts, plm_epoch_s, plm_peak_mb, plm_shapes = plm_phase(card, store, imp)
    zoo2_worst = zoo2_phase(card, store, imp)
    cli_launches, cli_bwd_launches, cli_s = cli_phase(card)
    plm_cli_launches, plm_cli_bwd_launches, plm_cli_s = cli_phase(card, PLM_CLI_OVERRIDES)
    dataset_runs = dataset_cli_phase(card)
    plm_mode_runs = plm_mode_phase(card)
    sweep_run = sweep_phase(card, cli_launches, cli_bwd_launches)
    remat = remat_phase(card, store, imp)
    annotator = annotator_phase(card)
    dist_cli = distributed_cli_phase(card)
    two_rank = two_rank_phase(card, store, imp)
    long_run = long_phase(card)

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
        **{f"{name}_cli_launches": run["launches"] for name, run in dataset_runs.items()},
        **{f"{name}_cli_wall_s": run["wall_s"] for name, run in dataset_runs.items()},
        "sweep_launches": sweep_run["launches"],
        "sweep_wall_s": sweep_run["wall_s"],
        "annotator_launches": {k: run["launches"] for k, run in annotator.items()},
        "distributed_cli_launches": dist_cli["launches"],
        "distributed_cli_wall_s": dist_cli["wall_s"],
        "distributed_cli_collectives": dist_cli["collectives"],
        "two_rank_launches_per_rank": {k: two_rank[k]["launches_per_rank"]
                                       for k in ("dp", "rows", "tp")},
        "two_rank_wall_s": two_rank["wall_s"],
        "two_rank_update_distance": {k: two_rank[k]["update_distance"]
                                     for k in ("dp", "rows", "tp")},
        "two_rank_fault_distance": {k: two_rank[k]["fault_distance"] for k in TWO_RANK_FAULTS},
        "global_row_shapes": row_shapes,
    }, {
        "name": "fused_small_mhsa_backward",
        "route": "cuda",
        "source": "newsreclib_tpu_torch/csrc/mhsa.cu",
        "replaces": "newsreclib_tpu/ops/mhsa.py:219 (XLA autodiff of mhsa_reference; "
                    "the TPU kernel at :160 has no backward)",
        "launches": bwd_launches,
        "launches_per_step": bwd_launches / TRAIN_TIMED,
        "cli_launches": cli_bwd_launches,
        **{f"{name}_cli_launches": run["bwd_launches"] for name, run in dataset_runs.items()},
        "sweep_launches": sweep_run["bwd_launches"],
        "distributed_cli_launches": dist_cli["bwd_launches"],
        "two_rank_launches_per_rank": {k: two_rank[k]["bwd_launches_per_rank"]
                                       for k in ("dp", "rows", "tp")},
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
        i = 0 if not prefix else 1
        entry.update({
            "zoo_launches": int(zoo_counts[i]),
            "miner_launches": int(zoo_by_model["miner"][i]),
            "fair_launches": {name: int(c[i]) for name, c in fair_by_model.items()},
            "aspect_ensemble_launches": int(aspect_counts[i]),
            "d400_f32_ms": r[prefix + "ms"], "d400_f32_bound_ms": r[prefix + "bound_ms"],
            "d400_f32_plain_ms": r["plain_" + prefix + "ms"],
            "d400_f32_library_ms": r["library_" + prefix + "ms"],
        })
    manner_shapes = {"manner": MANNER_SHAPES[0], "manner_tail": MANNER_SHAPES[1],
                     "manner_a": MANNER_SHAPES[2]}
    for name, recs, prefix, count in (
            ("fused_small_mhsa_wide", zoo_fwd, "",
             zoo_counts[2] + fair_counts[2] + aspect_counts[2]),
            ("fused_small_mhsa_wide_backward", zoo_bwd, "bwd_",
             zoo_counts[3] + fair_counts[3] + aspect_counts[3])):
        main_r, f32_r = (zoo_rec(recs, wide_shape, t) for t in ("bfloat16", "float32"))
        box = {"manner_cr_launches": int(fair_by_model["manner_cr"][2 if not prefix else 3]),
               "aspect_ensemble_launches": int(aspect_counts[2 if not prefix else 3]),
               "remat_launches": {k: remat[k]["bwd_launches" if prefix else "launches"]
                                  for k in ("remat", "no_remat")},
               "remat_segments": remat["segments"],
               "remat_peak_mb": {k: remat[k]["peak_mb"] for k in ("remat", "no_remat")}}
        for key, shape in {**BOX_SHAPES, **manner_shapes}.items():
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
            "plm_launches": int(plm_counts[2 if not prefix else 3]),
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
    from newsreclib_tpu_torch.kernel_bench import PLM_D, PLM_H

    plm_head = [s + (PLM_D, PLM_H) for s in plm_shapes] + [(PLM_BATCH, SERVING["hist_len"],
                                                            PLM_D, PLM_H)]
    for name, recs, prefix, count, cli in (
            ("fused_small_mhsa_plm_head", zoo_fwd, "", plm_counts[2], plm_cli_launches),
            ("fused_small_mhsa_plm_head_backward", zoo_bwd, "bwd_", plm_counts[3],
             plm_cli_bwd_launches)):
        main_r, f32_r = (zoo_rec(recs, plm_head[0], t) for t in ("bfloat16", "float32"))
        by_shape = {}
        for shape in plm_head[1:]:
            for t, tag in (("bfloat16", ""), ("float32", "f32_")):
                r = zoo_rec(recs, shape, t)
                key = f"u{shape[0]}_l{shape[1]}_{tag}"
                by_shape.update({key + "ms": r[prefix + "ms"],
                                 key + "bound_ms": r[prefix + "bound_ms"],
                                 key + "plain_ms": r["plain_" + prefix + "ms"],
                                 key + "library_ms": r["library_" + prefix + "ms"]})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "newsreclib_tpu_torch/csrc/mhsa.cu",
            "replaces": ("newsreclib_tpu/ops/mhsa.py:160" if not prefix else
                         "newsreclib_tpu/ops/mhsa.py:219 (XLA autodiff of mhsa_reference)")
                        + " in the PLM-NR head (newsreclib_tpu/models/components/plm.py:215) "
                          "and NRMS's user encoder over it, 16 heads of 48",
            "launches": int(count),
            "max_abs_err": max(zoo_rec(recs, s, t)["max_abs_err"] for s in plm_head
                               for t in ("bfloat16", "float32")),
            "ms": main_r[prefix + "ms"],
            "plain_ms": main_r["plain_" + prefix + "ms"],
            "bound_ms": main_r[prefix + "bound_ms"],
            "bound_by": main_r[prefix + "bound_by"],
            "library_ms": main_r["library_" + prefix + "ms"],
            "f32_ms": f32_r[prefix + "ms"],
            "f32_bound_ms": f32_r[prefix + "bound_ms"],
            "f32_plain_ms": f32_r["plain_" + prefix + "ms"],
            "f32_library_ms": f32_r["library_" + prefix + "ms"],
            "shape": list(plm_head[0]),
            "cli_launches": cli,
            "cli_wall_s": plm_cli_s,
            "plm_mode_cli_launches": {k: run["launches" if not prefix else "bwd_launches"]
                                      for k, run in plm_mode_runs.items()},
            "plm_mode_cli_wall_s": {k: run["wall_s"] for k, run in plm_mode_runs.items()},
            "plm_mode_widths": {k: dict(run["widths"], kernel_l=run["seen_l"])
                                for k, run in plm_mode_runs.items()},
            "served_epoch_s": plm_epoch_s,
            "served_peak_mb": plm_peak_mb,
            **by_shape,
        })
    for name, recs, prefix, err in (("fused_small_mhsa_long", long_fwd, "", long_errs[0]),
                                    ("fused_small_mhsa_long_backward", long_bwd, "bwd_",
                                     long_errs[1])):
        by_shape = {}
        for shape in LONG_TIMED:
            for t, tag in (("bfloat16", ""), ("float32", "f32_")):
                r = zoo_rec(recs, shape, t)
                key = "" if shape == LONG_TIMED[0] else f"u{shape[0]}_l{shape[1]}_d{shape[2]}_"
                by_shape.update({key + tag + "ms": r[prefix + "ms"],
                                 key + tag + "bound_ms": r[prefix + "bound_ms"],
                                 key + tag + "bound_by": r[prefix + "bound_by"],
                                 key + tag + "plain_ms": r["plain_" + prefix + "ms"],
                                 key + tag + "library_ms": r["library_" + prefix + "ms"]})
        runs = [long_run["serving"]] if not prefix else []
        runs += list(long_run["train"].values()) + [long_run["cli"]]
        key = "long_bwd" if prefix else "long"
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "newsreclib_tpu_torch/csrc/mhsa.cu",
            "replaces": ("newsreclib_tpu/ops/mhsa.py:160" if not prefix else
                         "newsreclib_tpu/ops/mhsa.py:219 (XLA autodiff of mhsa_reference)")
                        + " at L above 128 and head dims beyond the wide instances' box",
            "launches": sum(run[key] for run in runs),
            "max_abs_err": err,
            **by_shape,
            "shape": list(LONG_TIMED[0]),
            "serving_launches": long_run["serving"][key],
            "serving_epoch_s": long_run["serving"]["epoch_s"],
            "train_launches": {k: v[key] for k, v in long_run["train"].items()},
            "cli_launches": long_run["cli"][key],
            "cli_wall_s": long_run["cli"]["wall_s"],
        })
    log("zoo models without an MHSA, largest errors: " + json.dumps(zoo2_worst))
    log("MANNeR ensemble served metrics: " + json.dumps(ensemble_metrics))
    log(f"total {time.time() - t_start:.1f} s; kernel times at U=4096 L=16 (forward) and "
        f"U={bwd_main['U']} L={bwd_main['L']} (backward), bf16 (f32_*: float32), on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
