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
   batch-64 training shapes in bfloat16 (``kernel_bench.measure_backward``);
7. prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

Exits non-zero, printing no result, when no card is present or any phase
fails.  Writes nothing but the kernel build under ``build/``.
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


def serving_launches(store, imp):
    """Kernel launches of one serving epoch: one per chunk of the corpus
    encode and one per impression batch (the user encoder)."""
    from newsreclib_tpu_torch.data.batching import BucketedAssembler
    from newsreclib_tpu_torch.serving import corpus_segments

    encode = sum(math.ceil(len(rows) / ENCODE_BATCH)
                 for rows, _ in corpus_segments(store, 16, ENCODE_BATCH))
    buckets = BucketedAssembler(imp, SERVING["hist_len"], TARGET_CELLS).buckets
    return encode + sum(math.ceil(len(idx) / max(1, TARGET_CELLS // c))
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
    (``kernel_bench.measure_backward``, which checks it first).  Returns the
    per-shape records."""
    import torch

    from newsreclib_tpu_torch.kernel_bench import measure_backward

    records = []
    for u, l in shapes:
        rec = measure_backward(u, l, torch.bfloat16)
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


def route_losses(store, imp, batches, cdtype, lr, attention):
    """Per-step losses of a fresh cell over ``batches`` with every MHSA's
    attention set to ``attention`` (None: the kernel)."""
    import torch

    from newsreclib_tpu_torch.models.components.attention import (
        MultiHeadSelfAttention,
        use_plain_attention,
    )
    from newsreclib_tpu_torch.profile_train import make_cell

    st, _, stp = make_cell(store, imp, TRAIN_BATCH, "cuda", compute_dtype=cdtype,
                           learning_rate=lr)
    if attention == "plain":
        use_plain_attention(st.model)
    elif attention is not None:
        for m in st.model.modules():
            if isinstance(m, MultiHeadSelfAttention):
                m.attention = attention
    return torch.stack([stp(st, b)[1]["loss"] for b in batches]).cpu()


def training_phase(card: str, store, imp):
    """The training path, then its checks (see module doc).  Returns the
    forward and the backward kernel launches of the timed steps, the step
    time in seconds, the attention shapes (U, L) of the timed steps and the
    largest gradient error of the checks."""
    import numpy as np
    import torch

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch
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
    cfg = SyntheticConfig(vocab_size=SERVING["vocab_size"])
    planted = to_device(make_batch(np.random.default_rng(0), batch_size=TRAIN_BATCH,
                                   hist_len=DATA["max_history_len"], num_candidates=5,
                                   unique_news=1024, cfg=cfg, planted_signal=True), "cuda")
    for name, cdtype in (("float32", None), ("bfloat16", "bfloat16")):
        route = [planted] * ROUTE_STEPS
        kernel = route_losses(store, imp, route, cdtype, PLANTED_LR, None)
        plain = route_losses(store, imp, route, cdtype, PLANTED_LR, "plain")
        diff = (kernel - plain).abs().max().item()
        faults = {f: (route_losses(store, imp, route, cdtype, PLANTED_LR, fn)
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
    curve = route_losses(store, imp, [planted] * PLANTED_STEPS, "bfloat16", PLANTED_LR, None)
    log(f"planted signal, {PLANTED_STEPS} steps at lr {PLANTED_LR}: loss "
        f"{curve[0].item():.4f} -> {curve[-1].item():.4f}")
    if not curve[-1].item() <= curve[0].item() / 2:
        raise AssertionError(f"the planted-signal loss did not halve: {curve.tolist()}")
    return launches, bwd_launches, step_s, grad_shapes, max(grad_errs)


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
    log(f"workload: {SERVING['corpus']} articles, {len(imp)} impressions, "
        f"built in {time.time() - t0:.1f} s")
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
    bwd_main = bwd_records[0]

    main_shape = next(r for r in records if (r["U"], r["L"], r["dtype"]) == (4096, 16, "bfloat16"))
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
        "train_launches": train_launches,
        "train_launches_per_step": train_launches / TRAIN_TIMED,
        "train_step_ms": train_step_s * 1e3,
    }, {
        "name": "fused_small_mhsa_backward",
        "route": "cuda",
        "source": "newsreclib_tpu_torch/csrc/mhsa.cu",
        "replaces": "newsreclib_tpu/ops/mhsa.py:219 (XLA autodiff of mhsa_reference; "
                    "the TPU kernel at :160 has no backward)",
        "launches": bwd_launches,
        "launches_per_step": bwd_launches / TRAIN_TIMED,
        "max_abs_err": max(grad_err, *(r["max_abs_err"] for r in bwd_records)),
        "ms": bwd_main["bwd_ms"],
        "plain_ms": bwd_main["plain_bwd_ms"],
        "bound_ms": bwd_main["bwd_bound_ms"],
        "bound_by": bwd_main["bwd_bound_by"],
        "library_ms": bwd_main["library_bwd_ms"],
        "fwd_bwd_ms": bwd_main["ms"],
        "autograd_plain_fwd_bwd_ms": bwd_main["plain_ms"],
        "library_fwd_bwd_ms": bwd_main["library_ms"],
    }]
    log(f"total {time.time() - t_start:.1f} s; kernel times at U=4096 L=16 (forward) and "
        f"U={bwd_main['U']} L={bwd_main['L']} (backward), bf16, on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
