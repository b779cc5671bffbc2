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
   launch counts are read across the timed epoch.  The served metrics must be
   finite and equal those of the same pipeline with the plain attention
   forced, over the first 2,048 impressions;
   then holds each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it, in float32 and bfloat16, with its
   time, its plain version's time and a library call's time
   (``newsreclib_tpu_torch/kernel_bench.py``: device time per launch from
   ``torch.profiler``, inputs rotated past the L2; the per-call CUDA event
   time, host cost included, is on each ``kernel_shape`` line);
4. prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

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


def plain_copy(model):
    """``model`` with every MHSA forced onto the plain attention."""
    from newsreclib_tpu_torch.models.components.attention import MultiHeadSelfAttention
    from newsreclib_tpu_torch.ops.mhsa import mhsa_plain

    plain = copy.deepcopy(model)
    for m in plain.modules():
        if isinstance(m, MultiHeadSelfAttention):
            m.attention = mhsa_plain
    return plain


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
    launches = mhsa.launches
    log(f"serving epoch: {epoch_s:.4f} s for {len(imp)} impressions -> "
        f"{len(imp) / epoch_s:.1f} impressions/s on {card}; "
        f"fused_small_mhsa launches {launches}")
    log("metrics " + json.dumps(metrics, sort_keys=True))
    if launches == 0:
        raise AssertionError("the serving epoch launched no fused_small_mhsa kernel")
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
    records = kernel_phase(shapes + [s for s in EXTRA_SHAPES if s not in shapes])

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
    }]
    log(f"total {time.time() - t_start:.1f} s; kernel times at U=4096 L=16 bf16 on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
