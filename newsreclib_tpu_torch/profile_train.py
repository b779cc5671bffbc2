"""Where the time of an NRMS train step goes, on one NVIDIA card.

    python3 -m newsreclib_tpu_torch.profile_train [--steps 20] [--json OUT.jsonl]

The cell (``make_cell``): NRMS at the width of
``newsreclib_tpu/configs/model/nrms.yaml`` (D = 300, 15 heads of 20, query
200, dropout 0.2, vocab 60,000, random weights from seed 0), float32 master
parameters with bfloat16 compute, Adam at lr 1e-4, cross-entropy, fed by
``TrainBatcher`` at ``configs/data/mind_small.yaml``'s values (K = 4
negatives, history 50, ``u_bucket_min`` 512, ``split_title_len`` 16) over
the ``bench.py`` workload regenerated from seed 0 (32,768 articles, 16,384
impressions, one positive each).  Two batch sizes: 64 (the data config)
and 256 (``bench.py``'s train step: 256 impressions of 5 candidates).

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

MODEL = dict(vocab_size=60000, embed_dim=300, num_heads=15, query_dim=200, dropout=0.2)
DATA = dict(max_history_len=50, neg_sampling_ratio=4, seed=0, u_bucket_min=512,
            split_title_len=16)
LEARNING_RATE = 1e-4
BATCH_SIZES = (64, 256)
WARMUP = 5


def make_cell(store, imp, batch_size, device, compute_dtype="bfloat16",
              learning_rate=LEARNING_RATE):
    """``(state, batcher, train_step)`` of the cell in the module doc."""
    import torch

    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.models.general_rec import NRMS
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.steps import make_train_step

    model = NRMS(**MODEL, device=device,
                 generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_optimizer(learning_rate), dropout_seed=0)
    batcher = TrainBatcher(store, imp, batch_size=batch_size, **DATA)
    return state, batcher, make_train_step(cross_entropy_loss, compute_dtype)


def attention_launches(batch) -> int:
    """Attention kernel launches of one NRMS train step on ``batch``, each
    of the forward and of the backward kernel: one per news segment and one
    for the user encoder."""
    return 2 + (batch.news2 is not None)


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


def profile_cell(store, imp, batch_size: int, steps: int, card: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from newsreclib_tpu_torch.data.batch import to_device
    from newsreclib_tpu_torch.models.components.attention import use_plain_attention
    from newsreclib_tpu_torch.ops import mhsa

    state, batcher, step = make_cell(store, imp, batch_size, "cuda")
    plain_state, _, plain_step = make_cell(store, imp, batch_size, "cuda")
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
    expected = sum(attention_launches(b) for b in timed)
    if launches != expected or bwd_launches != expected:
        raise AssertionError(f"{launches} forward and {bwd_launches} backward kernel launches "
                             f"({expected} each expected)")
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
        "batch_size": batch_size,
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
        rec = profile_cell(store, imp, batch_size, args.steps, card)
        print("profile_train " + json.dumps(rec), flush=True)
        records.append(rec)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text("".join(json.dumps(r) + "\n" for r in records))
    return 0


if __name__ == "__main__":
    sys.exit(main())
