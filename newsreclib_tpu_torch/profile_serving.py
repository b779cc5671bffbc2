"""Where the time of one cached-serving epoch goes, on one NVIDIA card.

    python3 -m newsreclib_tpu_torch.profile_serving

Same cell as ``chip_smoke.py``'s serving phase (NRMS at full width, bf16
parameters, the ``bench.py`` workload from seed 0).  After one warm-up
epoch it prints, as JSON lines:

* ``phases``: host-clock seconds, each ending in ``torch.cuda.synchronize``,
  of the corpus encode (``build_news_vector_table``) and of a whole
  ``CachedScorer.evaluate`` epoch (which re-encodes the corpus, then scores);
* ``profile``: one epoch under ``torch.profiler``: the wall time, the summed
  device time of all kernels and their ratio (the device's busy share; the
  port runs on one stream, so kernels do not overlap), and the kernels that
  took the most device time.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _sync_seconds(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from newsreclib_tpu_torch.data.synthetic import make_serving_workload
    from newsreclib_tpu_torch.models.general_rec import NRMS
    from newsreclib_tpu_torch.serving import CachedScorer, build_news_vector_table

    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    store, imp = make_serving_workload(np.random.default_rng(0))  # bench.py's workload
    model = NRMS(60000, device="cuda",
                 generator=torch.Generator().manual_seed(0)).eval().to(torch.bfloat16)
    scorer = CachedScorer(model, device="cuda")
    scorer.evaluate(store, imp)  # warm-up: device caches, kernel build

    with torch.inference_mode():
        encode_s = min(_sync_seconds(lambda: build_news_vector_table(model, store, device="cuda"))
                       for _ in range(3))
    epoch_s = min(_sync_seconds(lambda: scorer.evaluate(store, imp)) for _ in range(3))
    print(json.dumps({"phases": {"corpus_encode_s": encode_s, "epoch_s": epoch_s,
                                 "impressions": len(imp), "card": card}}))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = _sync_seconds(lambda: scorer.evaluate(store, imp))
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:15]
    print(json.dumps({"profile": {
        "wall_s": wall_s, "device_busy_s": device_us / 1e6,
        "device_busy_share": device_us / 1e6 / wall_s,
        "cuda_launches": sum(e.count for e in events),
        "top_kernels": [{"name": e.key[:90], "calls": e.count,
                         "device_ms": e.self_device_time_total / 1e3} for e in top],
        "card": card}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
