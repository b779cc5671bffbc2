"""Profiling hooks (counterpart of ``newsreclib_tpu/utils/profiling.py``):
a ``torch.profiler`` trace of a block, named ranges inside it, and a host
timer of named phases.
"""

from __future__ import annotations

import contextlib
import logging
import os
import socket
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger("newsreclib_tpu_torch")


@contextlib.contextmanager
def trace(out_dir: str) -> Iterator[profile]:
    """Profile the enclosed block (host operations, and the card's kernels
    and copies where a card is present) and write a Chrome / Perfetto trace
    ``<host>_<pid>.<ms>.pt.trace.json`` under ``out_dir``; yields the
    profiler (``key_averages()`` for tables).

    View in https://ui.perfetto.dev or ``chrome://tracing``."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(out_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


def annotate(name: str):
    """A named range inside a trace (``record_function``)."""
    return record_function(name)


class StepTimer:
    """Aggregating wall-clock timer for named phases.

    NOTE: CUDA launches are asynchronous, so host time around a launch
    measures the enqueue, not the kernel: time device work with
    ``newsreclib_tpu_torch.utils.timing.timeit_pipelined`` (or synchronise
    inside the phase); this timer is for host phases (batch assembly, ETL,
    logging).
    """

    def __init__(self):
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": round(self._totals[k], 4),
                "count": self._counts[k],
                "mean_ms": round(1e3 * self._totals[k] / max(self._counts[k], 1), 3),
            }
            for k in sorted(self._totals)
        }

    def log_summary(self) -> None:
        for name, row in self.summary().items():
            log.info(
                "phase %-24s total %.3fs  n=%d  mean %.2fms",
                name, row["total_s"], row["count"], row["mean_ms"],
            )
