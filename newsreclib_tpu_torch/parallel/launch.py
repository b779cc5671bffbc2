"""Start N local ranks with the ``spawn`` start method and wait for them.

    python -m newsreclib_tpu_torch.parallel.launch --nprocs 2 [--timeout S] \\
        newsreclib_tpu_torch.train trainer.distributed=true platform=cpu ...

runs ``TARGET`` in each of ``--nprocs`` processes with the variables
torchrun sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT`` on a free local port): a module runs as its ``main(args)``,
``module:function`` as ``function(*args)``.  ``spawn`` (not fork: a fork
after torch has started its threads can hang) is also how the training CLI
starts its ranks for ``trainer.devices=N`` (``spawn`` below).

Every wait has a deadline: when a rank fails, or ``timeout`` passes, every
rank still running is killed and the launcher raises, so a rank that dies
never leaves the others waiting in a collective.
"""

from __future__ import annotations

import argparse
import importlib
import multiprocessing as mp
import os
import queue
import socket
import sys
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank: int, world: int, port: int, args, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    try:
        value = fn(rank, world, *args)
    except BaseException:  # the parent reports it and stops the other ranks
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, value))


def _kill(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(5)


def spawn(fn: Callable, nprocs: int, args: Sequence[Any] = (),
          timeout: Optional[float] = None) -> List[Any]:
    """``[fn(rank, nprocs, *args) for each rank]``, each rank a ``spawn``
    process with the launcher's environment variables set (``fn`` and
    ``args`` must pickle; ``fn`` at a module's top level).  Raises, after
    killing every rank still running, when a rank fails or ``timeout``
    seconds pass."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(fn, r, nprocs, port, tuple(args), results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    out: dict = {}
    try:
        while len(out) < nprocs:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                failed = [p for p in procs if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {procs.index(failed[0])} exited with code "
                                       f"{failed[0].exitcode} and no result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks did not finish in {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(None if deadline is None else max(1.0, deadline - time.monotonic()))
    finally:
        _kill(procs)
    return [out[r] for r in range(nprocs)]


def _run_target(rank: int, world: int, target: str, argv: List[str]):
    module, _, function = target.partition(":")
    mod = importlib.import_module(module)
    if function:
        return getattr(mod, function)(*argv)
    mod.main(argv)
    return None


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nprocs", type=int, required=True)
    parser.add_argument("--timeout", type=float, default=None,
                        help="seconds before every rank is killed")
    parser.add_argument("target", help="a module (runs its main(args)) or module:function")
    parser.add_argument("args", nargs=argparse.REMAINDER)
    a = parser.parse_args(argv)
    spawn(_run_target, a.nprocs, (a.target, list(a.args)), timeout=a.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
