"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/lib<name>-<hash>.so`` under the checkout,
where ``<hash>`` is taken from the source text: an edited source builds
anew, an unchanged one is loaded as it is.  No PyTorch header is included,
so one build takes seconds rather than the minutes of
``torch.utils.cpp_extension``.  ``build_all`` starts one nvcc per source,
all at once, and waits for them together.  A source named in ``PARTS``
compiles as that many parts at once (nvcc ``-c`` with ``NRL_PART`` set to
1, 2, ...; the source decides what each part holds) and is linked into its
one library: ``csrc/mhsa.cu`` builds in six parts (its hd <= 32 forward
and f32 backward instances and entry points, its wide bf16 and wide f32
instances, its long ones, its hd <= 32 bf16 backward ones in two) in about
half the time of one whole compilation.

Nothing here runs at import time, so the port imports on a machine
without nvcc: a kernel is built when it is first launched on a CUDA tensor,
or when ``build_all`` is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
NVCC_FLAGS = COMPILE_FLAGS + ("-shared",)
# Sources built in parts (the number of parts): see the module doc.
PARTS = {"mhsa": 6}

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed by the source's hash)."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = " ".join(NVCC_FLAGS) + f" parts={PARTS.get(name, 0)}"
    digest = hashlib.sha1(src + key.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _popen(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _start(name: str, src: Path = None, target: Path = None, parts: int = 0):
    """Start nvcc for one source unless its library is built (one process,
    or one a part with ``parts``); returns ``(target, tmp, processes,
    objects)`` or None."""
    src = CSRC / f"{name}.cu" if src is None else src
    target = library_path(name) if target is None else target
    if target.exists():
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stale_lock = BUILD_DIR / "lock"
    if stale_lock.exists():
        stale_lock.unlink()
    tmp = target.with_suffix(f".so.tmp{os.getpid()}")
    if not parts:
        return target, tmp, [_popen([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)])], []
    # nvcc links a file as an object only by its ".o" suffix
    objects = [target.with_suffix(f".part{k}.{os.getpid()}.o") for k in range(1, parts + 1)]
    procs = [_popen([nvcc, *COMPILE_FLAGS, "-c", f"-DNRL_PART={k}", "-o", str(obj), str(src)])
             for k, obj in enumerate(objects, start=1)]
    return target, tmp, procs, objects


def _finish(name: str, started) -> None:
    if started is None:
        return
    target, tmp, procs, objects = started
    try:
        logs = [proc.communicate()[0] for proc in procs]
        failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
        if not failed and objects:
            link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objects)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                failed.append(link.stdout + link.stderr)
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n" + "\n".join(failed))
        os.replace(tmp, target)  # atomic: a reader never sees a half-written .so
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)


def build_all(names: Sequence[str]) -> None:
    """Compile every named source that is not built yet, in parallel."""
    started = [(n, _start(n, parts=PARTS.get(n, 0))) for n in names]
    errors = []
    for n, s in started:
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


def load_source(src: Path) -> ctypes.CDLL:
    """Build and load a CUDA source from outside ``csrc/`` (for instance an
    earlier version of a kernel, to time against), keyed by its text, into
    ``build/kernels/extra/``."""
    src = Path(src)
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    target = BUILD_DIR / "extra" / f"lib{src.stem}-{digest}.so"
    target.parent.mkdir(parents=True, exist_ok=True)
    _finish(src.stem, _start(src.stem, src, target))
    return ctypes.CDLL(str(target))
