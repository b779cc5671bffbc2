"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/kernels/lib<name>-<hash>.so`` under the checkout,
where ``<hash>`` is taken from the source text: an edited source builds
anew, an unchanged one is loaded as it is.  No PyTorch header is included,
so one build takes seconds rather than the minutes of
``torch.utils.cpp_extension``.  ``build_all`` starts one nvcc per source,
all at once, and waits for them together.

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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

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
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str, src: Path = None, target: Path = None):
    """Start nvcc for one source unless its library is built; returns
    ``(target, tmp, process)`` or None."""
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
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, started) -> None:
    if started is None:
        return
    target, tmp, proc = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, target)  # atomic: a reader never sees a half-written .so


def build_all(names: Sequence[str]) -> None:
    """Compile every named source that is not built yet, in parallel."""
    started = [(n, _start(n)) for n in names]
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
