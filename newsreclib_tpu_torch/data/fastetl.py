"""ctypes bindings of the native host ETL library ``csrc/fastetl.cpp``
(counterpart of ``newsreclib_tpu/data/fastetl.py``): tokenizing texts
against a vocabulary and parsing behavior lines into padded id arrays.

The library is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first use
into ``build/host/libfastetl-<hash>.so`` under the checkout (``<hash>`` from
the source text and the flags: an edited source builds anew), never beside
the source.  Where no compiler is found or the build fails, every function
takes its pure-Python route, which gives the same arrays, and a warning says
so.  See the ``.cpp`` header for the tokenization contract (pre-lowercased
input, the reference regex's ASCII semantics).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("newsreclib_tpu_torch")

SRC_PATH = Path(__file__).resolve().parents[1] / "csrc" / "fastetl.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_tried = False


def library_path() -> Path:
    digest = hashlib.sha1(SRC_PATH.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfastetl-{digest}.so"


def _build_lib() -> Optional[Path]:
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".so.tmp{os.getpid()}")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(SRC_PATH), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)  # atomic: a reader never sees a half-written .so
        return target
    except (subprocess.SubprocessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        log.warning("fastetl: native build failed (%s); the host ETL takes its Python route", e)
        return None


def get_lib():
    """The loaded native library, built first if needed, or None (the
    Python route) where it cannot be built."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    path = _build_lib()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.fe_make_strmap.restype = ctypes.c_void_p
    lib.fe_make_strmap.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    lib.fe_free_strmap.argtypes = [ctypes.c_void_p]
    lib.fe_strmap_size.restype = ctypes.c_int64
    lib.fe_strmap_size.argtypes = [ctypes.c_void_p]
    for fname, extra in (
        ("fe_tokenize_ids", [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                             ctypes.POINTER(ctypes.c_int32)]),
        ("fe_parse_impressions", [ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int8), ctypes.c_int64,
                                  ctypes.POINTER(ctypes.c_int32)]),
        ("fe_parse_id_list", [ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                              ctypes.POINTER(ctypes.c_int32)]),
    ):
        f = getattr(lib, fname)
        f.restype = ctypes.c_int64
        f.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ] + extra
    _lib = lib
    return _lib


def _blob(strings: Sequence[str]) -> Tuple[bytes, np.ndarray]:
    encoded = [s.encode("utf-8") for s in strings]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class StrMap:
    """String -> int32 map (a vocabulary, ``nid2row``), held by the native
    library where it is built, else in Python."""

    def __init__(self, mapping: Dict[str, int]):
        self._py = mapping
        self._handle = None
        lib = get_lib()
        if lib is not None:
            blob, offsets = _blob(list(mapping.keys()))
            values = np.fromiter(mapping.values(), dtype=np.int32, count=len(mapping))
            self._handle = lib.fe_make_strmap(blob, _ptr(offsets, ctypes.c_int64),
                                              _ptr(values, ctypes.c_int32), len(mapping))
            self._lib = lib

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.fe_free_strmap(self._handle)

    @property
    def native(self) -> bool:
        return self._handle is not None


def tokenize_ids(texts: Sequence[str], vocab: StrMap, cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pre-lowercased texts -> ``(n, cap)`` int32 ids and ``(n,)`` lengths."""
    n = len(texts)
    out = np.zeros((n, cap), dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    if vocab.native:
        blob, offsets = _blob(texts)
        vocab._lib.fe_tokenize_ids(vocab._handle, blob, _ptr(offsets, ctypes.c_int64), n,
                                   _ptr(out, ctypes.c_int32), cap, _ptr(lens, ctypes.c_int32))
        return out, lens
    from newsreclib_tpu_torch.data.tokenize import word_tokenize

    for i, t in enumerate(texts):
        ids = [vocab._py.get(tok, 0) for tok in word_tokenize(t)][:cap]
        out[i, : len(ids)] = ids
        lens[i] = len(ids)
    return out, lens


def parse_impressions(lines: Sequence[str], nidmap: StrMap,
                      cap: int = 512) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``'N1-0 N2-1 ...'`` lines -> ``(n, cap)`` rows, ``(n, cap)`` labels,
    ``(n,)`` lengths; an unknown id maps to row 0."""
    n = len(lines)
    rows = np.zeros((n, cap), dtype=np.int32)
    labels = np.zeros((n, cap), dtype=np.int8)
    lens = np.zeros(n, dtype=np.int32)
    if nidmap.native:
        blob, offsets = _blob(lines)
        nidmap._lib.fe_parse_impressions(
            nidmap._handle, blob, _ptr(offsets, ctypes.c_int64), n, _ptr(rows, ctypes.c_int32),
            _ptr(labels, ctypes.c_int8), cap, _ptr(lens, ctypes.c_int32))
        return rows, labels, lens
    for i, line in enumerate(lines):
        c = 0
        for item in line.split():
            nid, _, lab = item.rpartition("-")
            if nid and lab and c < cap:
                rows[i, c] = nidmap._py.get(nid, 0)
                labels[i, c] = int(lab)
                c += 1
        lens[i] = c
    return rows, labels, lens


def parse_id_lists(lines: Sequence[str], nidmap: StrMap,
                   cap: int = 1024) -> Tuple[np.ndarray, np.ndarray]:
    """Space-separated id lines -> ``(n, cap)`` rows and ``(n,)`` lengths."""
    n = len(lines)
    rows = np.zeros((n, cap), dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    if nidmap.native:
        blob, offsets = _blob(lines)
        nidmap._lib.fe_parse_id_list(nidmap._handle, blob, _ptr(offsets, ctypes.c_int64), n,
                                     _ptr(rows, ctypes.c_int32), cap, _ptr(lens, ctypes.c_int32))
        return rows, lens
    for i, line in enumerate(lines):
        ids = [nidmap._py.get(x, 0) for x in line.split()][:cap]
        rows[i, : len(ids)] = ids
        lens[i] = len(ids)
    return rows, lens
