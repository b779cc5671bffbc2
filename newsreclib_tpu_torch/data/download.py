"""Download and extraction (counterpart of ``newsreclib_tpu/data/download.py``):
a retrying ``maybe_download`` over ``urllib.request`` from the standard
library, and ``extract`` for zip and tar archives.
"""

from __future__ import annotations

import os
import random
import shutil
import tarfile
import time
import urllib.request
import zipfile


def maybe_download(url: str, dst: str, attempts: int = 5) -> str:
    """Download ``url`` to ``dst`` with retries and backoff; nothing to do
    when ``dst`` exists.  Written to ``dst + ".part"`` and renamed."""
    if os.path.exists(dst):
        return dst
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    last_err = None
    for attempt in range(attempts):
        try:
            tmp = dst + ".part"
            with urllib.request.urlopen(url, timeout=60) as r, open(tmp, "wb") as f:
                shutil.copyfileobj(r, f, length=1 << 20)
            os.replace(tmp, dst)
            return dst
        except Exception as e:  # noqa: BLE001 (retry any transport error)
            last_err = e
            time.sleep(min(2**attempt + random.random(), 30))
    raise RuntimeError(f"download failed after {attempts} attempts: {url}") from last_err


def extract(archive: str, dst_dir: str) -> None:
    """Unpack a ``.zip``, ``.tar.gz``, ``.tgz`` or ``.tar`` into ``dst_dir``."""
    os.makedirs(dst_dir, exist_ok=True)
    if archive.endswith(".zip"):
        with zipfile.ZipFile(archive) as z:
            z.extractall(dst_dir)
    elif archive.endswith((".tar.gz", ".tgz", ".tar")):
        with tarfile.open(archive) as t:
            # the "data" filter refuses members that would land outside dst_dir
            t.extractall(dst_dir, filter="data")
    else:
        raise ValueError(f"unknown archive format: {archive}")
