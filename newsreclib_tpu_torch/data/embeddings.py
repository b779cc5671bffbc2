"""Pretrained embedding matrices (a copy of
``newsreclib_tpu/data/embeddings.py``): GloVe word vectors and MIND's
``entity_embedding.vec``, with random-normal rows for tokens the file does
not hold and the all-zero padding row 0.  The word is the first
space-separated field of a GloVe line (the reference reads only its first
character).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def build_embedding_matrix(
    token2index: Dict[str, int],
    embeddings_fpath: str,
    embed_dim: int,
    seed: int = 0,
    out_fpath: Optional[str] = None,
) -> np.ndarray:
    """(len+1, embed_dim) matrix: pretrained rows where available, else
    random-normal; row 0 zero."""
    rng = np.random.default_rng(seed)
    matrix = rng.normal(size=(len(token2index) + 1, embed_dim)).astype(np.float32)
    matrix[0] = 0.0
    hit = 0
    with open(embeddings_fpath, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            if len(parts) < embed_dim + 1:
                continue
            word = parts[0]
            idx = token2index.get(word)
            if idx is not None:
                matrix[idx] = np.asarray(parts[-embed_dim:], dtype=np.float32)
                hit += 1
    if out_fpath:
        os.makedirs(os.path.dirname(out_fpath), exist_ok=True)
        np.save(out_fpath, matrix)
    return matrix


def build_entity_embedding_matrix(
    entity2index: Dict[str, int],
    entity_vec_fpath: str,
    embed_dim: int = 100,
    seed: int = 0,
    out_fpath: Optional[str] = None,
) -> np.ndarray:
    """Entity matrix from MIND's TSV ``entity_embedding.vec`` (WikidataId +
    100 floats per line)."""
    rng = np.random.default_rng(seed)
    matrix = rng.normal(size=(len(entity2index) + 1, embed_dim)).astype(np.float32)
    matrix[0] = 0.0
    with open(entity_vec_fpath, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split("\t")
            if len(parts) < embed_dim + 1:
                continue
            idx = entity2index.get(parts[0])
            if idx is not None:
                matrix[idx] = np.asarray(parts[1 : embed_dim + 1], dtype=np.float32)
    if out_fpath:
        os.makedirs(os.path.dirname(out_fpath), exist_ok=True)
        np.save(out_fpath, matrix)
    return matrix
