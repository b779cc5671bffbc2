"""Small math shared by the model blocks (counterpart of
``newsreclib_tpu/models/components/utils.py``)."""

from __future__ import annotations

import torch


def pairwise_cosine_similarity(x: torch.Tensor, y: torch.Tensor,
                               zero_diagonal: bool = False) -> torch.Tensor:
    """x (B, M, D), y (B, N, D) -> (B, M, N) cosine similarities; with
    ``zero_diagonal`` (M == N) the diagonal is 0 (MINER's disagreement
    term).  The norm's square is clamped at 1e-16 before the root, so zero
    vectors (padded articles) normalise to zero and the gradient stays
    finite."""

    def normalize(v):
        return v / torch.sqrt((v * v).sum(dim=-1, keepdim=True).clamp_min(1e-16))

    sim = normalize(x) @ normalize(y).transpose(-1, -2)
    if zero_diagonal:
        if x.shape[-2] != y.shape[-2]:
            raise ValueError(f"zero_diagonal needs square blocks, got {x.shape[-2]} x "
                             f"{y.shape[-2]}")
        eye = torch.eye(x.shape[-2], dtype=torch.bool, device=sim.device)
        sim = torch.where(eye, 0.0, sim)
    return sim
