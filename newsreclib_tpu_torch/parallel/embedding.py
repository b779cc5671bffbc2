"""Row-sharded embedding lookup over the model group (counterpart of
``newsreclib_tpu/parallel/embedding.py::sharded_lookup``, ``:26-53``).

Each model rank holds a contiguous block of the table's rows (the last one
padded with zero rows when the vocabulary does not divide:
``parallel/mesh.py::shard_tensor``).  The forward gathers the ids this rank
owns, zeroes the others and sums the partial vectors over the group; the
backward sends the output gradient into the local rows only (the output is
the same on every rank of the group, so is its gradient: JAX's ``psum``
transposes to that under ``shard_map`` with a replicated output).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from newsreclib_tpu_torch.parallel.collectives import all_reduce_


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local_table, ids, lo, group):
        rows = local_table.shape[0]
        local = ids.long() - lo
        in_range = (local >= 0) & (local < rows)
        safe = torch.where(in_range, local, 0)
        out = F.embedding(safe, local_table) * in_range.unsqueeze(-1).to(local_table.dtype)
        ctx.save_for_backward(safe, in_range)
        ctx.table_shape = local_table.shape
        return all_reduce_(out, group, "sharded_lookup")

    @staticmethod
    def backward(ctx, grad):
        safe, in_range = ctx.saved_tensors
        d = grad.shape[-1]
        g = (grad * in_range.unsqueeze(-1).to(grad.dtype)).reshape(-1, d)
        table_grad = grad.new_zeros(ctx.table_shape).index_add_(0, safe.reshape(-1), g)
        return table_grad, None, None, None


def sharded_lookup(local_table: torch.Tensor, ids: torch.Tensor, lo: int, group) -> torch.Tensor:
    """``ids.shape + (dim,)`` vectors of a table whose rows ``lo ..
    lo + local_table.shape[0] - 1`` this rank holds, the same on every rank
    of ``group`` (a collective: every rank of the group calls it)."""
    return _ShardedLookup.apply(local_table, ids, lo, group)
