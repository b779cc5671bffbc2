"""The collectives that XLA inserts under GSPMD in the JAX package, written
out explicitly for one process per device (``torch.distributed``).

Every collective here is an ``all_reduce`` or a ``broadcast``: those two are
what gloo takes on CUDA tensors, so the same code runs over NCCL (one rank
per card) and over gloo (CPU ranks, or ranks that share a card).  A gather
is an all-reduce of a zero-filled buffer into which each rank writes its own
slot (exact: each element is its value plus zeros).

* ``all_reduce_gradients``: the data group's gradient sum, coalesced into
  one flat buffer (the step calls the model through ``functional_call``, so
  DDP's reducer hooks would never fire);
* ``gather_rows`` / ``GatherRows``: the rows of every data rank in rank
  order; ``GatherRows`` carries gradients (backward: this rank's slot, as
  the loss on the gathered rows is the same on every rank), so a loss that
  compares rows of a batch (SupCon, the dual loss) or normalises over it
  (cross-entropy's valid count) sees the global batch;
* ``copy_to_group`` / ``reduce_from_group``: Megatron's conjugate pair for
  the tensor-parallel tower (identity forward and all-reduce backward, and
  the reverse);
* ``broadcast_value``: rank 0's float to every rank (the monitored metric);
* ``all_reduce_sums``: the float32 sum vector of an evaluation (metric
  sums, impression count, loss sum and weight) over the data group;
* ``all_gather_varlen``: every rank's 1-D vector of any length, in rank
  order (the corpus encode's rows, the AUC inputs, the export's rows): a
  first all-reduce carries the lengths, the vectors travel padded to the
  longest and come back cut to their own.  Low-precision floats travel as
  float32 and booleans as int32, both exactly.

``calls`` counts each collective by name, for the card checks.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

calls: Counter = Counter()


def reset_counts() -> None:
    calls.clear()


def all_reduce_(t: torch.Tensor, group, name: str) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    dist.all_reduce(t, group=group)
    calls[name] += 1
    return t


def gather_rows(t: torch.Tensor, group, size: int, index: int,
                name: str = "gather_rows") -> torch.Tensor:
    """``(size * n, ...)``: the ``(n, ...)`` rows of every rank of ``group``,
    in rank order (``index``: this rank's place in the group).  Booleans
    travel as int32."""
    if t.dtype == torch.bool:
        return gather_rows(t.to(torch.int32), group, size, index, name).bool()
    n = t.shape[0]
    buf = t.new_zeros((size * n, *t.shape[1:]))
    buf[index * n:(index + 1) * n] = t
    return all_reduce_(buf, group, name)


class GatherRows(torch.autograd.Function):
    """``gather_rows`` with a gradient: backward keeps this rank's slot of
    the output gradient.  Right when every rank computes the same function
    of the gathered rows (the global loss): the sum of the ranks' parameter
    gradients is then the gradient of that function."""

    @staticmethod
    def forward(ctx, t, group, size, index, name):
        ctx.slot = (index * t.shape[0], (index + 1) * t.shape[0])
        return gather_rows(t, group, size, index, name)

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.slot
        return grad[lo:hi], None, None, None, None


def gather_rows_with_grad(t: torch.Tensor, group, size: int, index: int,
                          name: str = "gather_scores") -> torch.Tensor:
    return GatherRows.apply(t, group, size, index, name)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group, "tp_all_reduce"), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group, "tp_all_reduce")

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``f``: identity forward, gradient summed over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's ``g``: sum over ``group`` forward, identity backward."""
    return _ReduceFromGroup.apply(x, group)


def all_reduce_gradients(params: Iterable[torch.Tensor], group) -> None:
    """Sum the gradients of ``params`` over ``group``, in one flat buffer per
    dtype.  Parameters without a gradient are left out (the same set on every
    rank: the ranks run the same graph)."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_(_flatten_dense_tensors(grads), group, "all_reduce_gradients")
        for g, s in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(s)


def broadcast_value(value: Optional[float], device, src: int = 0) -> float:
    """Rank ``src``'s ``value`` (None travels as NaN) on every rank of the
    default group.  A collective: every rank calls it."""
    t = torch.tensor([float("nan") if value is None else float(value)], dtype=torch.float64,
                     device=device)
    dist.broadcast(t, src=src)
    calls["broadcast"] += 1
    return float(t.item())


def all_reduce_sums(sums: torch.Tensor, group, name: str = "eval_sums") -> torch.Tensor:
    """The float32 vector ``sums`` summed over ``group``, out of place."""
    if sums.dtype != torch.float32 or sums.dim() != 1:
        raise ValueError(f"a float32 vector is summed, not {sums.dtype} of shape {sums.shape}")
    return all_reduce_(sums.clone(), group, name)


_WIRE = {torch.bfloat16: torch.float32, torch.float16: torch.float32, torch.bool: torch.int32}


def all_gather_varlen(t: torch.Tensor, group, size: int, index: int,
                      name: str) -> List[torch.Tensor]:
    """``[vector of rank 0, ..., vector of rank size - 1]`` of ``group``
    from this rank's 1-D ``t`` (``index``: its place in the group), each
    rank's of its own length.  Two all-reduces: the lengths, then a
    ``(size, longest)`` zero-filled buffer in which each rank fills its
    row; counted once under ``name``."""
    if t.dim() != 1:
        raise ValueError(f"a 1-D vector is gathered, not shape {tuple(t.shape)}")
    lengths = torch.zeros(size, dtype=torch.int64, device=t.device)
    lengths[index] = t.numel()
    dist.all_reduce(lengths, group=group)
    lens = lengths.tolist()
    wire = _WIRE.get(t.dtype, t.dtype)
    buf = torch.zeros((size, max(lens)), dtype=wire, device=t.device)
    if buf.numel():  # every rank sees the same lengths: all skip it or none
        buf[index, :t.numel()] = t.to(wire)
        dist.all_reduce(buf, group=group)
    calls[name] += 1
    return [buf[r, :n].to(t.dtype) for r, n in enumerate(lens)]
