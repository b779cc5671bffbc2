"""Process groups, the rank grid and the sharding of a train state
(counterpart of ``newsreclib_tpu/parallel/mesh.py``).

JAX drives every chip of a host from one process through a ``Mesh``; here
each device is one process (``torch.distributed``), and ``Mesh`` holds this
rank's place in the same ``(data, model)`` grid as ``make_mesh``
(``mesh.py:19-29``): rank ``r`` is data index ``r // model_axis`` and model
index ``r % model_axis``.  One process group spans each data row (the model
group: the ranks that hold one batch slice and split the sharded
parameters) and one each model column (the data group: the ranks that hold
the same shards and sum their gradients).

The sharding rule is ``_leaf_spec`` (``mesh.py:44-69``) on the port's
``named_parameters`` names:

* 2-D ``*embedding.weight`` tables (the JAX ``*embedding/embedding``) are
  row-sharded over the model group when ``row_shard_embeddings`` and the
  model axis is above 1; a vocabulary that does not divide is padded with
  zero rows (GSPMD pads ``P("model", None)`` the same way) and the gather
  strips the padding;
* with ``tp_transformer``, the PLM tower's ``layer_<i>`` q / k / v / ff1
  weights and biases are column-parallel (each rank a contiguous block of
  heads or hidden units: rows of torch's ``(out, in)`` weight) and
  attn_out / ff2 weights row-parallel (columns of the torch weight).

``place_state`` cuts a full state (the same on every rank: the same seed
builds the same model) and its Adam moments down to this rank's shards (the
moments shard like their parameters, ``mesh.py:114-140``) and installs the
lookup and tensor-parallel hooks in the modules; ``gather_state`` is its
inverse (``Trainer._gather_global``), a collective; ``load_full_state`` cuts
a full checkpoint back to the shards (``Trainer._replace_state``).
``shard_batch`` gives this rank's rows of a global batch (``mesh.py:143-187``:
the rows are split over the data axis, the news tables stay whole).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

# JAX's _TP_COL / _TP_COL_BIAS / _TP_ROW in the port's names and layout
_TP_COL = (".q.weight", ".k.weight", ".v.weight", ".ff1.weight")
_TP_COL_BIAS = (".q.bias", ".k.bias", ".v.bias", ".ff1.bias")
_TP_ROW = (".attn_out.weight", ".ff2.weight")
TIMEOUT_S = 1800  # a collective's wait: outlasts an evaluation on rank 0


@dataclass
class Mesh:
    """This rank's place in the ``(data, model)`` grid and its groups.

    ``replicated_batches``: every rank holds the same global batch and keeps
    its rows (single-node mode, ``trainer.devices=N``); otherwise each data
    rank holds only its own rows (multi-host mode, ``trainer.distributed``).
    """

    rank: int
    world: int
    model_axis: int
    device: torch.device
    backend: str
    data_group: Any
    model_group: Any
    replicated_batches: bool = True

    @property
    def data_size(self) -> int:
        return self.world // self.model_axis

    @property
    def data_index(self) -> int:
        return self.rank // self.model_axis

    @property
    def model_index(self) -> int:
        return self.rank % self.model_axis


def rank_device(platform: str, local_rank: int) -> torch.device:
    """``cuda:<local_rank>`` (made the current card) or the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; run with platform=cpu")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local_rank} has no card: "
                           f"{torch.cuda.device_count()} visible")
    device = torch.device("cuda", local_rank)
    torch.cuda.set_device(device)
    return device


def init_mesh(rank: int, world: int, model_axis: int = 1, device: Optional[torch.device] = None,
              backend: Optional[str] = None, init_method: Optional[str] = None,
              replicated_batches: bool = True) -> Mesh:
    """Join the default process group (unless joined) and build the grid's
    groups.  ``backend``: NCCL on the card, gloo on the CPU by default (gloo
    also runs ranks that share one card); ``init_method`` default
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).  Every rank calls it."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if world % model_axis:
        raise ValueError(f"world size {world} is not divisible by model_axis {model_axis}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    m = model_axis
    data_size = world // m
    model_group = data_group = None
    # every rank creates every group, in the same order
    for i in range(data_size):
        g = dist.new_group([i * m + j for j in range(m)])
        if rank // m == i:
            model_group = g
    for j in range(m):
        g = dist.new_group([i * m + j for i in range(data_size)])
        if rank % m == j:
            data_group = g
    return Mesh(rank, world, m, device, dist.get_backend(), data_group, model_group,
                replicated_batches)


def env_rank() -> Optional[Tuple[int, int, int]]:
    """``(RANK, WORLD_SIZE, LOCAL_RANK)`` when a launcher (torchrun, or
    ``parallel/launch.py``) set them, else None."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    rank = int(os.environ["RANK"])
    return rank, int(os.environ["WORLD_SIZE"]), int(os.environ.get("LOCAL_RANK", rank))


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------- sharding rule ----------------


def _leaf_spec(name: str, ndim: int, want_rows: bool, want_tp: bool) -> Optional[int]:
    """The dimension of parameter ``name`` split over the model group (in
    torch's layout), or None when it is replicated."""
    if want_rows and ndim == 2 and name.endswith("embedding.weight"):
        return 0
    if want_tp and "layer_" in name:
        if ndim == 2 and name.endswith(_TP_COL):
            return 0
        if ndim == 1 and name.endswith(_TP_COL_BIAS):
            return 0
        if ndim == 2 and name.endswith(_TP_ROW):
            return 1
    return None


def shard_specs(shapes: Dict[str, Tuple[int, ...]], model_axis: int,
                row_shard_embeddings: bool = True,
                tp_transformer: bool = False) -> Dict[str, int]:
    """``{name: sharded dimension}`` of the parameters (by name and shape)
    that ``_leaf_spec`` splits at this model axis."""
    big = model_axis > 1
    out = {}
    for name, shape in shapes.items():
        dim = _leaf_spec(name, len(shape), row_shard_embeddings and big, tp_transformer and big)
        if dim is not None:
            out[name] = dim
    return out


def shard_tensor(full: torch.Tensor, dim: int, size: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``size`` of ``full`` along ``dim``, the last block
    padded with zeros when ``size`` does not divide the dimension."""
    n = full.shape[dim]
    per = -(-n // size)
    if per * size != n:
        pad = list(full.shape)
        pad[dim] = per * size - n
        full = torch.cat([full, full.new_zeros(pad)], dim=dim)
    return full.narrow(dim, index * per, per).clone()


def unshard_tensor(local: torch.Tensor, dim: int, full_size: int, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every model rank's block (a collective over the
    model group), the padding stripped."""
    from newsreclib_tpu_torch.parallel.collectives import gather_rows

    moved = local.transpose(0, dim).contiguous() if dim else local
    full = gather_rows(moved, mesh.model_group, mesh.model_axis, mesh.model_index,
                       "gather_state")
    full = full.transpose(0, dim) if dim else full
    return full.narrow(dim, 0, full_size).contiguous()


@dataclass
class RowShard:
    """The lookup hook of a row-sharded table: ``lo`` is this rank's first
    row (``parallel/embedding.py::sharded_lookup``)."""

    group: Any
    lo: int

    def __deepcopy__(self, memo):  # a copied model shares the process group
        return self


@dataclass
class TensorParallel:
    """The tensor-parallel hook of a tower layer: its model group, its size
    and this rank's place in it."""

    group: Any
    size: int
    index: int

    def __deepcopy__(self, memo):
        return self


def place_state(state, mesh: Mesh, row_shard_embeddings: bool = True,
                tp_transformer: bool = False):
    """Cut ``state`` (a ``TrainState`` whose model holds the full parameters,
    the same on every rank) to this rank's shards, in place: sharded
    parameters keep their ``Parameter`` objects (the optimizer keeps them)
    with the local block as data, Adam's moments are cut the same way, the
    embedding tables get their lookup hook and the tower's layers their
    tensor-parallel hook.  Sets ``state.grid`` and ``state.sharded``
    (``{name: (dim, full size)}``).  Placing a placed state does nothing."""
    from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding
    from newsreclib_tpu_torch.models.components.plm import TransformerLayer

    if state.grid is not None:
        return state
    model = state.model
    specs = shard_specs({n: tuple(p.shape) for n, p in model.named_parameters()},
                        mesh.model_axis, row_shard_embeddings, tp_transformer)
    modules = dict(model.named_modules())
    m, j = mesh.model_axis, mesh.model_index
    params = dict(model.named_parameters())
    for name, dim in specs.items():  # refuse before anything is cut
        p = params[name]
        owner_name = name.rsplit(".", 1)[0]
        owner = modules[owner_name]
        if name.endswith("embedding.weight") and not isinstance(owner, TokenEmbedding):
            raise NotImplementedError(f"{name}: row sharding takes TokenEmbedding tables only")
        if "layer_" in name and not name.endswith("embedding.weight"):
            layer = modules[owner_name.rsplit(".", 1)[0]]
            if not isinstance(layer, TransformerLayer):
                raise NotImplementedError(f"{name}: tensor parallelism takes the PLM tower only")
            if layer.num_heads % m or p.shape[dim] % m:
                raise ValueError(f"{name}: {layer.num_heads} heads / {p.shape[dim]} features "
                                 f"do not split over {m} model ranks")
    sharded = {}
    for name, dim in specs.items():
        p = params[name]
        full = p.shape[dim]
        with torch.no_grad():
            p.data = shard_tensor(p.data, dim, m, j)
        moments = state.opt.state.get(p, {})
        for k, v in list(moments.items()):
            if torch.is_tensor(v) and v.dim() and v.shape[dim] == full:
                moments[k] = shard_tensor(v, dim, m, j)
        sharded[name] = (dim, full)
    for name, mod in modules.items():
        prefix = f"{name}." if name else ""
        if isinstance(mod, TokenEmbedding) and f"{prefix}weight" in sharded:
            mod.shard = RowShard(mesh.model_group, j * mod.weight.shape[0])
        if isinstance(mod, TransformerLayer) and f"{prefix}q.weight" in sharded:
            mod.tp = TensorParallel(mesh.model_group, m, j)
    state.grid = mesh
    state.sharded = sharded
    return state


def _param_names(state) -> list:
    """The names of the optimizer's parameters, in its state-dict order."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.opt.param_groups for p in g["params"]]


def gather_state(state, with_opt: bool = True) -> Dict[str, Any]:
    """``{"params", "opt_state", "step"}``: the full state of a sharded
    ``state`` in the one-device checkpoint format (the model's state dict,
    the optimizer's state dict with full moments; ``with_opt=False``: the
    parameters alone, ``opt_state`` None).  A collective over the model
    group when anything is sharded: every rank calls it."""
    sd = dict(state.model.state_dict())
    if state.sharded:
        for name, (dim, full) in state.sharded.items():
            sd[name] = unshard_tensor(sd[name], dim, full, state.grid)
    if not with_opt:
        return {"params": sd, "opt_state": None, "step": state.step}
    osd = state.opt.state_dict()
    if state.sharded:
        mesh = state.grid
        opt_state = {}
        names = _param_names(state)
        for i, s in osd["state"].items():
            s = dict(s)
            if names[i] in state.sharded:
                dim, full = state.sharded[names[i]]
                for k, v in s.items():
                    if torch.is_tensor(v) and v.dim():
                        s[k] = unshard_tensor(v, dim, full, mesh)
            opt_state[i] = s
        osd = {"state": opt_state, "param_groups": osd["param_groups"]}
    return {"params": sd, "opt_state": osd, "step": state.step}


def load_full_state(state, tree: Dict[str, Any]) -> None:
    """Load a full checkpoint ``tree`` (``gather_state``'s format, or a
    one-device run's) into a sharded ``state``: each sharded tensor and its
    moments cut to this rank's block."""
    mesh = state.grid
    m, j = mesh.model_axis, mesh.model_index
    sd = dict(tree["params"])
    for name, (dim, _) in state.sharded.items():
        sd[name] = shard_tensor(sd[name], dim, m, j)
    state.model.load_state_dict(sd)
    osd = tree["opt_state"]
    names = _param_names(state)
    opt_state = {}
    for i, s in osd["state"].items():
        s = dict(s)
        if names[int(i)] in state.sharded:
            dim, _ = state.sharded[names[int(i)]]
            for k, v in s.items():
                if torch.is_tensor(v) and v.dim():
                    s[k] = shard_tensor(v, dim, m, j)
        opt_state[i] = s
    state.opt.load_state_dict({"state": opt_state, "param_groups": osd["param_groups"]})
    state.step = int(tree["step"])


def shard_batch(batch, mesh: Mesh):
    """This data rank's contiguous rows of a global batch (numpy arrays or
    tensors); the news tables (``news``, ``news2``) stay whole, so the
    indices stay valid."""
    n, i = mesh.data_size, mesh.data_index
    b = batch.hist_idx.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} rows not divisible by the data axis {n}")
    lo, hi = i * b // n, (i + 1) * b // n
    return type(batch)(**{k: v if k in ("news", "news2") or v is None else v[lo:hi]
                          for k, v in batch._asdict().items()})


def gather_batch(batch, mesh: Mesh):
    """The global batch from every data rank's rows (multi-host mode, a
    global-row batch on the device): the inverse of ``shard_batch``."""
    from newsreclib_tpu_torch.parallel.collectives import gather_rows

    return type(batch)(**{
        k: v if k in ("news", "news2") or v is None else
        gather_rows(v, mesh.data_group, mesh.data_size, mesh.data_index, "gather_batch")
        for k, v in batch._asdict().items()})
