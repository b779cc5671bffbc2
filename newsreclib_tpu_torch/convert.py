"""Turn a JAX (flax) parameter tree into the port's ``state_dict``.

The tree holds numpy arrays (or anything ``np.asarray`` takes), e.g.
``jax.tree.map(np.asarray, params)`` of the JAX ``NRMS``.  Names map one to
one, joined with dots, except for the leaves:

  * a ``kernel`` becomes ``weight``, transposed with its axes reversed: a
    Dense kernel (in, out) becomes (out, in) (the port's ``Dense`` computes
    ``x W^T + b``), a Conv kernel (W, in, out) becomes torch's (out, in, W),
    KCNN's 4-D ``conv_w{w}`` kernel (w, D, channels, F) becomes
    (F, channels, D, w);
  * an ``embedding`` table becomes ``weight``;
  * every other leaf keeps its name: ``bias``, the additive-attention
    ``query``, MINER's ``context_codes``, LSTUR's
    ``long_term_user_embedding`` and NPA's ``user_embed``.

The port's modules carry the JAX package's names, so no tree needs more:
for NRMS ``news_encoder/{embedding, mhsa/qkv, mhsa/out, add_att/proj,
add_att/query}`` and ``user_encoder/{mhsa/..., add_att/...}``; the GRU cell
``gru/GRUCell_0/{ir, iz, in, hr, hz, hn}`` (``hr``, ``hz`` without bias);
CenNewsRec's ``cnn``; the news encoders' ``text_encoder``,
``category_encoder/{embedding, linear}``, ``entity_encoder``,
``combine_add_att`` and ``combine_linear``; CAUM's ``linear1..3`` and
``dense_att/fc1..fc3``; TANR's ``news_encoder/{embedding, cnn, add_att}``
and ``topic_predictor``; LSTUR's ``user_encoder/{long_term_user_embedding,
gru}``; NPA's ``user_projection/user_embed``, ``text_encoder/{embedding,
cnn, pers_att/query_proj}`` and ``user_encoder/{news_query_proj/proj,
pers_att}``; MINER's ``text_encoder``, ``reduce_dim``,
``categ_encoder/embedding``, ``user_encoder/{proj, context_codes}`` and
``target_aware_attn/proj``; DKN's ``news_encoder/{word_emb, entity_emb,
entity_transform, context_emb, context_transform, conv_w1..conv_w4}``,
``user_encoder/{fc1, fc2}`` and ``click_predictor/{fc1, fc2}``; SentiRec's
``sent_predictor``; SentiDebias's generator ``news_encoder``,
``sentiment_encoder/{embedding, linear}`` and ``user_encoder`` and its
discriminator ``linear1`` / ``linear2`` (two trees, one per network);
MANNeR's ``news_encoder/{text_encoder, entity_encoder, combine_linear}``
(CR module and A-module) and the ensemble's ``cr`` and
``aspect_towers_<i>``.  It is the inverse of the weight copy in
``tests/test_torch_parity.py::_copy_mha``.

``shard_state_dict`` gives one rank's shard of such a state dict on a
``(data, model)`` grid (``parallel/mesh.py``), ``unshard_state_dict`` the
full state dict back from a model group's shards: the multi-rank tests
start the port's ranks from the JAX parameters with them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def flax_to_state_dict(params: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for name, value in params.items():
        if isinstance(value, Mapping):
            out.update(flax_to_state_dict(value, f"{prefix}{name}."))
            continue
        arr = np.asarray(value, dtype=np.float32)
        if name == "kernel":
            name, arr = "weight", arr.T
        elif name == "embedding":
            name = "weight"
        out[prefix + name] = torch.tensor(arr)
    return out


def shard_state_dict(sd: Mapping[str, torch.Tensor], rank: int, world: int, model_axis: int = 1,
                     tp_transformer: bool = False,
                     row_shard_embeddings: bool = True) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard of a full state dict ``sd`` on a ``world``-rank
    grid with ``model_axis`` model ranks (``parallel/mesh.py``'s rule:
    the embedding tables' rows, with ``tp_transformer`` the PLM tower's
    column- and row-parallel weights; the last block padded with zeros)."""
    from newsreclib_tpu_torch.parallel.mesh import shard_specs, shard_tensor

    if world % model_axis:
        raise ValueError(f"world size {world} is not divisible by model_axis {model_axis}")
    specs = shard_specs({k: tuple(v.shape) for k, v in sd.items()}, model_axis,
                        row_shard_embeddings, tp_transformer)
    j = rank % model_axis
    return {k: shard_tensor(v, specs[k], model_axis, j) if k in specs else v
            for k, v in sd.items()}


def unshard_state_dict(shards, full_shapes: Mapping[str, Tuple[int, ...]], model_axis: int = 1,
                       tp_transformer: bool = False,
                       row_shard_embeddings: bool = True) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_state_dict``: the full state dict from the
    shards of the first ``model_axis`` ranks (one model group, in rank
    order), the padding stripped; ``full_shapes`` gives each tensor's full
    shape."""
    from newsreclib_tpu_torch.parallel.mesh import shard_specs

    specs = shard_specs(dict(full_shapes), model_axis, row_shard_embeddings, tp_transformer)
    out = {}
    for k, shape in full_shapes.items():
        if k in specs:
            dim = specs[k]
            out[k] = torch.cat([s[k] for s in shards[:model_axis]], dim=dim).narrow(
                dim, 0, shape[dim]).contiguous()
        else:
            out[k] = shards[0][k]
    return out
