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
``user_encoder/{fc1, fc2}`` and ``click_predictor/{fc1, fc2}``.  It is the
inverse of the weight copy in ``tests/test_torch_parity.py::_copy_mha``.
"""

from __future__ import annotations

from typing import Dict, Mapping

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
