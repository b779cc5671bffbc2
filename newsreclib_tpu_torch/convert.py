"""Turn a JAX (flax) parameter tree into the port's ``state_dict``.

The tree holds numpy arrays (or anything ``np.asarray`` takes), e.g.
``jax.tree.map(np.asarray, params)`` of the JAX ``NRMS``.  Names map one to
one, joined with dots, except for the leaves:

  * a Dense ``kernel`` of shape (in, out) becomes ``weight`` of shape
    (out, in) (the port's ``Dense`` computes ``x W^T + b``);
  * an ``embedding`` table becomes ``weight``;
  * ``bias`` and the additive-attention ``query`` keep their names.

For NRMS this maps ``news_encoder/{embedding, mhsa/qkv, mhsa/out,
add_att/proj, add_att/query}`` and ``user_encoder/{mhsa/qkv, mhsa/out,
add_att/proj, add_att/query}``.  It is the inverse of the weight copy in
``tests/test_torch_parity.py::_copy_mha``.
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
