"""Check that the frozen PLM layers of a fine-tune are bit-identical to the
pretrained export and that the other layers moved (counterpart of
``benchmarks/plm_frozen_check.py``; the reference's freezing, ``text.py:70-73``):

    python -m newsreclib_tpu_torch.plm_frozen_check <run_dir>
        [--hf data/statfix/plm4_pretrained] [--frozen 0 1] [--which best]

It reads ``<run_dir>/checkpoints/<which>.pt`` (the port's training CLI
writes it) and the export (``load_hf_torch_weights``), prints the largest
change of each encoder layer, and exits 1 unless every layer of
``--frozen`` is unchanged and every other layer changed.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Mapping, Optional, Sequence

import torch

from newsreclib_tpu_torch.models.components.plm import load_hf_torch_weights
from newsreclib_tpu_torch.training.checkpoint import Checkpointer


def encoder_prefix(params: Mapping[str, torch.Tensor]) -> str:
    """The name prefix of the ``TransformerEncoder`` in a model's state dict
    (the one whose ``layer_0.q.weight`` it holds)."""
    hits = sorted(k[:-len("layer_0.q.weight")] for k in params
                  if k.endswith("layer_0.q.weight"))
    if not hits:
        raise ValueError("no TransformerEncoder in the checkpoint")
    return hits[0]


def layer_deltas(params: Mapping[str, torch.Tensor], export: Mapping[str, torch.Tensor],
                 num_layers: int) -> Dict[int, float]:
    """``{layer: largest |fine-tuned - exported|}`` over each layer's tensors."""
    prefix = encoder_prefix(params)
    out = {}
    for i in range(num_layers):
        names = [k for k in export if k.startswith(f"layer_{i}.")]
        out[i] = max(float((params[prefix + k].float().cpu() - export[k]).abs().max())
                     for k in names)
    return out


def check(run_dir: str, hf: str, frozen: Sequence[int], which: str = "best",
          log=print) -> bool:
    export, kwargs = load_hf_torch_weights(hf)
    params = Checkpointer(os.path.join(run_dir, "checkpoints")).restore_params(which)
    ok = True
    for i, delta in layer_deltas(params, export, kwargs["num_layers"]).items():
        is_frozen = i in frozen
        want = delta == 0.0 if is_frozen else delta > 0.0
        ok &= want
        log(f"layer_{i} [{'FROZEN' if is_frozen else 'train'}]: max|delta| = {delta:.3e} "
            f"{'OK' if want else 'VIOLATION'}")
    log(f"frozen-layer check: {'PASS' if ok else 'FAIL'}")
    return ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("run_dir")
    ap.add_argument("--hf", default="data/statfix/plm4_pretrained")
    ap.add_argument("--frozen", type=int, nargs="*", default=[0, 1])
    ap.add_argument("--which", default="best")
    a = ap.parse_args(argv)
    return 0 if check(a.run_dir, a.hf, a.frozen, a.which) else 1


if __name__ == "__main__":
    sys.exit(main())
