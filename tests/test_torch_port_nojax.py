"""The port runs without JAX: the machine with the card has no jax, flax,
optax, pandas or yaml.  A subprocess blocks those imports and the JAX
package, then drives the serving slice on the CPU; the port's sources,
``chip_smoke.py`` and the card tests are also searched for such imports."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "pandas", "yaml", "newsreclib_tpu")

SCRIPT = """
import json, sys
for name in %r:
    sys.modules[name] = None  # any import of it now raises ImportError
import numpy as np
import torch
from newsreclib_tpu_torch.data.synthetic import make_serving_workload
from newsreclib_tpu_torch.models.general_rec import NRMS
from newsreclib_tpu_torch.serving import CachedScorer

store, imp = make_serving_workload(np.random.default_rng(0), corpus=300, n_impressions=40,
                                   hist_len=10, num_candidates=8, vocab_size=500)
model = NRMS(500, embed_dim=60, num_heads=6, query_dim=16, device="cpu",
             generator=torch.Generator().manual_seed(0))
metrics = CachedScorer(model, device="cpu").evaluate(store, imp, max_history_len=10,
                                                     target_cells=64, encode_batch=64)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r)
print(json.dumps({"metrics": metrics, "loaded": loaded}))
""" % (BLOCKED, BLOCKED)


def test_slice_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert {"auc", "mrr", "ndcg@10", "sent_pers@5"} <= set(out["metrics"])
    assert all(abs(v) < 10 for v in out["metrics"].values())


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(BLOCKED), re.M)
    files = sorted((ROOT / "newsreclib_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_port_gpu.py"]
    assert len(files) > 15
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result;
    alone in a directory, without the port, it fails as well."""
    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=where, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
