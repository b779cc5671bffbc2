"""The port runs without JAX: the machine with the card has no jax, flax,
optax, orbax, pandas or yaml.  A subprocess blocks those imports and the JAX
package, then drives the serving slice and two training steps on the CPU;
others build MINS, CenNewsRec and CAUM, NAML, TANR, LSTUR, NPA, MINER and
DKN, and SentiRec and MANNeR's CR module, and train each a step, and drive
SentiDebias's alternating step, an A-module step and MANNeR's ensemble;
another runs the training CLI (config composition, ETL, fit, checkpoints,
test) on a copy of the raw demo files.
The port's sources, ``chip_smoke.py``
and the card tests are also searched for such imports."""

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

from newsreclib_tpu_torch.data.batch import to_device
from newsreclib_tpu_torch.data.batching import TrainBatcher
from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
from newsreclib_tpu_torch.training.steps import make_train_step

state = create_train_state(model, make_optimizer(1e-3, scheduler="cosine", warmup_steps=1,
                                                 total_steps=4, grad_clip_norm=1.0))
step = make_train_step(cross_entropy_loss, compute_dtype="bfloat16")
batches = TrainBatcher(store, imp, batch_size=8, max_history_len=10, u_bucket_min=64,
                       split_title_len=16).epoch(0)
train_losses = [step(state, to_device(next(batches), "cpu"))[1]["loss"].item()
                for _ in range(2)]
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r)
print(json.dumps({"metrics": metrics, "train_losses": train_losses, "loaded": loaded}))
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
    assert len(out["train_losses"]) == 2
    assert all(0 < v < 10 for v in out["train_losses"])


CLI_SCRIPT = """
import json, sys
for name in %r:
    sys.modules[name] = None  # any import of it now raises ImportError
from newsreclib_tpu_torch.train import main
metrics = main(sys.argv[1:])
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r)
print(json.dumps({"metrics": metrics, "loaded": loaded}))
""" % (BLOCKED, BLOCKED)


def test_cli_runs_with_jax_pandas_and_yaml_blocked(tmp_path):
    data = tmp_path / "data"
    for split in ("train", "dev"):
        d = data / f"MINDdemo_{split}"
        d.mkdir(parents=True)
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            (d / name).write_bytes((ROOT / "data" / "demo" / d.name / name).read_bytes())
    args = ["experiment=nrms_demo", "platform=cpu", f"data.data_dir={data}",
            f"data.word_embeddings_fpath={ROOT / 'data' / 'demo' / 'glove_demo.txt'}",
            f"output_dir={tmp_path / 'run'}", "trainer.limit_train_batches=3"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", CLI_SCRIPT, *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert {"val/loss", "val/auc", "test/auc", "test/loss"} <= set(out["metrics"])
    assert (tmp_path / "run" / "checkpoints" / "best.pt").exists()
    assert (tmp_path / "run" / "metrics.csv").exists()


ZOO_SCRIPT = """
import json, sys
for name in %r:
    sys.modules[name] = None  # any import of it now raises ImportError
import numpy as np
from newsreclib_tpu_torch.data.batch import to_device
from newsreclib_tpu_torch.data.batching import TrainBatcher
from newsreclib_tpu_torch.data.synthetic import make_serving_workload
from newsreclib_tpu_torch.models import factory
from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
from newsreclib_tpu_torch.training.steps import make_train_step

store, imp = make_serving_workload(np.random.default_rng(0), corpus=200, n_impressions=30,
                                   hist_len=10, num_candidates=6, vocab_size=500)
info = factory.DataInfo(vocab_size=500, entity_vocab_size=800, num_subcategories=50,
                        num_users=1000)
losses = {}
for name in sys.argv[1:]:
    model = factory.build_model({"name": name}, info, device="cpu")
    state = create_train_state(model, make_optimizer(1e-3))
    batch = next(TrainBatcher(store, imp, batch_size=4, max_history_len=10, u_bucket_min=64,
                              split_title_len=16).epoch(0))
    losses[name] = make_train_step(cross_entropy_loss)(state, to_device(batch, "cpu"))[1][
        "loss"].item()
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r)
print(json.dumps({"losses": losses, "loaded": loaded}))
""" % (BLOCKED, BLOCKED)


def _train_zoo_blocked(names):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", ZOO_SCRIPT, *names], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert sorted(out["losses"]) == sorted(names)
    assert all(0 < v < 10 for v in out["losses"].values())


def test_zoo_models_train_with_jax_blocked():
    """MINS, CenNewsRec and CAUM from the factory at their default widths,
    one train step each, with JAX, flax, pandas, yaml and the JAX package
    blocked."""
    _train_zoo_blocked(["mins", "cen_news_rec", "caum"])


def test_glove_zoo_models_train_with_jax_blocked():
    """NAML, TANR, LSTUR, NPA, MINER and DKN, the same way."""
    _train_zoo_blocked(["naml", "tanr", "lstur", "npa", "miner", "dkn"])


def test_fair_rec_models_train_with_jax_blocked():
    """SentiRec and MANNeR's CR module from ``build_model``, the same way."""
    _train_zoo_blocked(["sentirec", "manner_cr"])


FAIR_SCRIPT = """
import json, sys
for name in %r:
    sys.modules[name] = None  # any import of it now raises ImportError
import numpy as np
import newsreclib_tpu_torch.eval
from newsreclib_tpu_torch.data.batch import to_device
from newsreclib_tpu_torch.data.batching import TrainBatcher
from newsreclib_tpu_torch.data.news_batching import MPerClassNewsBatcher
from newsreclib_tpu_torch.data.statfix import write_mind_small_statfix_v2
from newsreclib_tpu_torch.data.synthetic import make_serving_workload
from newsreclib_tpu_torch.models import factory
from newsreclib_tpu_torch.models.fair_rec import (create_sentidebias_state, evaluate_ensemble,
                                                  make_sentidebias_train_step)
from newsreclib_tpu_torch.training.adversarial import AdversarialTrainer
from newsreclib_tpu_torch.training.aspect import make_aspect_train_step
from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer

store, imp = make_serving_workload(np.random.default_rng(0), corpus=200, n_impressions=30,
                                   hist_len=10, num_candidates=6, vocab_size=500)
info = factory.DataInfo(vocab_size=500, entity_vocab_size=800)
small = {"embed_dim": 60, "text_embed_dim": 60, "num_heads": 6, "query_dim": 16}
gen, disc = factory.build_senti_debias(small, info, device="cpu")
state = create_sentidebias_state(gen, disc, g_lr=1e-3, d_lr=1e-3)
batch = next(TrainBatcher(store, imp, batch_size=4, max_history_len=10, u_bucket_min=64,
                          split_title_len=16).epoch(0))
sd = make_sentidebias_train_step()(state, to_device(batch, "cpu"))[1]
a_model = factory.build_manner_a(small, info, device="cpu")
a_state = create_train_state(a_model, make_optimizer(1e-3))
news = next(MPerClassNewsBatcher(store, "category", batch_size=16, m_per_class=4).epoch(0))
a_loss = make_aspect_train_step()(a_state, to_device(news, "cpu"))[1]["loss"].item()
cr = factory.build_model(dict(small, name="manner_cr"), info, device="cpu")
ens = evaluate_ensemble(cr, {"categ": (a_model, 0.5)}, store, imp, max_history_len=10,
                        target_cells=64, device="cpu")
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r)
print(json.dumps({"g_loss": sd["g_loss"].item(), "d_loss": sd["d_loss"].item(),
                  "a_loss": a_loss, "ensemble": ens, "loaded": loaded}))
""" % (BLOCKED, BLOCKED)


def test_fair_rec_routes_run_with_jax_blocked():
    """SentiDebias's alternating step, an A-module SupCon step on an
    m-per-class batch and the MANNeR ensemble's served metrics, with the
    adversarial and aspect trainers, the statfix v2 generator and the
    port's ``eval.py`` imported, all with JAX, flax, pandas, yaml and the
    JAX package blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", FAIR_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert all(0 < out[k] < 100 for k in ("d_loss", "a_loss"))
    assert abs(out["g_loss"]) < 100
    assert {"auc", "mrr"} <= set(out["ensemble"])


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
