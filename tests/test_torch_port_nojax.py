"""The port runs without JAX: the machine with the card has no jax, flax,
optax, orbax, pandas or yaml.  A subprocess blocks those imports and the JAX
package, then drives the serving slice and two training steps on the CPU;
others build MINS, CenNewsRec and CAUM, NAML, TANR, LSTUR, NPA, MINER and
DKN, and SentiRec and MANNeR's CR module, and train each a step, and drive
SentiDebias's alternating step, an A-module step and MANNeR's ensemble;
another loads, trains (with frozen layers) and serves NRMS with the PLM
tower with ``transformers`` and ``safetensors`` blocked as well; another
runs the training CLI (config composition, ETL, fit, checkpoints,
test) on a copy of the raw demo files; another runs the Adressa ETL from a
fixture tar through the native host parser, an xMIND store and the CLI on
Adressa data with ``save_recs``; another writes fixture tokenizers and runs
the CLI in PLM mode and an Adressa PLM store with ``transformers``,
``tokenizers``, ``regex`` and ``safetensors`` blocked as well; another runs
the sweep's console script, the BERT sentiment annotator and the profiling
and timing utilities with those blocked too; another starts 2 CPU ranks of
the training CLI through the port's launcher (multi-host mode, the word
table row-sharded), every interpreter with them blocked; another the MLM
pretraining, the frozen-layer check and a ``trainer.devices=2`` CLI run
with its evaluation and ``save_recs`` split over the ranks.
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


PLM_SCRIPT = """
import json, sys, tempfile
for name in %r + ("transformers", "safetensors"):
    sys.modules[name] = None  # any import of it now raises ImportError
import numpy as np
import torch
from newsreclib_tpu_torch import train
from newsreclib_tpu_torch.data.batch import to_device
from newsreclib_tpu_torch.data.batching import TrainBatcher
from newsreclib_tpu_torch.data.synthetic import make_serving_workload
from newsreclib_tpu_torch.models import factory
from newsreclib_tpu_torch.models.components import plm
from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
from newsreclib_tpu_torch.serving import CachedScorer
from newsreclib_tpu_torch.training.state import create_train_state
from newsreclib_tpu_torch.training.steps import make_train_step

store, imp = make_serving_workload(np.random.default_rng(0), corpus=200, n_impressions=30,
                                   hist_len=10, num_candidates=6, vocab_size=500)
kw = dict(vocab_size=500, hidden_dim=32, num_layers=2, num_heads=4, intermediate_dim=64,
          max_position=64)
tower = plm.TransformerEncoder(**kw, generator=torch.Generator().manual_seed(1))
ckpt = plm.save_as_hf_bert(tower.state_dict(), kw, tempfile.mkdtemp())
cfg = {"name": "nrms", "use_plm": True, "plm_model": ckpt, "num_heads": 2, "query_dim": 8,
       "frozen_layers": [0]}
model = factory.build_model(cfg, factory.DataInfo(vocab_size=500), device="cpu")
loaded_ok = all(torch.equal(model.text_encoder_module.encoder.state_dict()[k], v)
                for k, v in tower.state_dict().items())
frozen = {k: v.clone() for k, v in model.state_dict().items() if ".layer_0." in k}
state = create_train_state(model, train.build_optimizer({"model": cfg, "trainer": {}}, 1, model))
batch = next(TrainBatcher(store, imp, batch_size=4, max_history_len=10, u_bucket_min=64,
                          split_title_len=16).epoch(0))
loss = make_train_step(cross_entropy_loss)(state, to_device(batch, "cpu"))[1]["loss"].item()
kept = all(torch.equal(model.state_dict()[k], v) for k, v in frozen.items())
metrics = CachedScorer(model, device="cpu").evaluate(store, imp, max_history_len=10,
                                                     target_cells=64, encode_batch=64)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r + ("transformers", "safetensors"))
print(json.dumps({"loss": loss, "loaded_ok": loaded_ok, "frozen_kept": kept,
                  "metrics": metrics, "loaded": loaded}))
""" % (BLOCKED, BLOCKED)


def test_plm_tower_runs_without_jax_or_transformers():
    """The PLM route with JAX, flax, pandas, yaml, the JAX package,
    ``transformers`` and ``safetensors`` blocked: a tower written by
    ``save_as_hf_bert`` loads through the factory, NRMS with it takes a
    train step with layer 0 and the embeddings frozen (unchanged after it)
    and serves a ``CachedScorer`` epoch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", PLM_SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["loaded_ok"] and out["frozen_kept"]
    assert 0 < out["loss"] < 10
    assert {"auc", "mrr"} <= set(out["metrics"])


DATASETS_SCRIPT = """
import json, os, shutil, sys
for name in %r:
    sys.modules[name] = None  # any import of it now raises ImportError
from newsreclib_tpu_torch.data import adressa, fastetl, mind, statfix, testing, xmind
from newsreclib_tpu_torch.train import main

work = sys.argv[1]
tar_dir = os.path.join(work, "adressa")
testing.write_adressa_fixture(tar_dir)
data = adressa.AdressaData(adressa.AdressaConfig(data_dir=tar_dir, neg_num=10))
imp = data.impressions("train")
native = fastetl.get_lib() is not None
mind_dir = os.path.join(work, "mind")
testing.write_mind_fixture(mind_dir, dataset_size="small")
shutil.copy(os.path.join(mind_dir, "glove_demo.txt"), os.path.join(mind_dir, "glove_statfix.txt"))
statfix.write_xmind_statfix(mind_dir)
x = xmind.XMINDData(mind.MINDData(mind.MINDConfig(data_dir=mind_dir)), xmind.XMINDConfig())
store = x.news_store("train")
run = os.path.join(work, "run")
metrics = main(["data=adressa_demo", "model=nrms", "model.embed_dim=60", "model.num_heads=6",
                "model.query_dim=16", "platform=cpu", "trainer.max_epochs=1",
                f"data.data_dir={os.path.join(work, 'cli')}", f"output_dir={run}",
                "save_recs=true"])
recs = json.load(open(os.path.join(run, "recommendations.json")))
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r)
print(json.dumps({"n_train": len(imp), "native": native, "xmind_rows": store.num_news,
                  "test_auc": metrics["test/auc"], "users": len(recs), "loaded": loaded}))
""" % (BLOCKED, BLOCKED)


def test_datasets_and_save_recs_run_with_jax_and_pandas_blocked(tmp_path):
    """The Adressa ETL from ``write_adressa_fixture``'s tar (the native
    parser where g++ is present), an xMIND store over ``write_mind_fixture``
    and ``write_xmind_statfix``, and the CLI on ``adressa_demo`` generating
    its fixture and exporting recommendations, with JAX, flax, pandas, yaml
    and the JAX package blocked."""
    import shutil

    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", DATASETS_SCRIPT, str(tmp_path)], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["native"] == (shutil.which("g++") is not None)
    assert out["n_train"] > 0 and out["xmind_rows"] == 240 and out["users"] > 0
    assert 0 <= out["test_auc"] <= 1


TOKENIZER_LIBS = ("transformers", "tokenizers", "regex", "safetensors")
PLM_MODE_SCRIPT = """
import json, os, shutil, sys
for name in %r + %r:
    sys.modules[name] = None  # any import of it now raises ImportError
from newsreclib_tpu_torch.data import adressa, testing
from newsreclib_tpu_torch.train import main

work, demo = sys.argv[1], sys.argv[2]
texts = [line.split("\\t")[3] for line in open(os.path.join(demo, "MINDdemo_train", "news.tsv"))]
wordpiece = testing.write_fixture_tokenizer(os.path.join(work, "wp"), texts, "wordpiece", 200)
bpe = testing.write_fixture_tokenizer(os.path.join(work, "bpe"), texts, "bpe", 300)
data = os.path.join(work, "data")
for split in ("MINDdemo_train", "MINDdemo_dev"):
    os.makedirs(os.path.join(data, split))
    for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
        shutil.copy(os.path.join(demo, split, name), os.path.join(data, split, name))
metrics = main(["experiment=nrms_demo", "platform=cpu", f"data.data_dir={data}",
                f"data.word_embeddings_fpath={os.path.join(demo, 'glove_demo.txt')}",
                f"output_dir={os.path.join(work, 'run')}", "trainer.max_epochs=1",
                "trainer.limit_train_batches=2", "data.use_plm=true",
                f"data.plm_tokenizer={wordpiece}", "data.tokenizer_max_len=24",
                "model.use_plm=true", "model.plm_model=__random_init__",
                "model.plm_vocab_size=200", "model.embed_dim=16", "model.plm_num_layers=1",
                "model.plm_num_heads=2", "model.num_heads=2"])
ad = os.path.join(work, "adressa")
testing.write_adressa_fixture(ad)
store = adressa.AdressaData(adressa.AdressaConfig(
    data_dir=ad, use_plm=True, plm_tokenizer=bpe, tokenizer_max_len=24)).news_store()
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r + %r)
print(json.dumps({"metrics": metrics, "adressa_width": store.title.shape[1],
                  "loaded": loaded}))
""" % (BLOCKED, TOKENIZER_LIBS, BLOCKED, TOKENIZER_LIBS)


def test_plm_mode_runs_without_jax_or_tokenizer_libraries(tmp_path):
    """Both fixture tokenizers written, the CLI in PLM mode on a copy of the
    demo files and an Adressa PLM store, with JAX, flax, pandas, yaml, the
    JAX package, ``transformers``, ``tokenizers``, ``regex`` and
    ``safetensors`` blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", PLM_MODE_SCRIPT, str(tmp_path),
                           str(ROOT / "data" / "demo")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert {"train/loss", "test/mrr"} <= set(out["metrics"])
    assert out["adressa_width"] == 24


SWEEP_SCRIPT = """
import json, os, shutil, sys
for name in %r + %r:
    sys.modules[name] = None  # any import of it now raises ImportError
import torch
from newsreclib_tpu_torch import cli
from newsreclib_tpu_torch.data import sentiment, testing
from newsreclib_tpu_torch.utils import profiling, timing

work, demo = sys.argv[1], sys.argv[2]
data = os.path.join(work, "data")
for split in ("MINDdemo_train", "MINDdemo_dev"):
    os.makedirs(os.path.join(data, split))
    for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
        shutil.copy(os.path.join(demo, split, name), os.path.join(data, split, name))
os.chdir(work)
sys.argv = ["newsreclib-torch-sweep", "hparams_search=demo_grid", "experiment=nrms_demo",
            "platform=cpu", f"data.data_dir={data}",
            f"data.word_embeddings_fpath={os.path.join(demo, 'glove_demo.txt')}",
            "trainer.max_epochs=1", "trainer.limit_train_batches=2"]
cli.sweep_command()
with open(os.path.join(work, "outputs", "torch", "sweep_results.json")) as f:
    results = json.load(f)
texts = [line.split("\\t")[3] for line in open(os.path.join(demo, "MINDdemo_train", "news.tsv"))]
clf = testing.write_fixture_classifier(os.path.join(work, "clf"), texts, "bpe", hidden_dim=16,
                                       num_heads=2, intermediate_dim=32, max_len=24)
labels = sentiment.get_annotator("bert", model_name=clf, device="cpu").annotate_many(texts[:8])
timer = profiling.StepTimer()
with profiling.trace(os.path.join(work, "trace")), timer.phase("matmul"):
    seconds = timing.timeit_pipelined(torch.mm, torch.ones(8, 8), torch.ones(8, 8), steps=3)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in %r + %r)
print(json.dumps({"values": [t["value"] for t in results["trials"]], "labels": labels,
                  "seconds": seconds, "loaded": loaded}))
""" % (BLOCKED, TOKENIZER_LIBS, BLOCKED, TOKENIZER_LIBS)


def test_sweep_annotator_and_utilities_run_without_jax_or_tokenizer_libraries(tmp_path):
    """The sweep's console script over ``demo_grid`` on a copy of the demo
    files, the BERT sentiment annotator on a fixture classifier, a trace,
    ``StepTimer`` and ``timeit_pipelined``, with JAX, flax, pandas, yaml,
    the JAX package and the tokenizer libraries blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", SWEEP_SCRIPT, str(tmp_path),
                           str(ROOT / "data" / "demo")], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert len(out["values"]) == 2 and all(0 <= v <= 1 for v in out["values"])
    assert len(out["labels"]) == 8 and out["seconds"] > 0
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))


BLOCKER = """
import sys
for name in %r:
    sys.modules[name] = None  # any import of it now raises ImportError
""" % (BLOCKED,)


def test_multi_rank_training_runs_with_jax_blocked(tmp_path):
    """The port's launcher starts 2 CPU ranks of the training CLI in
    multi-host mode (``trainer.distributed=true``) with the word table
    row-sharded over them (``trainer.model_axis=2``) on a copy of the demo
    files, every interpreter (the launcher and both ``spawn`` ranks) with
    JAX, flax, pandas, yaml and the JAX package blocked by a
    ``sitecustomize``; the parallel modules import in it too."""
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(BLOCKER)
    data = tmp_path / "data"
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        (data / split).mkdir(parents=True)
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            (data / split / name).write_bytes((ROOT / "data" / "demo" / split / name)
                                              .read_bytes())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "site"), str(ROOT)]),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "NEWSRECLIB_PLATFORM"):
        env.pop(k, None)
    modules = subprocess.run(
        [sys.executable, "-c", "import json, sys; import newsreclib_tpu_torch.parallel.mesh, "
         "newsreclib_tpu_torch.parallel.collectives, newsreclib_tpu_torch.parallel.embedding, "
         "newsreclib_tpu_torch.parallel.data, newsreclib_tpu_torch.parallel.launch; "
         "print(json.dumps(sorted(m for m in sys.modules if sys.modules[m] is not None "
         "and m.split('.')[0] in %r)))" % (BLOCKED,)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert modules.returncode == 0, modules.stderr[-3000:]
    assert json.loads(modules.stdout.strip().splitlines()[-1]) == []
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "newsreclib_tpu_torch.parallel.launch", "--nprocs", "2",
         "--timeout", "200", "newsreclib_tpu_torch.train", "experiment=nrms_demo",
         "platform=cpu", "trainer.distributed=true", "trainer.model_axis=2",
         "trainer.max_epochs=1", "trainer.limit_train_batches=2", f"data.data_dir={data}",
         "data.word_embeddings_fpath=null", f"output_dir={out}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=260,
        start_new_session=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (out / "checkpoints" / "best.pt").exists()
    assert "test/auc" in (out / "metrics.csv").read_text()


def test_mlm_and_data_parallel_eval_run_with_jax_blocked(tmp_path):
    """With JAX, flax, optax, pandas, yaml and the JAX package blocked in
    every interpreter: ``mlm_pretrain`` (3 steps at the script's sizes on
    the CPU) on a copy of the demo files, exporting a checkpoint; the
    frozen-layer check imports; and ``trainer.devices=2`` starts 2 CPU
    ranks of the training CLI whose evaluation and ``save_recs`` are split
    over them: one metrics file, one recommendations file."""
    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(BLOCKER)
    data = tmp_path / "data"
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        (data / split).mkdir(parents=True)
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            (data / split / name).write_bytes((ROOT / "data" / "demo" / split / name)
                                              .read_bytes())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path / "site"), str(ROOT)]),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "NEWSRECLIB_PLATFORM"):
        env.pop(k, None)
    mlm = subprocess.run(
        [sys.executable, "-c", "import json, sys; import newsreclib_tpu_torch.plm_frozen_check; "
         "from newsreclib_tpu_torch import mlm_pretrain; r = mlm_pretrain.main(sys.argv[1:]); "
         "print(json.dumps({'last': r['history'][-1], 'loaded': sorted(m for m in sys.modules "
         "if sys.modules[m] is not None and m.split('.')[0] in %r)}))" % (BLOCKED,),
         "--data-dir", str(data), "--dataset-size", "demo", "--out", str(tmp_path / "plm"),
         "--steps", "3", "--batch", "8", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=200)
    assert mlm.returncode == 0, mlm.stderr[-3000:]
    res = json.loads(mlm.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["last"]["step"] == 2
    assert (tmp_path / "plm" / "config.json").exists()
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "newsreclib_tpu_torch.train", "experiment=nrms_demo",
         "platform=cpu", "trainer.devices=2", "trainer.max_epochs=1",
         "trainer.limit_train_batches=2", "save_recs=true", f"data.data_dir={data}",
         "data.word_embeddings_fpath=null", f"output_dir={out}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=260,
        start_new_session=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "test/auc" in (out / "metrics.csv").read_text()
    with open(out / "recommendations.json") as f:
        assert len(json.load(f)) > 0


# no port module imports a tokenizer library: the BERT sentiment annotator
# reads its checkpoint with the port's tokenizer reader and tower
TOKENIZER_LIB_USERS = set()


def test_port_sources_import_no_tokenizer_library():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(TOKENIZER_LIBS), re.M)
    files = sorted((ROOT / "newsreclib_tpu_torch").rglob("*.py"))
    assert ROOT / "newsreclib_tpu_torch" / "data" / "plm_tokenizer.py" in files
    users = {str(f.relative_to(ROOT / "newsreclib_tpu_torch")) for f in files
             if pattern.search(f.read_text())}
    assert users == TOKENIZER_LIB_USERS
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(%s)\b" % "|".join(BLOCKED), re.M)
    files = sorted((ROOT / "newsreclib_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_port_gpu.py"]
    assert len(files) > 15
    data = ROOT / "newsreclib_tpu_torch" / "data"
    assert {data / f"{m}.py" for m in ("adressa", "xmind", "fastetl", "testing",
                                       "download", "plm_tokenizer")} <= set(files)
    parallel = ROOT / "newsreclib_tpu_torch" / "parallel"
    assert {parallel / f"{m}.py" for m in ("mesh", "collectives", "embedding", "data",
                                           "launch")} <= set(files)
    assert {ROOT / "newsreclib_tpu_torch" / f"{m}.py"
            for m in ("mlm_pretrain", "plm_frozen_check", "serving")} <= set(files)
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
