"""The port's config reader, config composition and CLI on the CPU.

* ``yaml_lite.loads`` equals ``yaml.safe_load`` on every YAML file under
  ``newsreclib_tpu/configs/`` and on a list of override values (YAML 1.1
  scalars: ``1e-4`` stays a string, ``017`` is octal, ``on`` is true, ...).
* The port's ``compose`` equals the JAX package's for each of the 104
  experiments and under a group swap, a float leaf, ``null``, a list and a
  new key; its override-value parser equals the JAX one.
* ``python -m newsreclib_tpu_torch.train experiment=nrms_demo
  platform=cpu`` on a copy of the raw demo files exits 0 and writes
  ``metrics.csv``, ``hparams.json``, ``config_tree.json`` and the best and
  last checkpoints; without ``platform=cpu`` and without a card it fails,
  saying that no CUDA device is available; the models, datasets and
  trainers not ported raise ``NotImplementedError`` naming their ROADMAP
  item.
"""

import csv
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from newsreclib_tpu.config import compose as jcompose
from newsreclib_tpu_torch.config import compose as tcompose
from newsreclib_tpu_torch.config.yaml_lite import loads

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = ROOT / "newsreclib_tpu" / "configs"
YAML_FILES = sorted(str(p.relative_to(CONFIG_DIR)) for p in CONFIG_DIR.rglob("*.yaml"))
EXPERIMENTS = sorted(p.stem for p in (CONFIG_DIR / "experiment").glob("*.yaml"))
VALUES = ["1.0e5", "1e-4", "1e-05", "1.0e-5", "1.5e+3", "3.", ".5", "-.inf", ".nan", "017",
          "08", "00", "0x1f", "0b101", "1_000", "1:20", "1:30.5", "+1", "-0", "yes", "On",
          "off", "NO", "~", "null", "Null", "", "a: b", "- a", "foo #bar", "foo#bar",
          '"2e5"', "'it''s'", '"a\\tb"', "[1, [2, 3], {a: b}]", "[a, b, ]", "[]", "{}",
          "{a: 1, b: [x, y]}", "{a: }", "[null, ~, true]", "http://x.y/z", "a b c",
          "  x  ", "don't", "outputs/${model.name}_${data.name}", "???", "nrms"]
OVERRIDES = [
    ["experiment=nrms_statfix_celoss"],
    ["experiment=nrms_demo", "model=naml", "trainer=fdr"],
    ["experiment=nrms_demo", "model.optimizer.lr=1e-05", "data.batch_size=16"],
    ["experiment=nrms_statfix_celoss", "trainer.limit_train_batches=null",
     "model.top_k_list=[1, 3, 5]", "platform=cpu"],
    ["data=mind_demo", "model=nrms", "trainer.max_epochs=2", "ckpt_path=/tmp/x",
     "output_dir=outputs/torch/${model.name}"],
    ["experiment=manner_cr_demo", "data=mind_statfix", "trainer.precision=bf16"],
]


def same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("rel", YAML_FILES)
def test_yaml_lite_reads_every_config_as_safe_load(rel):
    text = (CONFIG_DIR / rel).read_text()
    assert loads(text) == yaml.safe_load(text)


@pytest.mark.parametrize("value", VALUES)
def test_yaml_lite_scalars_and_override_values_match(value):
    assert same(loads(value), yaml.safe_load(value))
    assert same(tcompose.parse_override_value(value), jcompose._parse_override_value(value))


def test_yaml_lite_refuses_what_it_does_not_read():
    for text in ("a: &x 1", "a: !!str 1", "a: |\n  x", "a: 2019-11-14", "---\na: 1",
                 "a: 'open"):
        with pytest.raises(ValueError):
            loads(text)


def test_config_files_and_experiments_are_all_there():
    assert len(YAML_FILES) >= 140 and len(EXPERIMENTS) == 104


@pytest.mark.parametrize("experiment", EXPERIMENTS)
def test_compose_matches_jax(experiment):
    ov = [f"experiment={experiment}"]
    assert tcompose.compose(str(CONFIG_DIR), "train", ov) == jcompose.compose(
        str(CONFIG_DIR), "train", ov)


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: " ".join(o))
def test_compose_with_overrides_matches_jax(overrides):
    want = jcompose.compose(str(CONFIG_DIR), "train", overrides)
    assert tcompose.compose(str(CONFIG_DIR), "train", overrides) == want
    assert tcompose.compose(overrides=overrides) == want  # CONFIG_DIR is the default


def test_nrms_statfix_config_is_the_f32_nrms_width():
    from newsreclib_tpu_torch.train import normalize_precision

    cfg = tcompose.compose(overrides=["experiment=nrms_statfix_celoss"])
    m = cfg["model"]
    assert (m["name"], m["embed_dim"], m["num_heads"], m["query_dim"]) == ("nrms", 300, 15, 200)
    assert m["use_pretrained_embeddings"] and cfg["data"]["generate_fixture"] == "statfix"
    assert normalize_precision(cfg["trainer"].get("precision")) is None  # float32
    assert normalize_precision("bf16") == "bfloat16"
    assert (cfg["trainer"]["max_epochs"], cfg["trainer"]["patience"]) == (5, 2)


def demo_copy(dst: Path) -> Path:
    """The raw demo files and GloVe file under ``dst`` (no caches)."""
    for split in ("train", "dev"):
        d = dst / f"MINDdemo_{split}"
        d.mkdir(parents=True)
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            (d / name).write_bytes((ROOT / "data" / "demo" / d.name / name).read_bytes())
    (dst / "glove_demo.txt").write_bytes((ROOT / "data" / "demo" / "glove_demo.txt").read_bytes())
    return dst


def run_cli(args, cwd):
    # two intra-op threads: the suite runs beside other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    env.pop("NEWSRECLIB_PLATFORM", None)
    return subprocess.run([sys.executable, "-m", "newsreclib_tpu_torch.train", *args],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_cli_trains_nrms_demo_on_the_cpu(tmp_path):
    data = demo_copy(tmp_path / "data")
    out = tmp_path / "run"
    proc = run_cli(["experiment=nrms_demo", "platform=cpu", f"data.data_dir={data}",
                    f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
                    f"output_dir={out}", "trainer.max_epochs=2"], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-3000:]
    for name in ("metrics.csv", "hparams.json", "config_tree.json",
                 "checkpoints/best.pt", "checkpoints/last.pt", "checkpoints/best.json"):
        assert (out / name).exists(), name
    rows = list(csv.DictReader(open(out / "metrics.csv")))
    assert {"train/loss", "val/loss", "val/auc", "test/auc", "test/loss"} <= set(rows[0])
    final = [r for r in rows if r.get("test/auc")]
    assert len(final) == 1 and math.isfinite(float(final[0]["test/loss"]))
    tree = json.loads((out / "config_tree.json").read_text())
    assert tree["platform"] == "cpu" and tree["output_dir"] == str(out)
    # the ETL ran from the raw files into the copy
    assert (data / "MINDdemo_train" / "news_store.npz").exists()
    assert not (tmp_path / "outputs").exists()


def test_cli_refuses_to_fall_back_to_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "run"
    proc = run_cli(["experiment=nrms_demo", f"output_dir={out}"], cwd=tmp_path)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert "no CUDA device is available" in (out / "error.log").read_text()


# The PLM tower and PLM-mode tokenisation are ported (tests/test_torch_port_plm.py,
# tests/test_torch_port_plm_data.py), and so are Adressa's one_week and
# three_month data and xMIND (tests/test_torch_port_datasets.py) and the
# multi-device settings (tests/test_torch_port_parallel.py,
# tests/test_torch_port_multiprocess.py); xMIND in PLM mode and datasets the
# JAX package lacks are not.
@pytest.mark.parametrize("overrides,item", [
    (["model=sentirec", "model.use_plm=true", "data.use_plm=true", "data.dataset=xmind"],
     "xMIND in PLM mode"),
    (["data.dataset=plista"], '"Other datasets"'),
    (["model=senti_debias", "model.use_plm=true", "data.use_plm=true", "data.dataset=xmind"],
     "xMIND in PLM mode"),
])
def test_unported_routes_raise(tmp_path, overrides, item):
    from newsreclib_tpu_torch.train import main

    data = demo_copy(tmp_path / "data")
    (tmp_path / "empty").mkdir()
    args = ["experiment=nrms_demo", "platform=cpu", f"data.data_dir={data}",
            f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
            f"output_dir={tmp_path / 'run'}"]
    args += [o.format(empty=tmp_path / "empty") for o in overrides]
    with pytest.raises(NotImplementedError, match=item):
        main(args)
    assert (tmp_path / "run" / "error.log").exists()
