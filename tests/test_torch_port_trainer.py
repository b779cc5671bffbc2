"""The port's trainer, checkpoints and remaining metrics against the JAX
package's on the CPU.

* The whole slice: ``newsreclib_tpu_torch.train.run`` and the repository's
  ``train.py::run`` on copies of the raw demo files, composed from
  ``experiment=nrms_demo`` with dropout 0, float32, one device, 2 epochs of
  4 train batches, every step logged; the port's model starts from the JAX run's
  initial parameters (``convert.flax_to_state_dict``).  Their
  ``metrics.csv`` have the same columns, the logged train losses and every
  ``val/*`` and ``test/*`` metric (loss and AUC included) agree within 1e-4,
  and the best epoch is the same (cached fit-time eval).  The streaming
  eval (``trainer.limit_eval_batches``) gives the cached eval's metrics.
* Checkpoints: save then restore gives identical parameters, optimizer
  state and step; a fit stopped after one epoch and resumed gives the
  parameters of an uninterrupted fit (float32, exact on the CPU).
* ``binary_auc``, ``harmonic_mean`` and ``StreamingEval.finalize`` equal
  the JAX functions on seeded inputs within 1e-6.
"""

import csv
import json
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the repository's train.py

import train as jtrain  # noqa: E402
from newsreclib_tpu.config.compose import compose as jcompose
from newsreclib_tpu.metrics import collector as jcollector
from newsreclib_tpu.metrics import functional as jF
from newsreclib_tpu_torch import train as ttrain
from newsreclib_tpu_torch.config.compose import compose
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.metrics import collector as tcollector
from newsreclib_tpu_torch.metrics import functional as tF
from newsreclib_tpu_torch.training.checkpoint import Checkpointer
from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

ATOL = 1e-4
SLICE = ["experiment=nrms_demo", "platform=cpu", "trainer.devices=1",
         "model.dropout_probability=0", "trainer.max_epochs=2",
         "trainer.limit_train_batches=4", "trainer.log_every_n_steps=1"]
NOT_COMPARED = {"step", "time", "epoch", "train/steps_per_sec", "train/impressions_per_sec"}


def demo_copy(dst: Path) -> Path:
    for split in ("train", "dev"):
        d = dst / f"MINDdemo_{split}"
        d.mkdir(parents=True)
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            (d / name).write_bytes((ROOT / "data" / "demo" / d.name / name).read_bytes())
    (dst / "glove_demo.txt").write_bytes((ROOT / "data" / "demo" / "glove_demo.txt").read_bytes())
    return dst


def overrides(tmp_path: Path, name: str):
    data = demo_copy(tmp_path / f"data_{name}")
    return SLICE + [
        f"data.data_dir={data}", f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
        f"output_dir={tmp_path / name}"]


def read_csv(path: Path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_whole_slice_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("NEWSRECLIB_COMPILE_CACHE", "0")
    monkeypatch.delenv("NEWSRECLIB_PLATFORM", raising=False)
    jcfg = jcompose(str(ROOT / "newsreclib_tpu" / "configs"), "train",
                    overrides(tmp_path, "jax"))
    tcfg = compose(overrides=overrides(tmp_path, "port"))

    initial = {}
    jcreate = jtrain.create_train_state

    def capture(*args, **kwargs):
        state = jcreate(*args, **kwargs)
        initial["params"] = jax.tree.map(np.asarray, state.params)
        return state

    monkeypatch.setattr(jtrain, "create_train_state", capture)
    jmetrics = jtrain.run(jcfg)

    tbuild = ttrain.build_model

    def from_jax_init(*args, **kwargs):
        model = tbuild(*args, **kwargs)
        model.load_state_dict(flax_to_state_dict(initial["params"]))
        return model

    monkeypatch.setattr(ttrain, "build_model", from_jax_init)
    tmetrics = ttrain.run(tcfg)

    jcols, jrows = read_csv(tmp_path / "jax" / "metrics.csv")
    tcols, trows = read_csv(tmp_path / "port" / "metrics.csv")
    assert tcols == jcols
    assert len(trows) == len(jrows) == 2 * (4 + 1) + 1  # steps, epoch ends, test
    for jr, tr in zip(jrows, trows):
        assert jr["step"] == tr["step"] and jr["epoch"] == tr["epoch"]
        for k in set(jcols) - NOT_COMPARED:
            if jr[k] == "":
                assert tr[k] == "", k
            else:
                assert abs(float(tr[k]) - float(jr[k])) <= ATOL, (k, tr[k], jr[k])
    assert set(tmetrics) == set(jmetrics)
    for k in ("val/loss", "val/auc", "test/loss", "test/auc", "best_loss"):
        assert math.isfinite(tmetrics[k]) and abs(tmetrics[k] - jmetrics[k]) <= ATOL, k
    best = [json.loads((tmp_path / n / "checkpoints" / "best.json").read_text())
            for n in ("jax", "port")]
    assert best[0]["epoch"] == best[1]["epoch"] and best[0]["step"] == best[1]["step"]


def small_setup(tmp_path: Path, extra=()):
    """(make_state, loss_fn, train_batcher, val_batcher) of the demo slice on
    the CPU, built from the CLI's own pieces; ``make_state()`` gives a fresh
    train state from seed 0."""
    from newsreclib_tpu_torch.data.batching import EvalBatcher, TrainBatcher
    from newsreclib_tpu_torch.models.factory import build_loss, build_model, load_data_info
    from newsreclib_tpu_torch.training.state import create_train_state

    data = demo_copy(tmp_path / "data")
    cfg = compose(overrides=SLICE + list(extra) + [
        f"data.data_dir={data}", f"data.word_embeddings_fpath={data / 'glove_demo.txt'}"])
    mind = ttrain.setup_data(cfg)
    dc = cfg["data"]
    store = mind.news_store("train").trim_titles()
    info = load_data_info(mind, cfg["model"])
    train = TrainBatcher(store, mind.impressions("train"), batch_size=dc["batch_size"],
                         max_history_len=dc["max_history_len"], u_bucket_min=64,
                         split_title_len=16)
    val = EvalBatcher(store, mind.impressions("val"), max_history_len=dc["max_history_len"],
                      target_cells=128, u_bucket_min=64, split_title_len=16)

    def state():
        model = build_model(cfg["model"], info, device="cpu", seed=0)
        return create_train_state(model, ttrain.build_optimizer(cfg, len(train)), dropout_seed=0)

    return state, build_loss(cfg["model"]), train, val


def test_checkpoint_round_trip(tmp_path):
    make_state, loss_fn, train, _ = small_setup(tmp_path)
    state = make_state()
    trainer = Trainer(state, loss_fn, TrainerConfig(max_epochs=1, limit_train_batches=3))
    trainer.train_epoch(train, 0)
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    assert ckpt.save(state, 3, metric=0.5, extra={"epoch": 0})
    assert not ckpt.save(state, 3, metric=0.7, extra={"epoch": 1})  # not better
    assert ckpt.has("best") and ckpt.has("last")
    assert ckpt.meta("best") == {"metric": 0.5, "step": 3, "epoch": 0}
    assert ckpt.meta("last")["epoch"] == 1

    other = make_state()
    torch.nn.init.zeros_(next(other.model.parameters()))
    restored = Checkpointer(str(tmp_path / "ckpt")).restore(other, "best")
    assert restored.step == state.step == 3
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              restored.model.state_dict().items()):
        assert torch.equal(a, b), n
    want, got = state.opt.state_dict(), restored.opt.state_dict()
    assert want["param_groups"] == got["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(v, got["state"][i][k]), (i, k)
    assert Checkpointer(str(tmp_path / "ckpt")).best_metric == 0.5


def test_resume_continues_at_the_next_epoch(tmp_path):
    make_state, loss_fn, train, val = small_setup(tmp_path)
    cfg = dict(limit_train_batches=3, patience=5)
    straight = Trainer(make_state(), loss_fn,
                       TrainerConfig(max_epochs=2, ckpt_dir=str(tmp_path / "a"), **cfg))
    straight.fit(train, val)

    first = Trainer(make_state(), loss_fn,
                    TrainerConfig(max_epochs=1, ckpt_dir=str(tmp_path / "b"), **cfg))
    first.fit(train, val)
    assert Checkpointer(str(tmp_path / "b")).meta("last")["epoch"] == 0
    resumed = Trainer(make_state(), loss_fn,
                      TrainerConfig(max_epochs=2, ckpt_dir=str(tmp_path / "b"), **cfg))
    epochs = []
    real_train_epoch = resumed.train_epoch
    resumed.train_epoch = lambda b, e: epochs.append(e) or real_train_epoch(b, e)
    resumed.fit(train, val, resume=True)
    assert epochs == [1]
    assert resumed.global_step == straight.global_step == 6
    assert resumed.state.step == straight.state.step == 6
    for (n, a), (_, b) in zip(straight.state.model.state_dict().items(),
                              resumed.state.model.state_dict().items()):
        assert torch.equal(a, b), n


def test_streaming_eval_matches_cached_eval(tmp_path):
    """The uncached path (``limit_eval_batches`` set) scores the same
    batches as the cached one: every metric, loss and AUC included, within
    1e-5 (float32; the news vectors come from per-batch encodes)."""
    make_state, loss_fn, train, val = small_setup(tmp_path)
    state = make_state()
    Trainer(state, loss_fn, TrainerConfig(limit_train_batches=3)).train_epoch(train, 0)
    cached = Trainer(state, loss_fn, TrainerConfig()).evaluate(val)
    streamed = Trainer(state, loss_fn, TrainerConfig(limit_eval_batches=10**6)).evaluate(val)
    assert set(cached) == set(streamed) and {"val/loss", "val/auc"} <= set(cached)
    for k in cached:
        assert abs(cached[k] - streamed[k]) <= 1e-5, (k, cached[k], streamed[k])


def test_overfit_batches_replays_the_first_batches(tmp_path):
    make_state, loss_fn, train, _ = small_setup(tmp_path)
    trainer = Trainer(make_state(), loss_fn, TrainerConfig(max_epochs=3, overfit_batches=2))
    out = trainer.fit(train)
    assert trainer.global_step == 6 and math.isfinite(out["best_loss"])


def test_non_finite_loss_stops_the_epoch(tmp_path):
    make_state, _, train, _ = small_setup(tmp_path)
    nan_loss = lambda s, l, m=None, v=None: (s * float("nan")).sum()  # noqa: E731
    trainer = Trainer(make_state(), nan_loss, TrainerConfig(limit_train_batches=2))
    with pytest.raises(FloatingPointError, match="non-finite train loss"):
        trainer.train_epoch(train, 0)


def test_trainer_refuses_mesh_and_global_rows(tmp_path):
    make_state, loss_fn, _, _ = small_setup(tmp_path)
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        Trainer(make_state(), loss_fn, TrainerConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        Trainer(make_state(), loss_fn, TrainerConfig(), u_bucket=512)


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_auc_matches_jax(seed):
    rng = np.random.default_rng(seed)
    preds = np.round(rng.normal(size=257), 1).astype(np.float32)  # ties
    targets = (rng.random(257) < 0.3).astype(np.float32)
    want = float(jF.binary_auc(jnp.asarray(preds), jnp.asarray(targets)))
    got = float(tF.binary_auc(torch.tensor(preds), torch.tensor(targets)))
    assert abs(got - want) <= 1e-6
    assert float(tF.binary_auc(torch.tensor(preds), torch.zeros(257))) == 0.0


def test_harmonic_mean_matches_jax():
    x = np.random.default_rng(3).uniform(0.1, 1.0, size=9).astype(np.float32)
    assert abs(float(tF.harmonic_mean(torch.tensor(x)))
               - float(jF.harmonic_mean(jnp.asarray(x)))) <= 1e-6


@pytest.mark.parametrize("with_loss", [True, False])
def test_streaming_eval_matches_jax(with_loss):
    rng = np.random.default_rng(4)
    jstream = jcollector.StreamingEval()
    tstream = tcollector.StreamingEval()
    for b, c in ((6, 8), (5, 16), (7, 8)):
        scores = rng.normal(size=(b, c)).astype(np.float32)
        labels = (rng.random((b, c)) < 0.3).astype(np.float32)
        mask = rng.random((b, c)) < 0.8
        valid = rng.random(b) < 0.8
        per_imp = {k: rng.random(b).astype(np.float32) for k in ("mrr", "ndcg@5")}
        loss = np.float32(rng.random()) if with_loss else None
        jstream.update(jnp.asarray(scores), {k: jnp.asarray(v) for k, v in per_imp.items()},
                       jnp.asarray(valid), labels, mask,
                       None if loss is None else jnp.asarray(loss))
        tstream.update(torch.tensor(scores), {k: torch.tensor(v) for k, v in per_imp.items()},
                       torch.tensor(valid), torch.tensor(labels), torch.tensor(mask),
                       None if loss is None else torch.tensor(loss))
    want, got = jstream.finalize(), tstream.finalize()
    assert set(got) == set(want) == {"mrr", "ndcg@5", "auc"} | ({"loss"} if with_loss else set())
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert tcollector.StreamingEval().finalize() == {}
