"""The port's multi-device layer in one process, against the JAX package:
impression shards, the on-device dedup, the global-row batchers, the
sharding rule, ``convert``'s shards, the launcher's deadlines, the clamp
of ``trainer.devices`` and the refusals (the multi-rank runs are in
``tests/test_torch_port_multiprocess.py``).

Tolerances: the shards, batches and dedup tables are integers and equal
exactly; the global-row trajectory (float32, one device) within 1e-5 of
JAX's.  JAX is imported inside the tests: the launcher's rank functions
below are imported by spawned ranks, which never import it.
"""

import dataclasses
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


def _imps(seed=0, n=37, user_ids=True):
    """The same impressions as the JAX package's and the port's type."""
    from newsreclib_tpu.data.batching import Impressions as JImpressions
    from newsreclib_tpu_torch.data.batching import Impressions

    rng = np.random.default_rng(seed)
    hists = [rng.integers(1, 60, size=int(rng.integers(0, 9))) for _ in range(n)]
    cands = [rng.integers(1, 60, size=int(rng.integers(2, 9))) for _ in range(n)]
    labels = [(rng.random(len(c)) < 0.3).astype(np.int8) for c in cands]
    for lab in labels:
        lab[0] = 1
    uidx = rng.integers(0, 20, n)
    uids = [f"U{i}" for i in rng.integers(0, 500, n)] if user_ids else None
    return (JImpressions.from_lists(hists, cands, labels, uidx, uids),
            Impressions.from_lists(hists, cands, labels, uidx, uids))


def _stores(n=60, width=10, seed=1):
    from newsreclib_tpu.data.news_store import NewsStore as JNewsStore
    from newsreclib_tpu_torch.data.news_store import NewsStore

    rng = np.random.default_rng(seed)
    title = np.zeros((n + 1, width), np.int32)
    for i in range(1, n + 1):
        k = int(rng.integers(2, width + 1))
        title[i, :k] = rng.integers(2, 300, k)
    fields = dict(nid2row={f"N{i}": i for i in range(1, n + 1)}, title=title,
                  category=np.concatenate([[0], rng.integers(1, 7, n)]).astype(np.int32),
                  sentiment=np.concatenate([[0], rng.integers(1, 4, n)]).astype(np.int32))
    return JNewsStore(**fields), NewsStore(**fields)


def _assert_same_fields(got, want):
    for name, w in want._asdict().items():
        g = getattr(got, name)
        if w is None:
            assert g is None, name
        elif hasattr(w, "_asdict"):
            _assert_same_fields(g, w)
        else:
            g = g.numpy() if torch.is_tensor(g) else g
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=name)
            assert np.asarray(g).dtype == np.asarray(w).dtype, name


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("user_ids", [True, False])
def test_shard_impressions_equals_jax(count, user_ids):
    from newsreclib_tpu.parallel.data import shard_impressions as jshard
    from newsreclib_tpu_torch.parallel.data import shard_impressions

    jimp, imp = _imps(user_ids=user_ids)
    for i in range(count):
        got, want = shard_impressions(imp, i, count), jshard(jimp, i, count)
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if w is None:
                assert g is None
                continue
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), f.name


@pytest.mark.parametrize("seed", [0, 1])
def test_global_row_batches_and_densify_equal_jax(seed):
    """``TrainBatcher(global_rows=True, num_steps=...)`` gives JAX's batches
    for the same seed, ``global_u_bucket`` JAX's bucket, and ``densify`` of
    each batch (static ``u_bucket``, no host sync) JAX's dedup table,
    indices and masks."""
    from newsreclib_tpu.data.batch import densify as jdensify
    from newsreclib_tpu.data.batching import TrainBatcher as JTrainBatcher
    from newsreclib_tpu_torch.data.batch import densify, to_device
    from newsreclib_tpu_torch.data.batching import TrainBatcher

    jstore, store = _stores()
    jimp, imp = _imps(seed)
    kw = dict(batch_size=6, max_history_len=5, neg_sampling_ratio=3, seed=seed,
              u_bucket_min=16, global_rows=True, num_steps=4)
    jb, b = JTrainBatcher(jstore, jimp, **kw), TrainBatcher(store, imp, **kw)
    assert len(b) == len(jb) == 4
    assert b.global_u_bucket() == jb.global_u_bucket() and b.global_u_bucket(12) == \
        jb.global_u_bucket(12)
    jcorpus = jstore.features_for(np.arange(jstore.title.shape[0]))
    corpus = to_device(store.features_for(np.arange(store.title.shape[0])), "cpu")
    u_bucket = b.global_u_bucket()
    for got, want in zip(b.epoch(1), jb.epoch(1)):
        assert got.news is None and want.news is None
        _assert_same_fields(got, want)
        dense, overflow = densify(to_device(got, "cpu"), corpus, u_bucket)
        jdense, joverflow = jdensify(want, jcorpus, u_bucket)
        assert bool(overflow) == bool(joverflow) is False
        _assert_same_fields(dense, jax_numpy(jdense))
        small, over = densify(to_device(got, "cpu"), corpus, 4)
        assert bool(over) and bool(jdensify(want, jcorpus, 4)[1])


def jax_numpy(tree):
    """A JAX batch's arrays as numpy (dtypes kept)."""
    fields = {}
    for k, v in tree._asdict().items():
        if hasattr(v, "_asdict"):
            fields[k] = jax_numpy(v)
        else:
            fields[k] = None if v is None else np.asarray(v)
    return type(tree)(**fields)


def test_eval_batcher_batch_multiple_equals_jax():
    from newsreclib_tpu.data.batching import EvalBatcher as JEvalBatcher
    from newsreclib_tpu_torch.data.batching import EvalBatcher

    jstore, store = _stores()
    jimp, imp = _imps(2)
    kw = dict(max_history_len=5, target_cells=30, u_bucket_min=16, batch_multiple=4)
    got, want = list(EvalBatcher(store, imp, **kw)), list(JEvalBatcher(jstore, jimp, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.hist_idx.shape[0] % 4 == 0
        _assert_same_fields(g, w)


def _nrms_pair(example, vocab=300):
    import jax

    from newsreclib_tpu.models.general_rec import NRMS as JNRMS
    from newsreclib_tpu.training.state import create_train_state as jcreate
    from newsreclib_tpu.training.state import make_optimizer as jopt
    from newsreclib_tpu_torch.convert import flax_to_state_dict
    from newsreclib_tpu_torch.models.general_rec import NRMS
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer

    dims = dict(embed_dim=48, num_heads=4, query_dim=24, dropout=0.0)
    jstate = jcreate(JNRMS(vocab_size=vocab, **dims), example, jax.random.key(3), jopt(1e-3))
    model = NRMS(vocab, device="cpu", **dims)
    model.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, jstate.params)))
    return jstate, create_train_state(model, make_optimizer(1e-3))


class _Cap:
    def __init__(self):
        self.losses = []

    def log_metrics(self, m, step):
        if "train/loss" in m:
            self.losses.append(m["train/loss"])


def test_global_row_training_matches_jax_and_overflow_poisons_the_loss():
    """One device: ``Trainer(corpus=..., u_bucket=...)`` over global-row
    batches gives JAX's per-step losses (1e-5); a ``u_bucket`` below the
    unique count makes the loss NaN and the finite check raise."""
    from newsreclib_tpu.data.batching import TrainBatcher as JTrainBatcher
    from newsreclib_tpu.models.components.losses import cross_entropy_loss as jce
    from newsreclib_tpu.training.trainer import Trainer as JTrainer
    from newsreclib_tpu.training.trainer import TrainerConfig as JConfig
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    jstore, store = _stores()
    jimp, imp = _imps(4, n=60)
    kw = dict(batch_size=8, max_history_len=5, neg_sampling_ratio=3, seed=2, u_bucket_min=16)
    example = next(iter(JTrainBatcher(jstore, jimp, **kw).epoch(0)))
    jstate, state = _nrms_pair(example)
    jb = JTrainBatcher(jstore, jimp, global_rows=True, **kw)
    u_bucket = jb.global_u_bucket()
    jcap, cap = _Cap(), _Cap()
    limit = dict(max_epochs=1, log_every_n_steps=1, ckpt_dir=None, limit_train_batches=4)
    jt = JTrainer(jstate, jce, JConfig(**limit), loggers=[jcap],
                  corpus=jstore.features_for(np.arange(61)), u_bucket=u_bucket)
    jt.train_epoch(jb, 0)
    t = Trainer(state, cross_entropy_loss, TrainerConfig(**limit), loggers=[cap],
                corpus=store.features_for(np.arange(61)), u_bucket=u_bucket)
    batcher = TrainBatcher(store, imp, global_rows=True, **kw)
    t.train_epoch(batcher, 0)
    assert len(cap.losses) == len(jcap.losses) == 4
    np.testing.assert_allclose(cap.losses, jcap.losses, atol=1e-5)

    t_small = Trainer(t.state, cross_entropy_loss, TrainerConfig(**limit),
                      corpus=store.features_for(np.arange(61)), u_bucket=8)
    with pytest.raises(FloatingPointError):
        t_small.train_epoch(batcher, 0)


def _plm_params():
    import jax

    from newsreclib_tpu.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu.models.components.plm import PLMTextEncoder, TransformerEncoder
    from newsreclib_tpu.models.general_rec import NRMS

    batch = make_batch(np.random.default_rng(0), batch_size=4, hist_len=5, num_candidates=5,
                       unique_news=16, cfg=SyntheticConfig(vocab_size=300, title_len=12))
    enc = TransformerEncoder(vocab_size=300, hidden_dim=32, num_layers=2, num_heads=4,
                             intermediate_dim=64, max_position=64, dropout=0.0)
    tower = PLMTextEncoder(encoder=enc, use_mhsa=True, num_heads=4, query_dim=16, dropout=0.0)
    model = NRMS(vocab_size=300, embed_dim=32, num_heads=4, query_dim=16,
                 text_encoder_module=tower)
    return model.init(jax.random.key(0), batch)["params"]


@pytest.mark.parametrize("rows,tp", [(True, False), (True, True), (False, True)])
def test_sharding_rule_equals_jax(rows, tp):
    """``shard_specs`` on the port's names shards what JAX's
    ``param_shardings`` shards, on the transposed axis of a kernel: JAX's
    ``P(None, "model")`` kernel (in, out) is dimension 0 of the port's
    (out, in) weight, ``P("model", None)`` dimension 1 (row-sharded tables
    keep dimension 0)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from newsreclib_tpu.parallel.mesh import make_mesh, param_shardings
    from newsreclib_tpu_torch.convert import flax_to_state_dict
    from newsreclib_tpu_torch.parallel.mesh import shard_specs

    params = _plm_params()
    sh = param_shardings(params, make_mesh(jax.devices()[:4], model_axis=2),
                         row_shard_embeddings=rows, tp_transformer=tp)
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
    want = {}
    for path, s in jax.tree_util.tree_leaves_with_path(sh):
        keys = [str(p.key) for p in path]
        leaf = keys[-1]
        name = ".".join(keys[:-1] + [{"kernel": "weight", "embedding": "weight"}.get(leaf, leaf)])
        if s.spec == P():
            continue
        if leaf == "kernel":
            want[name] = 0 if s.spec == P(None, "model") else 1
        else:
            want[name] = 0
    got = shard_specs({k: tuple(v.shape) for k, v in sd.items()}, 2, rows, tp)
    assert got == want
    assert shard_specs({k: tuple(v.shape) for k, v in sd.items()}, 1, rows, tp) == {}


@pytest.mark.parametrize("model_axis,vocab", [(2, 300), (4, 301)])
def test_convert_shards_round_trip(model_axis, vocab):
    """``shard_state_dict`` cuts each sharded tensor into the blocks of the
    model ranks (the last padded with zeros), ranks of one model index get
    the same block, and ``unshard_state_dict`` gives the state dict back."""
    from newsreclib_tpu_torch.convert import shard_state_dict, unshard_state_dict

    rng = np.random.default_rng(0)
    sd = {"news_encoder.embedding.weight": torch.tensor(rng.normal(size=(vocab, 8))),
          "enc.layer_0.q.weight": torch.tensor(rng.normal(size=(8, 8))),
          "enc.layer_0.q.bias": torch.tensor(rng.normal(size=8)),
          "enc.layer_0.ff2.weight": torch.tensor(rng.normal(size=(8, 16))),
          "user_encoder.mhsa.qkv.weight": torch.tensor(rng.normal(size=(24, 8)))}
    world = 2 * model_axis
    shards = [shard_state_dict(sd, r, world, model_axis, tp_transformer=True)
              for r in range(world)]
    per = -(-vocab // model_axis)
    assert shards[0]["news_encoder.embedding.weight"].shape == (per, 8)
    assert shards[0]["enc.layer_0.q.weight"].shape == (8 // model_axis, 8)
    assert shards[0]["enc.layer_0.ff2.weight"].shape == (8, 16 // model_axis)
    assert shards[0]["user_encoder.mhsa.qkv.weight"].shape == (24, 8)
    for r in range(model_axis, world):
        for k in sd:
            torch.testing.assert_close(shards[r][k], shards[r - model_axis][k], rtol=0, atol=0)
    back = unshard_state_dict(shards, {k: tuple(v.shape) for k, v in sd.items()}, model_axis,
                              tp_transformer=True)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


# ---------------- the launcher ----------------


def _sleeper(rank, world, seconds):
    time.sleep(seconds)
    return rank


def _fails_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(60)  # rank 0 would wait in a collective
    return rank


def _pid(rank, world):
    return rank, world, os.getpid(), os.environ["MASTER_PORT"]


def test_launcher_returns_each_rank_result():
    from newsreclib_tpu_torch.parallel.launch import spawn

    out = spawn(_pid, 3, timeout=60)
    assert [o[:2] for o in out] == [(0, 3), (1, 3), (2, 3)]
    assert len({o[2] for o in out}) == 3 and len({o[3] for o in out}) == 1


def test_launcher_kills_the_ranks_on_failure_and_on_timeout():
    """A failing rank ends the launch within seconds (the others killed, not
    left waiting 60 s), and so does the deadline."""
    from newsreclib_tpu_torch.parallel.launch import spawn

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        spawn(_fails_on_rank_1, 2, timeout=120)
    with pytest.raises(TimeoutError):
        spawn(_sleeper, 2, (60,), timeout=4)
    assert time.monotonic() - t0 < 40


# ---------------- the CLI's choices ----------------


def _cfg(devices, batch=8, model_axis=1, platform="cpu"):
    return {"platform": platform, "data": {"batch_size": batch},
            "trainer": {"devices": devices, "model_axis": model_axis}}


@pytest.mark.parametrize("devices,batch,model_axis,want", [
    ("all", 8, 1, 1), (None, 8, 1, 1), (1, 8, 1, 1), (2, 8, 1, 2), (3, 8, 1, 2),
    (4, 6, 1, 3), (4, 8, 2, 4), (3, 8, 2, 2), (8, 2, 2, 4)])
def test_local_rank_count_clamps_as_jax(devices, batch, model_axis, want, monkeypatch):
    """``trainer.devices`` on the CPU: ``all`` is one rank, an integer that
    many, then down until the data axis divides the batch and the model axis
    the count (the root ``train.py:195-206``)."""
    from newsreclib_tpu_torch import train

    monkeypatch.delenv("NEWSRECLIB_PLATFORM", raising=False)
    assert train.local_rank_count(_cfg(devices, batch, model_axis)) == want


def test_all_devices_without_a_card_is_one_rank(monkeypatch):
    """``trainer.devices=all`` on ``cuda``: every card present; with none
    the entry point's own refusal comes later (``select_device``)."""
    from newsreclib_tpu_torch import train

    monkeypatch.delenv("NEWSRECLIB_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train.local_rank_count(_cfg("all", platform="cuda")) == 1
    assert train.local_rank_count(_cfg(4, platform="cuda")) == 1


def test_share_card_ranks_and_backend(monkeypatch):
    """``trainer.share_card`` with an integer ``trainer.devices``: that many
    ranks whatever the cards, every one on ``cuda:0`` over gloo in
    single-node mode; with ``all`` it counts the cards as without it, and
    multi-host mode ignores it."""
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.parallel import mesh as pmesh

    monkeypatch.delenv("NEWSRECLIB_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def cfg(devices, batch=8):
        c = _cfg(devices, batch, platform="cuda")
        c["trainer"]["share_card"] = True
        return c

    assert train.local_rank_count(cfg(2)) == 2
    assert train.local_rank_count(cfg(3, batch=6)) == 3
    assert train.local_rank_count(cfg(4, batch=6)) == 3  # the batch still clamps it
    assert train.local_rank_count(cfg("all")) == 1
    assert train.local_rank_count(_cfg(2, platform="cuda")) == 1

    seen = []
    monkeypatch.setattr(pmesh, "rank_device", lambda platform, i: (platform, i))
    monkeypatch.setattr(pmesh, "init_mesh", lambda rank, world, model_axis, device, backend=None,
                        replicated_batches=False: seen.append(
                            (rank, device, backend, replicated_batches)) or _fake_mesh())
    train.setup_parallelism(cfg(2), rank=1, world=2)
    train.setup_parallelism(_cfg(2, platform="cuda"), rank=1, world=2)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "29500")
    train.setup_parallelism(cfg(2))
    assert seen == [(1, ("cuda", 0), "gloo", True), (1, ("cuda", 1), None, True),
                    (1, ("cuda", 1), None, False)]


def _fake_mesh(world=2, model_axis=1, replicated=False):
    from newsreclib_tpu_torch.parallel.mesh import Mesh

    return Mesh(0, world, model_axis, torch.device("cpu"), "gloo", None, None, replicated)


def test_multi_host_refuses_host_dedup_batches():
    """A multi-host rank holds only its rows, so a per-batch dedup table
    cannot be the global batch's: JAX's ``shard_batch`` refusal."""
    from newsreclib_tpu_torch.data.batching import TrainBatcher
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.models.general_rec import NRMS
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    _, store = _stores()
    _, imp = _imps()
    batch = next(iter(TrainBatcher(store, imp, batch_size=4, max_history_len=5,
                                   u_bucket_min=16).epoch(0)))
    state = create_train_state(NRMS(300, embed_dim=24, num_heads=4, query_dim=8, device="cpu"),
                               make_optimizer())
    t = Trainer(state, cross_entropy_loss, TrainerConfig(ckpt_dir=None), mesh=_fake_mesh())
    with pytest.raises(ValueError, match="global-row batches"):
        t._prepare(batch)


def test_multi_host_adversarial_is_refused_in_jax_words(tmp_path, monkeypatch):
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.config.compose import compose

    data = tmp_path / "demo"
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        (data / split).mkdir(parents=True)
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            (data / split / name).write_bytes((ROOT / "data" / "demo" / split / name)
                                              .read_bytes())
    monkeypatch.delenv("NEWSRECLIB_PLATFORM", raising=False)
    cfg = compose(overrides=["model=senti_debias", "data=mind_demo", "platform=cpu",
                             f"data.data_dir={data}", "data.word_embeddings_fpath=null",
                             f"output_dir={tmp_path / 'out'}", "loggers=[]"])
    rd = train.load_run_data(cfg)
    with pytest.raises(NotImplementedError,
                       match=r"multi-host adversarial \(SentiDebias\) training is not wired"):
        train._build_run(cfg, _fake_mesh(), torch.device("cpu"), rd)


@pytest.mark.parametrize("tp", [False, True])
def test_row_sharding_leaves_the_plm_word_table_whole(tp):
    """Row sharding takes only parameters whose names end in
    ``embedding.weight`` (``mesh.py``'s ``_leaf_spec``): the PLM tower's
    ``word_embeddings.weight`` (and its position and token-type tables) end
    in ``embeddings.weight`` and stay whole on every rank, with or without
    the tensor-parallel tower, as in the JAX package's rule."""
    import jax

    from newsreclib_tpu_torch.convert import flax_to_state_dict
    from newsreclib_tpu_torch.parallel.mesh import shard_specs

    sd = flax_to_state_dict(jax.tree.map(np.asarray, _plm_params()))
    shapes = {k: tuple(v.shape) for k, v in sd.items()}
    tables = [k for k in shapes if k.endswith("embeddings.weight")]
    assert "text_encoder_module.encoder.word_embeddings.weight" in tables
    specs = shard_specs(shapes, 2, row_shard_embeddings=True, tp_transformer=tp)
    assert not any(k in specs for k in tables)
    assert all(k.endswith("embedding.weight") or "layer_" in k for k in specs)


def _refused_state(module):
    from types import SimpleNamespace

    return SimpleNamespace(grid=None, model=module, opt=torch.optim.Adam(module.parameters()))


def _two_model_ranks():
    from newsreclib_tpu_torch.parallel.mesh import Mesh

    return Mesh(rank=0, world=2, model_axis=2, device=torch.device("cpu"), backend="gloo",
                data_group=None, model_group=None)


def test_place_state_refuses_a_row_sharded_table_that_is_not_a_token_embedding():
    """A parameter the row rule takes (a name ending in ``embedding.weight``)
    whose module is not a ``TokenEmbedding`` is refused before anything is
    cut (``place_state``)."""
    from newsreclib_tpu_torch.parallel.mesh import place_state

    module = torch.nn.Module()
    module.embedding = torch.nn.Embedding(10, 4)
    before = module.embedding.weight.detach().clone()
    with pytest.raises(NotImplementedError,
                       match="embedding.weight: row sharding takes TokenEmbedding tables only"):
        place_state(_refused_state(module), _two_model_ranks(), row_shard_embeddings=True)
    assert torch.equal(module.embedding.weight, before)


def test_place_state_refuses_a_layer_parameter_outside_a_transformer_layer():
    """A ``layer_`` parameter the tensor-parallel rule takes (``q``, ``k``,
    ``v``, ``ff1``, ``attn_out``, ``ff2``) whose layer is not the PLM
    tower's ``TransformerLayer`` is refused before anything is cut."""
    from newsreclib_tpu_torch.parallel.mesh import place_state

    module = torch.nn.Module()
    module.layer_0 = torch.nn.Module()
    module.layer_0.q = torch.nn.Linear(4, 4)
    before = module.layer_0.q.weight.detach().clone()
    with pytest.raises(NotImplementedError,
                       match="layer_0.q.weight: tensor parallelism takes the PLM tower only"):
        place_state(_refused_state(module), _two_model_ranks(), row_shard_embeddings=False,
                    tp_transformer=True)
    assert torch.equal(module.layer_0.q.weight, before)
