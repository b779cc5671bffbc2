"""The port's multi-rank training on CPU ranks over gloo, against the JAX
package's mesh on its virtual CPU devices (or against one rank on the same
global batches).

Every multi-rank run goes through the port's launcher, ``python -m
newsreclib_tpu_torch.parallel.launch --nprocs N --timeout T
test_torch_port_multiprocess:<rank function> ...`` (or the training CLI
with ``trainer.devices=N platform=cpu``), in its own session: the launcher
kills its ranks when one fails or ``T`` passes, and the test kills the
session when the launcher outlives ``T`` + 30 s.  The rank functions below
import only numpy and torch at the module's top (the ranks never import
JAX); the JAX references run in the test process.  Dropout is 0 against
JAX (the packages draw different masks); the port's own dropout across
ranks is held against one device.

Tolerances (float32, the same arithmetic summed in another order):

* per-step losses within 1e-5 and parameters within 2e-5 of the JAX mesh
  run (the bounds of ``tests/test_parallel.py``); the attention key biases
  are left out of the parameter comparison: their gradient is structurally
  zero (float32 noise, which Adam turns into updates of up to the learning
  rate in both packages);
* the lookup of a row-sharded table within 1e-6 of JAX's, its gradient
  within 1e-6 of the dense lookup's, the clip's norm over its shards within
  a relative 1e-5 of the full gradient's;
* SupCon, the dual loss and CE on two ranks within 1e-6 of the one-rank
  loss on the global batch, gradients within 1e-7;
* SentiDebias's per-step generator and discriminator losses within 1e-4
  of the JAX mesh run (``tests/test_parallel.py``'s bound);
* dropout on, 2 ranks against one device on the same batches: losses
  within 1e-5, the parameters within 1e-2 of one device's update (in norm
  over all of them; a mask drawn at a rank's own shape is off by 0.44 or
  more);
* the CLI: the 2-rank run's logged losses within 1e-5 of one device's, the
  test metrics of a 2 x 2 run within 1e-5 of the port's one-device ``eval``
  of its checkpoint.
"""

import csv
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent
MODULE = Path(__file__).stem
TIMEOUT = 150  # seconds a multi-rank run may take before its ranks are killed

VOCAB, TITLE = 300, 12
EMBED, HEADS, QUERY = 48, 4, 24
LOSS_ATOL, PARAM_ATOL = 1e-5, 2e-5


# ---------------- running ranks ----------------


def run_ranks(nprocs, fn_name, *args, timeout=TIMEOUT):
    """``fn_name(*args)`` of this module in ``nprocs`` ranks through the
    port's launcher; the whole session is killed if it outlives the
    launcher's own deadline."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS), str(ROOT)]),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "newsreclib_tpu_torch.parallel.launch", "--nprocs",
           str(nprocs), "--timeout", str(timeout), f"{MODULE}:{fn_name}", *map(str, args)]
    return _run(cmd, env, timeout)


def _run(cmd, env, timeout):
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout + 30)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    out = out.decode(errors="replace")
    assert proc.returncode == 0, out[-6000:]
    return out


def _mesh(model_axis=1, replicated=True):
    from newsreclib_tpu_torch.parallel.mesh import env_rank, init_mesh

    torch.set_num_threads(1)
    rank, world, _ = env_rank()
    return init_mesh(rank, world, model_axis, torch.device("cpu"), "gloo",
                     replicated_batches=replicated)


def _load(path):
    return torch.load(path, weights_only=False)


class _Cap:
    def __init__(self, *keys):
        self.keys = keys or ("train/loss",)
        self.seen = {k: [] for k in self.keys}

    def log_metrics(self, m, step):
        for k in self.keys:
            if k in m:
                self.seen[k].append(m[k])


class _Fixed:
    def __init__(self, batches):
        self._batches = batches
        self.batch_size = batches[0].labels.shape[0]

    def __len__(self):
        return len(self._batches)

    def epoch(self, _i):
        return iter(self._batches)


def _port_nrms(sd, vocab=VOCAB):
    from newsreclib_tpu_torch.models.general_rec import NRMS

    model = NRMS(vocab, embed_dim=EMBED, num_heads=HEADS, query_dim=QUERY, dropout=0.0,
                 device="cpu")
    model.load_state_dict(sd)
    return model


def _port_plm_nrms(sd):
    from newsreclib_tpu_torch.models.components.plm import PLMTextEncoder, TransformerEncoder
    from newsreclib_tpu_torch.models.general_rec import NRMS

    enc = TransformerEncoder(VOCAB, hidden_dim=32, num_layers=2, num_heads=4,
                             intermediate_dim=64, max_position=64, dropout=0.0)
    tower = PLMTextEncoder(enc, use_mhsa=True, num_heads=4, query_dim=16, dropout=0.0)
    model = NRMS(VOCAB, embed_dim=32, num_heads=4, query_dim=16, dropout=0.0,
                 text_encoder_module=tower, text_encoder_dim=32, device="cpu")
    model.load_state_dict(sd)
    return model


# ---------------- rank functions ----------------


def rank_lookup(payload, out):
    """Row-sharded lookups at 4 and 2 model shards (one 4-rank world, two
    grids), forward and the table's gradient."""
    from newsreclib_tpu_torch.parallel.embedding import sharded_lookup
    from newsreclib_tpu_torch.parallel.mesh import shard_tensor, unshard_tensor
    from newsreclib_tpu_torch.training.state import _sharded_norm

    p = _load(payload)
    res = {}
    for shards in (4, 2):
        mesh = _mesh(model_axis=shards)
        for name, table in p["tables"].items():
            full = torch.tensor(table)
            per = -(-full.shape[0] // shards)
            local = shard_tensor(full, 0, shards, mesh.model_index).requires_grad_()
            out_t = sharded_lookup(local, torch.tensor(p["ids"][name]), mesh.model_index * per,
                                   mesh.model_group)
            out_t.backward(torch.tensor(p["upstream"]))
            grad = unshard_tensor(local.grad, 0, full.shape[0], mesh)
            res[(shards, name)] = (out_t.detach().numpy(), grad.numpy())
            # the clip's global norm: the table's shards once each, a
            # replicated vector once
            vec = torch.nn.Parameter(torch.ones(3))
            vec.grad = torch.full((3,), 0.5)
            res[(shards, name, "norm")] = float(_sharded_norm([local, vec], {id(local)},
                                                              mesh.model_group))
    if mesh.rank == 0:
        torch.save(res, out)


def rank_losses(payload, out):
    """CE, SupCon and the dual loss of the global batch from each rank's
    rows (``global_loss``), and the gradient of the rank's scores."""
    from newsreclib_tpu_torch.data.batch import RecBatch
    from newsreclib_tpu_torch.models.components.losses import get_loss_fn
    from newsreclib_tpu_torch.parallel.collectives import gather_rows
    from newsreclib_tpu_torch.training.steps import global_loss

    p = _load(payload)
    mesh = _mesh()
    b = len(p["scores"]) // mesh.data_size
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    res = {}
    for name in ("cross_entropy_loss", "sup_con_loss", "dual_loss"):
        scores = torch.tensor(p["scores"][rows]).requires_grad_()
        batch = RecBatch(None, None, None, None, torch.tensor(p["mask"][rows]),
                         torch.tensor(p["labels"][rows]), None,
                         torch.tensor(p["valid"][rows]))
        objective, loss = global_loss(get_loss_fn(name), scores, batch, {}, mesh)
        objective.backward()
        grad = gather_rows(scores.grad, mesh.data_group, mesh.data_size, mesh.data_index)
        res[name] = (float(loss), grad.numpy())
    if mesh.rank == 0:
        torch.save(res, out)


def _train_and_save(mesh, trainer, batcher, out, extra=None):
    from newsreclib_tpu_torch.parallel.mesh import gather_state

    cap = trainer.loggers[0]
    trainer.train_epoch(batcher, 0)
    tree = gather_state(trainer.state)  # a collective
    if mesh.rank == 0:
        torch.save({"losses": cap.seen["train/loss"],
                    "params": {k: v.numpy() for k, v in tree["params"].items()},
                    **(extra or {})}, out)


def rank_nrms(payload, out, model_axis, replicated):
    """NRMS through ``Trainer(mesh=...)`` on the payload's batches (host
    dedup batches), or in the multi-host global-row layout from each rank's
    own batcher over its shard of the payload's impressions."""
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    p = _load(payload)
    mesh = _mesh(int(model_axis), replicated == "1")
    state = create_train_state(_port_nrms(p["sd"]),
                               make_optimizer(1e-3, grad_clip_norm=p.get("clip")))
    cfg = TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None)
    corpus = u_bucket = None
    if "store" in p:  # multi-host: this data rank's shard of the impressions
        from newsreclib_tpu_torch.data.batching import Impressions, TrainBatcher
        from newsreclib_tpu_torch.data.news_store import NewsStore
        from newsreclib_tpu_torch.parallel.data import shard_impressions

        store = NewsStore(**p["store"])
        imp = shard_impressions(Impressions(**p["imp"]), mesh.data_index, mesh.data_size)
        batcher = TrainBatcher(store, imp, batch_size=p["global_batch"] // mesh.data_size,
                               max_history_len=p["hist"], neg_sampling_ratio=p["neg_k"],
                               seed=p["seed"] + 7919 * mesh.data_index, global_rows=True,
                               num_steps=p["steps"], u_bucket_min=64)
        corpus = store.features_for(np.arange(store.title.shape[0]))
        u_bucket = batcher.global_u_bucket(p["global_batch"])
    else:
        batcher = _Fixed(p["batches"])
    trainer = Trainer(state, cross_entropy_loss, cfg, loggers=[_Cap()], mesh=mesh,
                      corpus=corpus, u_bucket=u_bucket)
    _train_and_save(mesh, trainer, batcher, out)


def rank_plm_tp(payload, out, frozen):
    """NRMS over a 2-layer PLM tower, tensor-parallel over 2 model ranks."""
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.models.components.plm import plm_freeze_labels
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    p = _load(payload)
    mesh = _mesh(model_axis=2)
    model = _port_plm_nrms(p["sd"])
    labels = (plm_freeze_labels((n for n, _ in model.named_parameters()), [0])
              if frozen == "1" else None)
    state = create_train_state(model, make_optimizer(1e-3, freeze_labels=labels))
    cfg = TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None, tp_transformer=True)
    trainer = Trainer(state, cross_entropy_loss, cfg, loggers=[_Cap()], mesh=mesh)
    local = {k: tuple(v.shape) for k, v in trainer.model.state_dict().items()}
    _train_and_save(mesh, trainer, _Fixed(p["batches"]), out, {"local_shapes": local})


def rank_senti_debias(payload, out):
    """SentiDebias's alternating step, data-parallel over 2 ranks."""
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.models.fair_rec import create_sentidebias_state
    from newsreclib_tpu_torch.models.fair_rec.senti_debias import (
        SentiDebiasDiscriminator,
        SentiDebiasGenerator,
    )
    from newsreclib_tpu_torch.training.adversarial import AdversarialTrainer
    from newsreclib_tpu_torch.training.trainer import TrainerConfig

    p = _load(payload)
    mesh = _mesh()
    gen = SentiDebiasGenerator(200, num_sent_classes=3, embed_dim=24, num_heads=4,
                               query_dim=12, sent_embed_dim=8, dropout=0.0, device="cpu")
    gen.load_state_dict(p["g"])
    disc = SentiDebiasDiscriminator(in_dim=24, hidden_dim=16, num_sent_classes=3, device="cpu")
    disc.load_state_dict(p["d"])
    cap = _Cap("train/g_loss", "train/d_loss")
    trainer = AdversarialTrainer(create_sentidebias_state(gen, disc, seed=0), cross_entropy_loss,
                                 TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None),
                                 loggers=[cap], mesh=mesh)
    trainer.fit(_Fixed(p["batches"]))
    if mesh.rank == 0:
        torch.save(cap.seen, out)


# the dropout test's models, small, dropout on: each draws over batch rows
# (NPA's user projections and per-slot title encoder, LSTUR's user masking,
# CenNewsRec's and CAUM's user encoders), or, "tp", a 2-layer tower whose
# attention dropout splits by heads over 2 model ranks
DROPOUT_MODELS = {
    "npa": ("NPA", dict(num_users=1000, text_embed_dim=6, user_embed_dim=5, num_filters=8,
                        word_pref_query_dim=7, news_pref_query_dim=4, dropout=0.3)),
    "lstur": ("LSTUR", dict(num_users=1000, text_embed_dim=6, categ_embed_dim=4,
                            num_filters=8, query_dim=4, dropout=0.3,
                            user_masking_probability=0.5)),
    "cen_news_rec": ("CenNewsRec", dict(embed_dim=8, num_heads=2, num_filters=8, query_dim=4,
                                        gru_hidden_dim=8, num_recent_news=3, dropout=0.3)),
    "caum": ("CAUM", dict(entity_vocab_size=800, text_embed_dim=8, text_num_heads=2,
                          categ_embed_dim=4, news_embed_dim=8, entity_embed_dim=4,
                          query_dim=4, dense_att_hidden_dim1=8, dense_att_hidden_dim2=6,
                          user_vector_dim=8, num_filters=8, dropout=0.3)),
    "tp": (None, None),
}
DROPOUT_UPDATE_RTOL = 1e-2


def _dropout_model(name):
    from newsreclib_tpu_torch.models import general_rec
    from newsreclib_tpu_torch.models.components.plm import PLMTextEncoder, TransformerEncoder

    cls, kwargs = DROPOUT_MODELS[name]
    g = torch.Generator().manual_seed(0)
    if name == "tp":
        enc = TransformerEncoder(VOCAB, hidden_dim=32, num_layers=2, num_heads=4,
                                 intermediate_dim=64, max_position=64, dropout=0.3, generator=g)
        tower = PLMTextEncoder(enc, use_mhsa=True, num_heads=4, query_dim=16, dropout=0.0,
                               generator=g)
        return general_rec.NRMS(VOCAB, embed_dim=32, num_heads=4, query_dim=16, dropout=0.0,
                                text_encoder_module=tower, text_encoder_dim=32, device="cpu",
                                generator=g)
    return getattr(general_rec, cls)(VOCAB, **kwargs, device="cpu", generator=g)


def _dropout_batches():
    from newsreclib_tpu_torch.data.synthetic import SyntheticConfig, make_batch

    rng = np.random.default_rng(11)
    cfg = SyntheticConfig(vocab_size=VOCAB, title_len=TITLE)
    return [make_batch(rng, batch_size=8, hist_len=6, num_candidates=5, unique_news=32,
                       cfg=cfg) for _ in range(3)]


def _dropout_run(name, mesh=None):
    """Three train steps of ``_dropout_model(name)`` on ``_dropout_batches``
    (on ``mesh``, or on one device): the losses and the full parameters."""
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.parallel.mesh import gather_state
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    state = create_train_state(_dropout_model(name), make_optimizer(1e-3), dropout_seed=5)
    cfg = TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None,
                        tp_transformer=name == "tp")
    trainer = Trainer(state, cross_entropy_loss, cfg, loggers=[_Cap()], mesh=mesh)
    trainer.train_epoch(_Fixed(_dropout_batches()), 0)
    tree = gather_state(trainer.state, with_opt=False)  # a collective on a mesh
    return trainer.loggers[0].seen["train/loss"], {k: v.detach().numpy().copy()
                                                   for k, v in tree["params"].items()}


def rank_dropout(name, out):
    """``_dropout_run`` on 2 ranks: data-parallel, or for ``tp`` over 2
    model ranks."""
    mesh = _mesh(model_axis=2 if name == "tp" else 1)
    losses, params = _dropout_run(name, mesh)
    if mesh.rank == 0:
        torch.save({"losses": losses, "params": params}, out)


# ---------------- the JAX side ----------------


def _jax_batches(n_batches, batch_size=8, vocab=VOCAB, seed=7, title=TITLE):
    from newsreclib_tpu.data.synthetic import SyntheticConfig, make_batch

    cfg = SyntheticConfig(vocab_size=vocab, title_len=title)
    rng = np.random.default_rng(seed)
    return [make_batch(rng, batch_size=batch_size, hist_len=6, num_candidates=5,
                       unique_news=32, cfg=cfg) for _ in range(n_batches)]


def _port_batch(b):
    from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch

    fields = b._asdict()
    for seg in ("news", "news2"):
        if fields[seg] is not None:
            fields[seg] = NewsFeatures(*(None if v is None else np.asarray(v)
                                         for v in fields[seg]))
    return RecBatch(**{k: v if k in ("news", "news2") or v is None else np.asarray(v)
                       for k, v in fields.items()})


class _JCap:
    def __init__(self, *keys):
        self.keys = keys or ("train/loss",)
        self.seen = {k: [] for k in self.keys}

    def log_metrics(self, m, step):
        for k in self.keys:
            if k in m:
                self.seen[k].append(m[k])


def _jax_train(model, state, batches, mesh, tp=False):
    """Per-step losses and final parameters (as the port's state dict) of
    the JAX ``Trainer`` on ``mesh``."""
    import jax

    from newsreclib_tpu.models.components.losses import cross_entropy_loss
    from newsreclib_tpu.training.trainer import Trainer, TrainerConfig
    from newsreclib_tpu_torch.convert import flax_to_state_dict

    cap = _JCap()
    tc = TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None, tp_transformer=tp)
    t = Trainer(state, cross_entropy_loss, tc, loggers=[cap], mesh=mesh, model=model)
    t.train_epoch(_Fixed(batches), 0)
    params = flax_to_state_dict(jax.tree.map(np.asarray, t.state.params))
    return cap.seen["train/loss"], {k: v.numpy() for k, v in params.items()}


def _initial_sd(state):
    import jax

    from newsreclib_tpu_torch.convert import flax_to_state_dict

    return flax_to_state_dict(jax.tree.map(np.asarray, state.params))


def _jax_nrms(example, vocab=VOCAB, seed=3, clip=None):
    import jax

    from newsreclib_tpu.models.general_rec import NRMS
    from newsreclib_tpu.training.state import create_train_state, make_optimizer

    model = NRMS(vocab_size=vocab, embed_dim=EMBED, num_heads=HEADS, query_dim=QUERY,
                 dropout=0.0)
    return model, create_train_state(model, example, jax.random.key(seed),
                                     make_optimizer(1e-3, grad_clip_norm=clip))


def _key_bias_free(name, value):
    """``value`` without its attention key biases (module doc)."""
    if name.endswith("qkv.bias"):
        d = value.shape[0] // 3
        return np.concatenate([value[:d], value[2 * d:]])
    if name.endswith(".k.bias"):
        return value[:0]
    return value


def _assert_params(got, want, atol=PARAM_ATOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_key_bias_free(k, got[k]), _key_bias_free(k, want[k]),
                                   atol=atol, err_msg=k)


# ---------------- tests ----------------


def test_sharded_lookup_matches_jax_at_2_and_4_shards(tmp_path):
    """Tables of 64 rows (JAX's ``sharded_lookup`` on ``make_mesh(...,
    model_axis=k)``) and of 66 rows, which 4 does not divide (JAX asserts
    there; GSPMD's padded layout computes the dense lookup)."""
    import jax
    import jax.numpy as jnp

    from newsreclib_tpu.parallel.embedding import sharded_lookup
    from newsreclib_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    tables = {"even": rng.normal(size=(64, 16)).astype(np.float32),
              "padded": rng.normal(size=(66, 16)).astype(np.float32)}
    ids_even = rng.integers(0, 64, size=(5, 7)).astype(np.int32)
    ids_even[0, :2] = [63, 0]
    ids = {"even": ids_even, "padded": ids_even.copy()}
    ids["padded"][0, :2] = [65, 64]  # rows of the last, padded shard
    upstream = rng.normal(size=(5, 7, 16)).astype(np.float32)
    payload = tmp_path / "lookup.pt"
    torch.save({"tables": tables, "ids": ids, "upstream": upstream}, payload)
    run_ranks(4, "rank_lookup", payload, tmp_path / "out.pt")
    got = _load(tmp_path / "out.pt")
    for shards in (4, 2):
        mesh = make_mesh(jax.devices()[:shards], model_axis=shards)
        for name, table in tables.items():
            out, grad = got[(shards, name)]
            dense = lambda t: jnp.take(t, jnp.asarray(ids[name]), axis=0)  # noqa: E731
            want, vjp = jax.vjp(dense, jnp.asarray(table))
            np.testing.assert_allclose(out, np.asarray(want), atol=1e-6)
            np.testing.assert_allclose(grad, np.asarray(vjp(jnp.asarray(upstream))[0]),
                                       atol=1e-6)
            full_norm = np.sqrt(np.sum(np.square(grad, dtype=np.float64)) + 3 * 0.25)
            assert abs(got[(shards, name, "norm")] - full_norm) < 1e-5 * full_norm
            if name == "even":
                jout = sharded_lookup(jnp.asarray(table), jnp.asarray(ids[name]), mesh)
                np.testing.assert_allclose(out, np.asarray(jout), atol=1e-6)


def test_global_batch_losses_on_two_ranks(tmp_path):
    """SupCon, the dual loss and CE from two ranks' rows equal the one-rank
    loss of the global batch, and so do the gradients of the scores; rows
    of unequal valid counts on the two ranks (a mean of the ranks' means
    would differ)."""
    from newsreclib_tpu_torch.models.components.losses import get_loss_fn

    rng = np.random.default_rng(1)
    b, c = 8, 5
    scores = rng.normal(size=(b, c)).astype(np.float32)
    labels = np.zeros((b, c), np.float32)
    labels[np.arange(b), rng.integers(0, c, b)] = 1.0
    labels[1, 3] = 1.0  # two positives in one row
    mask = np.ones((b, c), bool)
    mask[2, 3:] = False
    valid = np.ones(b, bool)
    valid[[5, 6, 7]] = False  # rank 1 holds one valid row, rank 0 four
    payload = tmp_path / "losses.pt"
    torch.save({"scores": scores, "labels": labels, "mask": mask, "valid": valid}, payload)
    run_ranks(2, "rank_losses", payload, tmp_path / "out.pt")
    got = _load(tmp_path / "out.pt")
    for name, (loss, grad) in got.items():
        s = torch.tensor(scores).requires_grad_()
        want = get_loss_fn(name)(s, torch.tensor(labels), torch.tensor(mask),
                                 torch.tensor(valid))
        want.backward()
        assert abs(loss - want.item()) < 1e-6, name
        np.testing.assert_allclose(grad, s.grad.numpy(), atol=1e-7, err_msg=name)


def test_nrms_two_ranks_matches_jax_mesh(tmp_path):
    """Single-node data parallelism: 2 ranks over the same host-dedup
    batches (each keeps its rows and the whole news table) against JAX's
    ``Trainer(mesh=make_mesh(devices[:2]))``."""
    import jax

    from newsreclib_tpu.parallel.mesh import make_mesh

    batches = _jax_batches(6)
    model, state = _jax_nrms(batches[0])
    payload = tmp_path / "nrms.pt"
    torch.save({"sd": _initial_sd(state), "batches": [_port_batch(b) for b in batches]},
               payload)
    run_ranks(2, "rank_nrms", payload, tmp_path / "out.pt", 1, 1)
    got = _load(tmp_path / "out.pt")
    losses, params = _jax_train(model, state, batches, make_mesh(jax.devices()[:2]))
    np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL)
    _assert_params(got["params"], params)


def test_nrms_row_sharded_2x2_matches_jax_mesh(tmp_path):
    """A 2 x 2 (data x model) grid with the word table row-sharded against
    JAX's ``make_mesh(devices[:4], model_axis=2)``, with a global-norm clip
    of 0.01 (below the gradients' norm of about 0.036, so every step clips;
    the norm counts the table's two shards once each): the gathered
    parameters are JAX's."""
    import jax

    from newsreclib_tpu.parallel.mesh import make_mesh

    batches = _jax_batches(4)
    model, state = _jax_nrms(batches[0], clip=0.01)
    payload = tmp_path / "nrms.pt"
    torch.save({"sd": _initial_sd(state), "batches": [_port_batch(b) for b in batches],
                "clip": 0.01}, payload)
    run_ranks(4, "rank_nrms", payload, tmp_path / "out.pt", 2, 1)
    got = _load(tmp_path / "out.pt")
    losses, params = _jax_train(model, state, batches,
                                make_mesh(jax.devices()[:4], model_axis=2))
    np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL)
    _assert_params(got["params"], params)


def test_multi_host_global_rows_matches_jax(tmp_path):
    """Multi-host mode on 2 ranks: each rank's strided impression shard, its
    own global-row batcher (seed + 7919 x rank, ``num_steps``) and the
    on-device dedup of the gathered global batch, against one JAX process
    with ``Trainer(corpus=..., u_bucket=...)`` over the process-order
    concatenation of the two shards' batches (``tests/test_multihost.py``)."""
    import jax

    sys.path.insert(0, str(TESTS / "helpers"))
    import mp_worker

    from newsreclib_tpu.data.batching import TrainBatcher
    from newsreclib_tpu.models.components.losses import cross_entropy_loss
    from newsreclib_tpu.parallel.data import shard_impressions
    from newsreclib_tpu.training.trainer import Trainer, TrainerConfig
    from newsreclib_tpu_torch.convert import flax_to_state_dict

    steps, gb = 5, mp_worker.GLOBAL_BATCH
    store, imp = mp_worker.build_data()
    kw = dict(batch_size=gb // 2, max_history_len=mp_worker.HIST,
              neg_sampling_ratio=mp_worker.NEG_K, u_bucket_min=64)
    shards = [TrainBatcher(store, shard_impressions(imp, p, 2), seed=mp_worker.SEED + 7919 * p,
                           global_rows=True, num_steps=steps, **kw) for p in range(2)]
    u_bucket = shards[0].global_u_bucket(gb)
    global_batches = [jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), b0, b1)
                      for b0, b1 in zip(shards[0].epoch(0), shards[1].epoch(0))]
    example = next(iter(TrainBatcher(store, shard_impressions(imp, 0, 2), seed=mp_worker.SEED,
                                     **kw).epoch(0)))
    model, state = _jax_nrms(example, seed=mp_worker.SEED)
    payload = tmp_path / "mh.pt"
    torch.save({"sd": _initial_sd(state),
                "store": {"nid2row": store.nid2row, "title": store.title,
                          "category": store.category, "sentiment": store.sentiment},
                "imp": {k: getattr(imp, k) for k in imp.__dataclass_fields__},
                "global_batch": gb, "hist": mp_worker.HIST, "neg_k": mp_worker.NEG_K,
                "seed": mp_worker.SEED, "steps": steps}, payload)
    run_ranks(2, "rank_nrms", payload, tmp_path / "out.pt", 1, 0)
    got = _load(tmp_path / "out.pt")

    cap = _JCap()
    corpus = store.features_for(np.arange(store.title.shape[0]))
    t = Trainer(state, cross_entropy_loss,
                TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None),
                loggers=[cap], corpus=corpus, u_bucket=u_bucket)
    t.train_epoch(_Fixed(global_batches), 0)
    assert len(got["losses"]) == steps
    np.testing.assert_allclose(got["losses"], cap.seen["train/loss"], atol=LOSS_ATOL)
    want = {k: v.numpy() for k, v in
            flax_to_state_dict(jax.tree.map(np.asarray, t.state.params)).items()}
    _assert_params(got["params"], want)


@pytest.mark.parametrize("frozen", [False, True])
def test_tp_transformer_matches_jax(tmp_path, frozen):
    """NRMS over a 2-layer PLM tower, tensor-parallel over 2 model ranks
    (q / k / v / ff1 column-, attn_out / ff2 row-parallel), with and without
    layer 0 frozen, against JAX's TP path on ``make_mesh(devices[:2],
    model_axis=2)``; frozen parameters stay bit-identical."""
    import jax

    from newsreclib_tpu.models.components.plm import (
        PLMTextEncoder,
        TransformerEncoder,
        plm_freeze_labels,
    )
    from newsreclib_tpu.models.general_rec import NRMS
    from newsreclib_tpu.parallel.mesh import make_mesh
    from newsreclib_tpu.training.state import create_train_state, make_optimizer

    batches = _jax_batches(3)
    enc = TransformerEncoder(vocab_size=VOCAB, hidden_dim=32, num_layers=2, num_heads=4,
                             intermediate_dim=64, max_position=64, dropout=0.0)
    tower = PLMTextEncoder(encoder=enc, use_mhsa=True, num_heads=4, query_dim=16, dropout=0.0)
    model = NRMS(vocab_size=VOCAB, embed_dim=32, num_heads=4, query_dim=16, dropout=0.0,
                 text_encoder_module=tower)
    opt = (lambda params: make_optimizer(1e-3, freeze_labels=plm_freeze_labels(
        params, frozen_layers=[0]))) if frozen else make_optimizer(1e-3)
    state = create_train_state(model, batches[0], jax.random.key(3), opt)
    initial = _initial_sd(state)
    payload = tmp_path / "plm.pt"
    torch.save({"sd": initial, "batches": [_port_batch(b) for b in batches]}, payload)
    run_ranks(2, "rank_plm_tp", payload, tmp_path / "out.pt", int(frozen))
    got = _load(tmp_path / "out.pt")
    q = "text_encoder_module.encoder.layer_1.q.weight"
    assert got["local_shapes"][q] == (16, 32)  # two of the four heads
    assert got["local_shapes"]["text_encoder_module.encoder.layer_1.ff2.weight"] == (32, 32)
    losses, params = _jax_train(model, state, batches,
                                make_mesh(jax.devices()[:2], model_axis=2), tp=True)
    np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL)
    _assert_params(got["params"], params)
    if frozen:
        for k, v in initial.items():
            if ".layer_0." in k:
                np.testing.assert_array_equal(got["params"][k], v.numpy(), err_msg=k)


def test_senti_debias_two_ranks_matches_jax_mesh(tmp_path):
    """SentiDebias's alternating G / D steps, data-parallel over 2 ranks,
    against JAX's ``AdversarialTrainer`` on ``make_mesh(devices[:2])``."""
    import jax

    from newsreclib_tpu.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu.models import fair_rec
    from newsreclib_tpu.models.components.losses import cross_entropy_loss
    from newsreclib_tpu.models.fair_rec import create_sentidebias_state
    from newsreclib_tpu.parallel.mesh import make_mesh
    from newsreclib_tpu.training.adversarial import AdversarialTrainer
    from newsreclib_tpu.training.trainer import TrainerConfig
    from newsreclib_tpu_torch.convert import flax_to_state_dict

    cfg = SyntheticConfig(vocab_size=200, title_len=10)
    rng = np.random.default_rng(5)
    batches = [make_batch(rng, batch_size=8, hist_len=5, num_candidates=5, unique_news=24,
                          cfg=cfg) for _ in range(3)]
    gen = fair_rec.SentiDebiasGenerator(vocab_size=200, num_sent_classes=3, embed_dim=24,
                                        num_heads=4, query_dim=12, sent_embed_dim=8,
                                        dropout=0.0)
    disc = fair_rec.SentiDebiasDiscriminator(hidden_dim=16, num_sent_classes=3)
    state = create_sentidebias_state(gen, disc, batches[0], jax.random.key(0))
    payload = tmp_path / "sd.pt"
    torch.save({"g": flax_to_state_dict(jax.tree.map(np.asarray, state.g.params)),
                "d": flax_to_state_dict(jax.tree.map(np.asarray, state.d.params)),
                "batches": [_port_batch(b) for b in batches]}, payload)
    run_ranks(2, "rank_senti_debias", payload, tmp_path / "out.pt")
    got = _load(tmp_path / "out.pt")
    cap = _JCap("train/g_loss", "train/d_loss")
    t = AdversarialTrainer(state, cross_entropy_loss,
                           TrainerConfig(max_epochs=1, log_every_n_steps=1, ckpt_dir=None),
                           loggers=[cap], mesh=make_mesh(jax.devices()[:2]))
    t.fit(_Fixed(batches))
    for k in ("train/g_loss", "train/d_loss"):
        assert len(got[k]) == len(cap.seen[k]) == len(batches) + 1  # the steps, the epoch
        np.testing.assert_allclose(got[k], cap.seen[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", sorted(DROPOUT_MODELS))
def test_dropout_on_two_ranks_draws_one_devices_masks(tmp_path, name):
    """Dropout on (rate 0.3; LSTUR's user masking 0.5): 2 ranks draw the
    masks of one device's step on the global batch (each draws over the
    global batch's rows, or over all the heads, and keeps its part), so
    their per-step losses are one device's on the same batches within
    1e-5, and their parameters' distance from one device's is within
    ``DROPOUT_UPDATE_RTOL`` of one device's update (norms over every
    parameter but the attention key biases, as above).  In norm, not
    element by element: Adam turns the float32 noise of a small gradient
    element into an update of up to the learning rate (the tower's user
    attention bias: one element 6e-5 off, the rest within 4e-6).  Measured
    on the CPU: 1.1e-7 to 1.7e-4 of the update; with every rank drawing at
    its own shape, 0.44 to 1.25."""
    run_ranks(2, "rank_dropout", name, tmp_path / "out.pt")
    got = _load(tmp_path / "out.pt")
    losses, params = _dropout_run(name)
    assert len(got["losses"]) == len(losses) == 3
    np.testing.assert_allclose(got["losses"], losses, atol=LOSS_ATOL)
    start = {k: v.detach().numpy() for k, v in _dropout_model(name).state_dict().items()}
    assert set(got["params"]) == set(params) == set(start)
    off = update = 0.0
    for k in params:
        a, b, s0 = (_key_bias_free(k, t[k]).astype(np.float64)
                    for t in (got["params"], params, start))
        off += np.sum((a - b) ** 2)
        update += np.sum((b - s0) ** 2)
    assert np.sqrt(off) <= DROPOUT_UPDATE_RTOL * np.sqrt(update), np.sqrt(off / update)


# ---------------- the training CLI ----------------


def _demo_copy(dst: Path) -> Path:
    for split in ("train", "dev"):
        d = dst / f"MINDdemo_{split}"
        d.mkdir(parents=True)
        for name in ("news.tsv", "behaviors.tsv", "entity_embedding.vec"):
            (d / name).write_bytes((ROOT / "data" / "demo" / d.name / name).read_bytes())
    (dst / "glove_demo.txt").write_bytes((ROOT / "data" / "demo" / "glove_demo.txt").read_bytes())
    return dst


CLI = ["experiment=nrms_demo", "platform=cpu", "model.dropout_probability=0",
       "trainer.max_epochs=2", "trainer.limit_train_batches=3", "trainer.log_every_n_steps=1"]


def _cli(tmp_path: Path, name: str, *extra, module="train"):
    data = _demo_copy(tmp_path / f"data_{name}")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("NEWSRECLIB_PLATFORM", None)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    _run([sys.executable, "-m", f"newsreclib_tpu_torch.{module}", *CLI,
          f"data.data_dir={data}", f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
          f"output_dir={tmp_path / name}", *extra], env, TIMEOUT)
    with open(tmp_path / name / "metrics.csv") as f:
        return list(csv.DictReader(f))


def test_cli_two_ranks_logs_once_and_matches_one_device(tmp_path):
    """``trainer.devices=2 platform=cpu``: the CLI starts 2 ranks, exits 0,
    rank 0 alone logs (each step's row once) and saves (best and last
    once), and the logged losses are one device's."""
    rows = _cli(tmp_path, "two", "trainer.devices=2")
    one = _cli(tmp_path, "one", "trainer.devices=1")
    steps = [(r["epoch"], r["step"]) for r in rows if r.get("train/loss")]
    assert len(steps) == len(set(steps)) == 2 * (3 + 1)  # steps and epoch ends
    assert [r["step"] for r in rows] == [r["step"] for r in one]
    for r2, r1 in zip(rows, one):
        for k in ("train/loss", "val/loss", "val/auc", "test/auc"):
            if r1.get(k):
                assert abs(float(r2[k]) - float(r1[k])) < LOSS_ATOL, (k, r2[k], r1[k])
    ckpts = sorted(p.name for p in (tmp_path / "two" / "checkpoints").iterdir())
    assert ckpts == ["best.json", "best.pt", "last.json", "last.pt"]
    with open(tmp_path / "two" / "hparams.json") as f:
        assert json.load(f)["param_count"] > 0


def test_cli_2x2_checkpoint_evaluates_on_one_device(tmp_path):
    """A 2 x 2 run with the word table row-sharded: rank 0's test metrics
    (the best checkpoint restored, gathered and scored on its device) equal
    the port's one-device ``eval`` of the full checkpoint the run wrote."""
    rows = _cli(tmp_path, "grid", "trainer.devices=4", "trainer.model_axis=2")
    test = next(r for r in rows if r.get("test/auc"))
    state = torch.load(tmp_path / "grid" / "checkpoints" / "best.pt", weights_only=True)
    table = state["params"]["news_encoder.embedding.weight"]
    moments = state["opt_state"]["state"]
    assert any(v["exp_avg"].shape == table.shape for v in moments.values())
    evaluated = _cli(tmp_path, "eval", f"ckpt_path={tmp_path / 'grid' / 'checkpoints'}",
                     module="eval")
    got = next(r for r in evaluated if r.get("test/auc"))
    for k, v in test.items():
        if k.startswith("test/"):
            assert abs(float(got[k]) - float(v)) < LOSS_ATOL, (k, got[k], v)
