"""Evaluation and the recommendation export split over the port's data ranks
(``CachedScorer(mesh=...)``, ``Trainer.evaluate`` in single-node mode) on
CPU ranks over gloo, against the JAX package's mesh scorer on its virtual
CPU devices and against the port's one-device run on the same seeded
numpy data and converted parameters.

The ranks run through the port's launcher, as in
``tests/test_torch_port_multiprocess.py`` (whose runner and mesh this file
uses); the rank functions import only numpy and torch at the module's top.
The workload's corpus takes both title-length buckets, and its chunks of 16
rows do not divide evenly, so one rank encodes a piece fewer than the other
(``serving.corpus_pieces``); its impressions fall in several candidate
buckets and several of them belong to one user, so the export overwrites
scores.

Tolerances (float32, the same arithmetic summed in another order): the
epoch metrics within 1e-5 of JAX's mesh scorer and of one device's; the
export's keys equal and its scores within 1e-5.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_port_multiprocess import ROOT, TESTS, TIMEOUT, _load, _mesh, _run

VOCAB, TITLE, N_NEWS, N_IMP, USERS = 400, 30, 150, 60, 20
DIMS = dict(embed_dim=60, num_heads=6, query_dim=16)
EVAL = dict(max_history_len=8, target_cells=64, encode_batch=16)
ATOL = 1e-5
SCORER_CALLS = {"gather_table": 1, "eval_sums": 1, "gather_auc": 1}


def _workload():
    rng = np.random.default_rng(0)
    title = np.zeros((N_NEWS + 1, TITLE), dtype=np.int32)
    for i, n in enumerate(rng.integers(3, TITLE + 1, size=N_NEWS)):
        title[i + 1, :n] = rng.integers(1, VOCAB, size=n)
    store = dict(
        nid2row={f"N{i}": i for i in range(1, N_NEWS + 1)},
        title=title,
        category=np.r_[0, rng.integers(1, 19, size=N_NEWS)].astype(np.int32),
        sentiment=np.r_[0, rng.integers(1, 4, size=N_NEWS)].astype(np.int32),
    )
    hists = [rng.integers(1, N_NEWS + 1, size=int(rng.integers(1, 12))) for _ in range(N_IMP)]
    cands = [rng.integers(1, N_NEWS + 1, size=int(rng.integers(2, 20))) for _ in range(N_IMP)]
    labels = [(rng.random(len(c)) < 0.3).astype(np.int8) for c in cands]
    users = rng.integers(0, USERS, size=N_IMP)
    return store, (hists, cands, labels, users, users + 1000)


def _port_objects(store, lists):
    from newsreclib_tpu_torch.data.batching import Impressions
    from newsreclib_tpu_torch.data.news_store import NewsStore

    return NewsStore(**store), Impressions.from_lists(*lists)


def _port_model(sd):
    from newsreclib_tpu_torch.models.general_rec import NRMS

    model = NRMS(VOCAB, device="cpu", dropout=0.0, **DIMS).eval()
    model.load_state_dict(sd)
    return model


def _ranking():
    from newsreclib_tpu_torch.metrics.collector import RankingMetrics

    return RankingMetrics(num_categ_classes=19, num_sent_classes=4)


# ---------------- rank functions ----------------


def rank_scorer(payload, out):
    """``CachedScorer(mesh=...)``: evaluate with and without the AUC, with
    cross-entropy and SupCon as the loss, and the export; the collectives
    of each call."""
    from newsreclib_tpu_torch.data.batching import Impressions
    from newsreclib_tpu_torch.data.news_store import NewsStore
    from newsreclib_tpu_torch.models.components.losses import get_loss_fn
    from newsreclib_tpu_torch.parallel import collectives
    from newsreclib_tpu_torch.serving import CachedScorer

    p = _load(payload)
    mesh = _mesh()
    store, imp = NewsStore(**p["store"]), Impressions(**p["imp"])
    model = _port_model(p["sd"])
    res = {"metrics": {}, "calls": {}}
    for loss in ("cross_entropy_loss", "sup_con_loss"):
        scorer = CachedScorer(model, ranking=_ranking(), device="cpu",
                              loss_fn=get_loss_fn(loss), mesh=mesh)
        for auc in (True, False):
            collectives.reset_counts()
            res["metrics"][(loss, auc)] = scorer.evaluate(store, imp, collect_auc=auc, **EVAL)
            res["calls"][(loss, auc)] = dict(collectives.calls)
    collectives.reset_counts()
    res["recs"] = CachedScorer(model, device="cpu", mesh=mesh).export_recommendations(
        store, imp, p["recs"], max_history_len=EVAL["max_history_len"],
        encode_batch=EVAL["encode_batch"])
    res["export_calls"] = dict(collectives.calls)
    torch.save(res, f"{out}.{mesh.rank}")


def rank_trainer(payload, out, model_axis, replicated, limit):
    """``Trainer.evaluate`` on a fresh train state of the payload's model:
    the cached path (``limit`` 0) or the streaming path over the first
    ``limit`` batches of an ``EvalBatcher`` whose batches the data ranks
    divide."""
    from newsreclib_tpu_torch.data.batching import EvalBatcher, Impressions
    from newsreclib_tpu_torch.data.news_store import NewsStore
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.parallel import collectives
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    p = _load(payload)
    mesh = _mesh(int(model_axis), replicated == "1")
    store, imp = NewsStore(**p["store"]), Impressions(**p["imp"])
    cfg = TrainerConfig(ckpt_dir=None, limit_eval_batches=int(limit) or None)
    trainer = Trainer(create_train_state(_port_model(p["sd"]), make_optimizer(1e-3)),
                      cross_entropy_loss, cfg, ranking=_ranking(), mesh=mesh)
    batcher = EvalBatcher(store, imp, EVAL["max_history_len"], EVAL["target_cells"],
                          u_bucket_min=16, batch_multiple=2, split_title_len=16)
    collectives.reset_counts()
    metrics = trainer.evaluate(batcher, "val")
    torch.save({"metrics": metrics, "calls": dict(collectives.calls),
                "sharded": sorted(trainer.state.sharded)}, f"{out}.{mesh.rank}")


# ---------------- helpers ----------------


def run_ranks(nprocs, fn_name, *args):
    """``fn_name(*args)`` of this module in ``nprocs`` ranks through the
    port's launcher (``test_torch_port_multiprocess.run_ranks``'s run)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(TESTS), str(ROOT)]),
               OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "newsreclib_tpu_torch.parallel.launch", "--nprocs",
           str(nprocs), "--timeout", str(TIMEOUT), f"{Path(__file__).stem}:{fn_name}",
           *map(str, args)]
    return _run(cmd, env, TIMEOUT)


@pytest.fixture(scope="module")
def workload():
    return _workload()


@pytest.fixture(scope="module")
def jax_side(workload):
    """The JAX NRMS's parameters as the port's state dict, and the JAX
    objects of the workload."""
    import jax

    from newsreclib_tpu.data.batching import Impressions as JImpressions
    from newsreclib_tpu.data.news_store import NewsStore as JNewsStore
    from newsreclib_tpu.data.synthetic import SyntheticConfig, make_batch
    from newsreclib_tpu.models.general_rec import NRMS as JNRMS
    from newsreclib_tpu_torch.convert import flax_to_state_dict

    store, lists = workload
    jm = JNRMS(vocab_size=VOCAB, dropout=0.0, **DIMS)
    init = make_batch(np.random.default_rng(1), batch_size=2, hist_len=4, num_candidates=3,
                      unique_news=8, cfg=SyntheticConfig(vocab_size=VOCAB, title_len=TITLE))
    params = jm.init(jax.random.key(0), init)["params"]
    sd = flax_to_state_dict(jax.tree.map(np.asarray, params))
    return jm, params, JNewsStore(**store), JImpressions.from_lists(*lists), sd


@pytest.fixture(scope="module")
def scorer_ranks(tmp_path_factory, workload, jax_side):
    """``rank_scorer`` on two ranks (once per worker that runs a test of
    it): each rank's results and the directory its export was written to."""
    tmp_path = tmp_path_factory.mktemp("scorer")
    run_ranks(2, "rank_scorer", _payload(tmp_path, workload, jax_side[-1]), tmp_path / "out")
    return _ranks(tmp_path, 2, "out"), tmp_path


def _payload(tmp_path, workload, sd):
    from dataclasses import asdict

    store, lists = workload
    _, imp = _port_objects(store, lists)
    path = tmp_path / "payload.pt"
    torch.save({"store": store, "imp": asdict(imp), "sd": sd,
                "recs": str(tmp_path / "recs_mesh.json")}, path)
    return path


def _ranks(tmp_path, n, name):
    return [_load(f"{tmp_path / name}.{r}") for r in range(n)]


def _close(got, want, atol=ATOL):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert abs(got[k] - want[k]) < atol, (k, got[k], want[k])


def _one_device(workload, sd, loss="cross_entropy_loss", auc=True):
    from newsreclib_tpu_torch.models.components.losses import get_loss_fn
    from newsreclib_tpu_torch.serving import CachedScorer

    store, imp = _port_objects(*workload)
    return CachedScorer(_port_model(sd), ranking=_ranking(), device="cpu",
                        loss_fn=get_loss_fn(loss)).evaluate(store, imp, collect_auc=auc, **EVAL)


# ---------------- tests ----------------


def test_corpus_pieces_split_each_chunk_over_the_ranks():
    """Chunks of 16 rows split in halves of 8 over two ranks; the segment's
    end cuts the last chunk, leaving the second rank without a piece of it;
    one rank takes the chunks whole."""
    from newsreclib_tpu_torch.serving import corpus_pieces

    assert corpus_pieces(37, 16, 2, 0) == [(0, 8), (16, 24), (32, 37)]
    assert corpus_pieces(37, 16, 2, 1) == [(8, 16), (24, 32)]
    assert corpus_pieces(37, 16) == [(0, 16), (16, 32), (32, 37)]
    assert corpus_pieces(37, 15, 2, 1) == [(8, 16), (24, 32)]  # 15 rounds up to 16
    for n, bs, w in ((37, 16, 2), (150, 16, 4), (5, 4096, 2)):
        rows = [r for i in range(w) for lo, hi in corpus_pieces(n, bs, w, i)
                for r in range(lo, hi)]
        assert sorted(rows) == list(range(n))


def test_scorer_on_two_ranks_matches_jax_mesh_and_one_device(workload, jax_side, scorer_ranks):
    """Both ranks' metrics, with and without the AUC, equal JAX's
    ``CachedScorer(mesh=make_mesh(devices[:2]))`` and the port's one-device
    scorer; each call makes one table gather, one all-reduce of the sums
    and (with the AUC) one gather of its inputs."""
    import jax

    from newsreclib_tpu.metrics.collector import RankingMetrics as JRankingMetrics
    from newsreclib_tpu.models.components.losses import cross_entropy_loss as jce
    from newsreclib_tpu.parallel.mesh import make_mesh
    from newsreclib_tpu.serving import CachedScorer as JCachedScorer

    jm, params, jstore, jimp, sd = jax_side
    ranks, _ = scorer_ranks
    scorer = JCachedScorer(jm, ranking=JRankingMetrics(num_categ_classes=19, num_sent_classes=4),
                           loss_fn=jce, mesh=make_mesh(jax.devices()[:2]))
    for auc in (True, False):
        want = scorer.evaluate(params, jstore, jimp, collect_auc=auc, **EVAL)
        one = _one_device(workload, sd, auc=auc)
        assert ("auc" in want) == auc and "loss" in want and "categ_pers@5" in want
        for r in ranks:
            _close(r["metrics"][("cross_entropy_loss", auc)], want)
            _close(r["metrics"][("cross_entropy_loss", auc)], one)
            calls = {k: v for k, v in SCORER_CALLS.items() if auc or k != "gather_auc"}
            assert r["calls"][("cross_entropy_loss", auc)] == calls


def test_scorer_on_two_ranks_takes_supcon_over_the_global_batch(workload, jax_side,
                                                                 scorer_ranks):
    """SupCon is a mean over a batch's nonzero rows, not over its
    impressions: the ranks gather each batch's loss inputs, and the loss is
    one device's."""
    *_, sd = jax_side
    for r in scorer_ranks[0]:
        for auc in (True, False):
            _close(r["metrics"][("sup_con_loss", auc)],
                   _one_device(workload, sd, "sup_con_loss", auc))
        assert r["calls"][("sup_con_loss", True)]["gather_eval_loss"] > 0


def test_export_on_two_ranks_matches_jax_mesh_and_one_device(tmp_path, workload, jax_side,
                                                            scorer_ranks):
    """The export over two ranks: rank 0 writes the file, both return the
    dict of the JAX mesh scorer's export and of one device's (the same
    keys, scores within 1e-5), after one gather of the table and one of
    the ``(position, row, score)`` triples."""
    import jax

    from newsreclib_tpu.parallel.mesh import make_mesh
    from newsreclib_tpu.serving import CachedScorer as JCachedScorer
    from newsreclib_tpu_torch.serving import CachedScorer

    jm, params, jstore, jimp, sd = jax_side
    ranks, written_to = scorer_ranks
    want = JCachedScorer(jm, mesh=make_mesh(jax.devices()[:2])).export_recommendations(
        params, jstore, jimp, str(tmp_path / "recs_jax.json"), EVAL["max_history_len"],
        EVAL["encode_batch"])
    store, imp = _port_objects(*workload)
    one = CachedScorer(_port_model(sd), device="cpu").export_recommendations(
        store, imp, str(tmp_path / "recs_one.json"), EVAL["max_history_len"],
        EVAL["encode_batch"])
    with open(written_to / "recs_mesh.json") as f:
        written = json.load(f)
    assert len(want) == USERS or len(want) > 10
    for got in (written, ranks[0]["recs"], ranks[1]["recs"]):
        for ref in (want, one):
            assert got.keys() == ref.keys()
            for u in ref:
                assert got[u].keys() == ref[u].keys(), u
                np.testing.assert_allclose([got[u][n] for n in ref[u]], list(ref[u].values()),
                                           atol=ATOL, rtol=0, err_msg=u)
    assert ranks[0]["export_calls"] == ranks[1]["export_calls"] == {
        "gather_table": 1, "gather_recs": 1}


@pytest.mark.parametrize("limit", [0, 2], ids=["cached", "streaming_limited"])
def test_trainer_on_two_ranks_returns_one_devices_metrics(tmp_path, workload, jax_side, limit):
    """``Trainer.evaluate`` in single-node mode: both ranks return the
    metrics of a one-device trainer on the same batches, through the cached
    scorer or (``limit_eval_batches``) each rank's rows of the first
    ``EvalBatcher`` batches with ``StreamingEval``'s sums reduced."""
    from newsreclib_tpu_torch.data.batching import EvalBatcher
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.training.state import create_train_state, make_optimizer
    from newsreclib_tpu_torch.training.trainer import Trainer, TrainerConfig

    *_, sd = jax_side
    run_ranks(2, "rank_trainer", _payload(tmp_path, workload, sd), tmp_path / "out", 1, 1,
              limit)
    store, imp = _port_objects(*workload)
    one = Trainer(create_train_state(_port_model(sd), make_optimizer(1e-3)), cross_entropy_loss,
                  TrainerConfig(ckpt_dir=None, limit_eval_batches=limit or None),
                  ranking=_ranking()).evaluate(
        EvalBatcher(store, imp, EVAL["max_history_len"], EVAL["target_cells"], u_bucket_min=16,
                    batch_multiple=2, split_title_len=16), "val")
    assert {"val/auc", "val/loss", "val/mrr"} <= set(one)
    for r in _ranks(tmp_path, 2, "out"):
        _close(r["metrics"], one)
        if limit:
            assert r["calls"] == {"eval_sums": 1, "gather_auc": 1}
        else:
            assert r["calls"] == SCORER_CALLS


def test_trainer_on_a_row_sharded_2x2_grid_returns_one_devices_metrics(tmp_path, workload,
                                                                       jax_side):
    """A 2 x 2 grid with the word table row-sharded: every rank gathers the
    state into its one-device copy and scores its data rank's share; all
    four return one device's metrics."""
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.serving import CachedScorer

    *_, sd = jax_side
    run_ranks(4, "rank_trainer", _payload(tmp_path, workload, sd), tmp_path / "out", 2, 1, 0)
    store, imp = _port_objects(*workload)
    one = CachedScorer(_port_model(sd), ranking=_ranking(), device="cpu",
                       loss_fn=cross_entropy_loss).evaluate(
        store, imp, EVAL["max_history_len"], EVAL["target_cells"])
    for r in _ranks(tmp_path, 4, "out"):
        assert r["sharded"] == ["news_encoder.embedding.weight"]
        _close(r["metrics"], {f"val/{k}": v for k, v in one.items()})
        assert r["calls"]["gather_state"] == 1 and r["calls"]["eval_sums"] == 1


def test_trainer_in_multi_host_mode_evaluates_on_rank_zero(tmp_path, workload, jax_side):
    """Multi-host mode (``replicated_batches`` false) keeps the JAX rule:
    rank 0 scores the whole set with no collective, the other rank returns
    {}."""
    from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
    from newsreclib_tpu_torch.serving import CachedScorer

    *_, sd = jax_side
    run_ranks(2, "rank_trainer", _payload(tmp_path, workload, sd), tmp_path / "out", 1, 0, 0)
    zero, one_rank = _ranks(tmp_path, 2, "out")
    assert one_rank["metrics"] == {} and one_rank["calls"] == {}
    assert zero["calls"] == {}
    store, imp = _port_objects(*workload)
    want = CachedScorer(_port_model(sd), ranking=_ranking(), device="cpu",
                        loss_fn=cross_entropy_loss).evaluate(
        store, imp, EVAL["max_history_len"], EVAL["target_cells"])
    _close(zero["metrics"], {f"val/{k}": v for k, v in want.items()})
