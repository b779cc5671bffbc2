"""The port's cached serving against the JAX package's ``CachedScorer`` on the
same store, impressions and parameters, at a size where the corpus encode
takes both title-length buckets and impressions fall in several candidate
buckets.

Tolerances (float32): 1e-5 on the news-vector table (the same arithmetic in
another order) and 1e-4 on the epoch metrics, which are means of
per-impression values over float32 sums.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from newsreclib_tpu.data.batching import Impressions as JImpressions
from newsreclib_tpu.data.news_store import NewsStore as JNewsStore
from newsreclib_tpu.data.synthetic import SyntheticConfig, make_batch
from newsreclib_tpu.models.general_rec import NRMS as JNRMS
from newsreclib_tpu.serving import CachedScorer as JCachedScorer
from newsreclib_tpu.serving import GlobalEvalBatcher as JGlobalEvalBatcher
from newsreclib_tpu.serving import build_news_vector_table as jbuild_table
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data.batching import BucketedAssembler, Impressions
from newsreclib_tpu_torch.data.news_store import NewsStore
from newsreclib_tpu_torch.models.general_rec import NRMS
from newsreclib_tpu_torch.serving import CachedScorer, build_news_vector_table, corpus_segments

VOCAB, TITLE, N_NEWS, N_IMP = 400, 30, 150, 60
DIMS = dict(embed_dim=60, num_heads=6, query_dim=16)
EVAL = dict(max_history_len=8, target_cells=64, encode_batch=16)


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(0)
    title = np.zeros((N_NEWS + 1, TITLE), dtype=np.int32)
    for i, n in enumerate(rng.integers(3, TITLE + 1, size=N_NEWS)):
        title[i + 1, :n] = rng.integers(1, VOCAB, size=n)
    arrays = dict(
        nid2row={f"N{i}": i for i in range(1, N_NEWS + 1)},
        title=title,
        category=np.r_[0, rng.integers(1, 19, size=N_NEWS)].astype(np.int32),
        sentiment=np.r_[0, rng.integers(1, 4, size=N_NEWS)].astype(np.int32),
    )
    hists = [rng.integers(1, N_NEWS + 1, size=int(rng.integers(1, 12))) for _ in range(N_IMP)]
    cands = [rng.integers(1, N_NEWS + 1, size=int(rng.integers(2, 20))) for _ in range(N_IMP)]
    labels = [(rng.random(len(c)) < 0.3).astype(np.int8) for c in cands]
    lists = (hists, cands, labels, np.arange(N_IMP))

    jm = JNRMS(vocab_size=VOCAB, **DIMS)
    cfg = SyntheticConfig(vocab_size=VOCAB, title_len=TITLE)
    init_batch = make_batch(rng, batch_size=2, hist_len=4, num_candidates=3, unique_news=8,
                            cfg=cfg)
    params = jm.init(jax.random.key(0), init_batch)["params"]
    tm = NRMS(VOCAB, device="cpu", **DIMS).eval()
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return (
        (jm, params, JNewsStore(**arrays), JImpressions.from_lists(*lists)),
        (tm, NewsStore(**arrays), Impressions.from_lists(*lists)),
    )


def test_corpus_encode_takes_both_length_buckets(workload):
    _, (_, store, _) = workload
    (short, w_short), (long_, w_long) = corpus_segments(store, 16, 16)
    assert (w_short, w_long) == (16, TITLE)
    assert len(short) + len(long_) == N_NEWS + 1 and 0 in short
    assert corpus_segments(store, None)[0][1] == TITLE


def test_news_vector_table_matches_jax(workload):
    (jm, params, jstore, _), (tm, store, _) = workload
    want = np.asarray(jbuild_table(jm, params, jstore, batch_size=16))
    got = build_news_vector_table(tm, store, batch_size=16, device="cpu")
    assert got.shape == (N_NEWS + 1, DIMS["embed_dim"])
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_global_eval_batches_match_jax(workload):
    (_, _, _, jimp), (_, _, imp) = workload
    want = list(JGlobalEvalBatcher(jimp, 8, 64))
    got = list(BucketedAssembler(imp, 8, 64))
    assert len(got) == len(want) > 2
    assert len({b.cand_idx.shape for b in got}) > 1  # several candidate buckets
    for g, w in zip(got, want):
        for name in ("hist_idx", "hist_mask", "cand_idx", "cand_mask", "labels", "user_idx",
                     "impression_valid"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name), err_msg=name)


@pytest.mark.parametrize("collect_auc", [True, False])
def test_cached_scorer_matches_jax(workload, collect_auc):
    (jm, params, jstore, jimp), (tm, store, imp) = workload
    want = JCachedScorer(jm).evaluate(params, jstore, jimp, collect_auc=collect_auc, **EVAL)
    got = CachedScorer(tm, device="cpu").evaluate(store, imp, collect_auc=collect_auc, **EVAL)
    assert set(got) == set(want) and ("auc" in got) == collect_auc
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


def test_cached_scorer_bf16_is_close_and_leaves_model_alone(workload):
    """compute_dtype casts a copy of the model; bf16 metrics stay near f32."""
    _, (tm, store, imp) = workload
    f32 = CachedScorer(tm, device="cpu").evaluate(store, imp, **EVAL)
    bf16 = CachedScorer(tm, compute_dtype="bfloat16", device="cpu").evaluate(store, imp, **EVAL)
    assert all(p.dtype == torch.float32 for p in tm.parameters()) and not tm.training
    assert all(np.isfinite(v) for v in bf16.values())
    assert abs(bf16["auc"] - f32["auc"]) < 0.05


def test_subset_keeps_the_first_impressions(workload):
    _, (_, _, imp) = workload
    sub = imp.subset(10)
    assert len(sub) == 10
    for i in range(10):
        np.testing.assert_array_equal(sub.hist(i), imp.hist(i))
        np.testing.assert_array_equal(sub.cands(i)[0], imp.cands(i)[0])


def test_entry_points_refuse_to_fall_back_to_cpu(workload):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, (tm, store, _) = workload
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CachedScorer(tm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_news_vector_table(tm, store)


class _JNRMSWithMargin(JNRMS):
    """The JAX NRMS declaring a title-split margin, as DKN does."""

    TITLE_SPLIT_MARGIN = 4


def _jax_segments(cache, jstore, batch_size, split):
    """The JAX corpus encode's ``[(rows, title_width), ...]``, read from its
    corpus cache after a call."""
    _, parts = cache[(id(jstore), batch_size, None, split)]
    return [(np.asarray(rows), int(st.title.shape[-1])) for rows, st in parts]


def _record_segments(monkeypatch):
    """Record every ``corpus_segments`` result the port's serving computes."""
    from newsreclib_tpu_torch import serving

    seen, real = [], serving.corpus_segments

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append([(np.asarray(rows), width) for rows, width in out])
        return out

    monkeypatch.setattr(serving, "corpus_segments", record)
    return seen


def _assert_same_segments(got, want):
    assert [w for _, w in got] == [w for _, w in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", [None, 16, 20])
def test_cached_scorer_split_title_len_matches_jax(workload, monkeypatch, split):
    """``CachedScorer(split_title_len=...)``: the same call into both
    packages buckets the corpus the same way (None: one bucket at full
    width) and gives the same metrics."""
    from newsreclib_tpu import serving as jserving

    (jm, params, jstore, jimp), (tm, store, imp) = workload
    monkeypatch.setattr(jserving, "_CORPUS_FEATS_CACHE", {})
    want = JCachedScorer(jm, split_title_len=split).evaluate(params, jstore, jimp, **EVAL)
    seen = _record_segments(monkeypatch)
    got = CachedScorer(tm, device="cpu", split_title_len=split).evaluate(store, imp, **EVAL)
    segments = _jax_segments(jserving._CORPUS_FEATS_CACHE, jstore, EVAL["encode_batch"], split)
    assert len(segments) == (1 if split is None else 2)
    _assert_same_segments(seen[-1], segments)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


def test_title_split_margin_matches_jax(workload, monkeypatch):
    """A model's ``TITLE_SPLIT_MARGIN`` moves titles within the margin of
    the split width to the full-width bucket, in both packages alike."""
    from newsreclib_tpu import serving as jserving

    (_, params, jstore, _), (tm, store, _) = workload
    monkeypatch.setattr(jserving, "_CORPUS_FEATS_CACHE", {})
    jm = _JNRMSWithMargin(vocab_size=VOCAB, **DIMS)
    want = np.asarray(jbuild_table(jm, params, jstore, batch_size=16, split_title_len=20))
    tm = copy.deepcopy(tm)
    tm.TITLE_SPLIT_MARGIN = 4
    seen = _record_segments(monkeypatch)
    got = build_news_vector_table(tm, store, batch_size=16, split_title_len=20, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    segments = _jax_segments(jserving._CORPUS_FEATS_CACHE, jstore, 16, 20)
    _assert_same_segments(seen[-1], segments)
    lens = (store.title != 0).sum(axis=1)
    assert lens[segments[0][0]].max() == 16 and segments[0][1] == 20
    assert len(segments[0][0]) < len(corpus_segments(store, 20, 16)[0][0])


@pytest.mark.parametrize("loss", ["cross_entropy_loss", "sup_con_loss"])
def test_cached_scorer_loss_matches_jax(workload, loss):
    """``CachedScorer(loss_fn=...)`` reports ``loss``, the batches' losses
    weighted by their valid impressions (batches end in padding rows), as
    the JAX scorer does; float32, atol 1e-5."""
    from newsreclib_tpu.models.components.losses import get_loss_fn as jget_loss_fn
    from newsreclib_tpu_torch.models.components.losses import get_loss_fn

    (jm, params, jstore, jimp), (tm, store, imp) = workload
    want = JCachedScorer(jm, loss_fn=jget_loss_fn(loss)).evaluate(params, jstore, jimp, **EVAL)
    got = CachedScorer(tm, device="cpu", loss_fn=get_loss_fn(loss)).evaluate(store, imp, **EVAL)
    assert np.isfinite(got["loss"]) and got["loss"] > 0
    assert abs(got["loss"] - want["loss"]) < 1e-5
    assert "loss" not in CachedScorer(tm, device="cpu").evaluate(store, imp, **EVAL)
