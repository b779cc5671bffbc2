"""The port's training and eval batchers against the JAX package's
(``newsreclib_tpu/data/batching.py``): the same store and impressions, the
same seed, integer-equal batches, batch for batch.

The impressions have 1 to 12 candidates with 1 to 3 positives, so that some
rows have fewer negatives than K (sampling wraps around) and some none.
"""

import dataclasses

import numpy as np
import pytest

from newsreclib_tpu.data import batching as jb
from newsreclib_tpu.data.news_store import NewsStore as JNewsStore
from newsreclib_tpu_torch.data import batching as tb
from newsreclib_tpu_torch.data.news_store import NewsStore
from newsreclib_tpu_torch.data.synthetic import realistic_title_lens

N_NEWS, N_IMP, TITLE = 400, 150, 30


def _data(seed=0):
    rng = np.random.default_rng(seed)
    title = np.zeros((N_NEWS + 1, TITLE), dtype=np.int32)
    for i, n in enumerate(realistic_title_lens(rng, N_NEWS, TITLE)):
        title[i + 1, :n] = rng.integers(2, 1000, size=n)
    store = NewsStore(nid2row={f"N{i}": i for i in range(1, N_NEWS + 1)}, title=title,
                      category=rng.integers(0, 19, size=N_NEWS + 1).astype(np.int32),
                      sentiment=rng.integers(0, 4, size=N_NEWS + 1).astype(np.int32))
    hists, cands, labels = [], [], []
    for _ in range(N_IMP):
        hists.append(rng.integers(1, N_NEWS + 1, size=int(rng.integers(0, 20))))
        c = int(rng.integers(1, 13))
        cands.append(rng.integers(1, N_NEWS + 1, size=c))
        lab = np.zeros(c, dtype=np.int8)
        lab[rng.choice(c, size=min(c, int(rng.integers(1, 4))), replace=False)] = 1
        labels.append(lab)
    users = rng.integers(1, 50, size=N_IMP)
    imp = tb.Impressions.from_lists(hists, cands, labels, users)
    jimp = jb.Impressions.from_lists(hists, cands, labels, users)
    return store, JNewsStore(**dataclasses.asdict(store)), imp, jimp


def _assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for name, value in w._asdict().items():
            mine = getattr(g, name)
            if value is None:
                assert mine is None, name
            elif name in ("news", "news2"):
                for f, v in value._asdict().items():
                    if v is None:
                        assert getattr(mine, f) is None, f
                    else:
                        np.testing.assert_array_equal(getattr(mine, f), v, err_msg=f)
                        assert getattr(mine, f).dtype == v.dtype, f
            else:
                np.testing.assert_array_equal(mine, value, err_msg=name)
                assert mine.dtype == value.dtype, name


@pytest.mark.parametrize("split", [None, 16])
@pytest.mark.parametrize("epoch", [0, 1])
def test_train_batcher_equals_jax(epoch, split):
    store, jstore, imp, jimp = _data()
    kw = dict(batch_size=16, max_history_len=10, neg_sampling_ratio=4, seed=3,
              u_bucket_min=64, split_title_len=split)
    got = tb.TrainBatcher(store, imp, **kw)
    want = jb.TrainBatcher(jstore, jimp, **kw)
    assert len(got) == len(want) and got.num_samples() == want.num_samples()
    batches = list(got.epoch(epoch))
    _assert_batches_equal(batches, want.epoch(epoch))
    if split:
        assert any(b.news2 is not None for b in batches)


def test_train_batcher_keeps_the_last_partial_batch():
    store, jstore, imp, jimp = _data(seed=1)
    kw = dict(batch_size=32, max_history_len=10, seed=0, u_bucket_min=64, drop_last=False)
    got = list(tb.TrainBatcher(store, imp, **kw).epoch(0))
    _assert_batches_equal(got, jb.TrainBatcher(jstore, jimp, **kw).epoch(0))
    assert not got[-1].impression_valid.all()


@pytest.mark.parametrize("split", [None, 16])
def test_eval_batcher_equals_jax(split):
    store, jstore, imp, jimp = _data(seed=2)
    kw = dict(max_history_len=10, target_cells=128, u_bucket_min=64, split_title_len=split)
    got = tb.EvalBatcher(store, imp, **kw)
    assert got.num_impressions() == N_IMP
    _assert_batches_equal(got, jb.EvalBatcher(jstore, jimp, **kw))


@pytest.mark.parametrize("margin", [0, 3])
def test_split_news_by_length_equals_jax(margin):
    store, jstore, imp, jimp = _data(seed=3)
    rows = np.arange(0, 200)
    hist = np.random.default_rng(0).integers(0, 200, size=(8, 10)).astype(np.int32)
    cand = np.random.default_rng(1).integers(1, 200, size=(8, 5)).astype(np.int32)
    got = tb.split_news_by_length(store.features_for(rows), hist, cand, 16, margin=margin)
    want = jb.split_news_by_length(jstore.features_for(rows), hist, cand, 16, margin=margin)
    assert want[1] is not None
    for g, w in zip(got[:2], want[:2]):
        for f, v in w._asdict().items():
            if v is not None:
                np.testing.assert_array_equal(getattr(g, f), v, err_msg=f)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])


def test_padded_candidates_and_from_padded_equal_jax():
    _, _, imp, jimp = _data(seed=4)
    for got, want in zip(imp.padded_candidates(8), jimp.padded_candidates(8)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    cands, labels = imp.padded_candidates(12)
    lens = np.diff(imp.cand_offsets)
    hist = imp.padded_history(20)
    hlens = np.minimum(np.diff(imp.hist_offsets), 20)
    args = (hist, hlens, cands, labels, lens, imp.user_idx)
    got, want = tb.Impressions.from_padded(*args), jb.Impressions.from_padded(*args)
    for f in ("hist_flat", "hist_offsets", "cand_flat", "cand_offsets", "labels_flat",
              "user_idx"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    np.testing.assert_array_equal(got.cand_flat, imp.cand_flat)
