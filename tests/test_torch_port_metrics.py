"""The port's ranking metrics against the JAX package's on random masked
slates with ties, impressions without a positive and fully padded rows.

Tolerance: atol/rtol 1e-5 — float32 sums of the same terms in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.metrics import functional as JF
from newsreclib_tpu.metrics.collector import RankingMetrics as JRankingMetrics
from newsreclib_tpu_torch.metrics import functional as F
from newsreclib_tpu_torch.metrics.collector import RankingMetrics

TOL = dict(atol=1e-5, rtol=1e-5)


def slate(seed, b=16, c=8, h=10):
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, size=(b, c)).astype(np.float32)  # many ties
    cand_mask = np.arange(c)[None, :] < rng.integers(1, c + 1, size=b)[:, None]
    cand_mask[-1] = False  # a fully padded row
    labels = ((rng.random((b, c)) < 0.2) & cand_mask).astype(np.float32)
    labels[0] = 0  # an impression with no positive
    hist_mask = np.arange(h)[None, :] < rng.integers(0, h + 1, size=b)[:, None]
    cats = rng.integers(0, 5, size=(b, c)).astype(np.int32)
    cats[1] = 0  # no aspect at all
    hcats = rng.integers(0, 5, size=(b, h)).astype(np.int32)
    return scores, labels, cand_mask, cats, hcats, hist_mask


def both(fn_j, fn_t, *arrays):
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in arrays]))
    got = fn_t(*[torch.from_numpy(a) for a in arrays]).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mrr_and_ndcg(seed):
    s, y, m, *_ = slate(seed)
    got, want = both(JF.mrr, F.mrr, s, y, m)
    np.testing.assert_allclose(got, want, **TOL)
    for k in (1, 5, 10):
        got, want = both(lambda a, b, c: JF.ndcg_at_k(a, b, c, k),
                         lambda a, b, c: F.ndcg_at_k(a, b, c, k), s, y, m)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diversity_and_personalization(seed):
    s, _, m, cats, hcats, hm = slate(seed)
    for k in (3, 5):
        got, want = both(lambda *a: JF.diversity_at_k(*a, k, 5),
                         lambda *a: F.diversity_at_k(*a, k, 5), s, cats, m)
        np.testing.assert_allclose(got, want, **TOL)
        got, want = both(lambda *a: JF.personalization_at_k(*a, k, 5),
                         lambda *a: F.personalization_at_k(*a, k, 5), s, cats, m, hcats, hm)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pooled_auc_with_ties_and_masked_entries(seed):
    s, y, m, *_ = slate(seed)
    w = m.astype(np.float32)
    got, want = both(JF.binary_auc_weighted, F.binary_auc_weighted,
                     s.ravel(), (y * w).ravel(), w.ravel())
    np.testing.assert_allclose(got, want, **TOL)
    valid = m.ravel()
    np.testing.assert_allclose(got, np.asarray(JF.binary_auc(jnp.asarray(s.ravel()[valid]),
                                                             jnp.asarray(y.ravel()[valid]))),
                               **TOL)


def test_auc_without_both_classes_is_zero():
    s = torch.tensor([0.1, 0.2, 0.3])
    assert float(F.binary_auc_weighted(s, torch.zeros(3), torch.ones(3))) == 0.0


def test_generalized_jaccard():
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, 4, size=(6, 5)).astype(np.float32) for _ in range(2))
    a[0] = b[0] = 0
    got, want = both(JF.generalized_jaccard, F.generalized_jaccard, a, b)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("with_aspects", [False, True])
def test_ranking_metrics_per_impression(with_aspects):
    s, y, m, cats, hcats, hm = slate(3)
    sent, hsent = cats % 3, hcats % 3
    kw = dict(cand_categories=cats, cand_sentiments=sent, hist_categories=hcats,
              hist_sentiments=hsent, hist_mask=hm) if with_aspects else {}
    jr, tr = JRankingMetrics(num_categ_classes=5, num_sent_classes=3), \
        RankingMetrics(num_categ_classes=5, num_sent_classes=3)
    want = jr.per_impression(jnp.asarray(s), jnp.asarray(y), jnp.asarray(m),
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    got = tr.per_impression(torch.from_numpy(s), torch.from_numpy(y), torch.from_numpy(m),
                            **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert list(got) == list(want) == tr.metric_names(with_aspects, with_aspects)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("with_sent", [True, False])
@pytest.mark.parametrize("with_categ", [True, False])
def test_metric_names_match_jax(with_categ, with_sent, with_hist):
    """The same ``metric_names`` call into both packages: the personalization
    names only where the history's aspects are given too."""
    args = dict(with_categ=with_categ, with_sent=with_sent, with_hist=with_hist)
    want = JRankingMetrics(top_k_list=(3, 7)).metric_names(**args)
    assert RankingMetrics(top_k_list=(3, 7)).metric_names(**args) == want
