"""Synthetic MIND-shaped data for tests and the card smoke run (numpy only).

``make_batch`` is the counterpart of ``newsreclib_tpu/data/synthetic.py``
and draws the same numbers from the same generator.  ``make_serving_workload``
regenerates the cached-serving workload of ``bench.py:45-95`` from a seed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch
from newsreclib_tpu_torch.data.batching import Impressions
from newsreclib_tpu_torch.data.news_store import NewsStore


@dataclass
class SyntheticConfig:
    vocab_size: int = 5000
    num_categories: int = 19  # 18 + pad, MIND
    num_subcategories: int = 50
    num_sent_classes: int = 4  # 3 + pad
    num_users: int = 1000
    title_len: int = 30
    abstract_len: int = 50
    entity_len: int = 10
    entity_vocab_size: int = 800


def make_batch(
    rng: np.random.Generator,
    batch_size: int = 8,
    hist_len: int = 50,
    num_candidates: int = 5,
    unique_news: int = 64,
    cfg: SyntheticConfig = SyntheticConfig(),
    with_abstract: bool = True,
    with_entities: bool = True,
    planted_signal: bool = False,
) -> RecBatch:
    """Random RecBatch of numpy arrays.  With ``planted_signal``, the
    positive candidate's first title token is drawn from a distinct range."""
    u, lt, la, le = unique_news, cfg.title_len, cfg.abstract_len, cfg.entity_len

    title_lens = rng.integers(3, lt + 1, size=u)
    title = np.zeros((u, lt), dtype=np.int32)
    for i, n in enumerate(title_lens):
        title[i, :n] = rng.integers(2, cfg.vocab_size // 2, size=n)

    abstract = None
    if with_abstract:
        ab_lens = rng.integers(0, la + 1, size=u)
        abstract = np.zeros((u, la), dtype=np.int32)
        for i, n in enumerate(ab_lens):
            abstract[i, :n] = rng.integers(2, cfg.vocab_size, size=n)

    ents = ab_ents = None
    if with_entities:
        ents, ab_ents = (
            np.where(
                rng.random((u, le)) < 0.3,
                rng.integers(1, cfg.entity_vocab_size, size=(u, le)),
                0,
            ).astype(np.int32)
            for _ in range(2)
        )

    category = rng.integers(1, cfg.num_categories, size=u).astype(np.int32)
    subcategory = rng.integers(1, cfg.num_subcategories, size=u).astype(np.int32)
    sentiment = rng.integers(1, cfg.num_sent_classes, size=u).astype(np.int32)
    sentiment_score = rng.uniform(-1, 1, size=u).astype(np.float32)
    # row 0 is the padding article
    for arr in (title, category, subcategory, sentiment, sentiment_score,
                abstract, ents, ab_ents):
        if arr is not None:
            arr[0] = 0

    b, h, c = batch_size, hist_len, num_candidates
    hist_sizes = rng.integers(1, h + 1, size=b)
    hist_idx = np.zeros((b, h), dtype=np.int32)
    for i, n in enumerate(hist_sizes):
        hist_idx[i, :n] = rng.integers(1, u, size=n)

    cand_idx = rng.integers(1, u, size=(b, c)).astype(np.int32)
    labels = np.zeros((b, c), dtype=np.float32)
    pos_slot = rng.integers(0, c, size=b)
    labels[np.arange(b), pos_slot] = 1.0

    if planted_signal:
        pos_news = cand_idx[np.arange(b), pos_slot]
        title[pos_news, 0] = rng.integers(cfg.vocab_size // 2, cfg.vocab_size, size=b)

    def mask(arr):
        return None if arr is None else arr != 0

    news = NewsFeatures(
        title=title,
        title_mask=title != 0,
        abstract=abstract,
        abstract_mask=mask(abstract),
        category=category,
        subcategory=subcategory,
        sentiment=sentiment,
        sentiment_score=sentiment_score,
        title_entities=ents,
        title_entities_mask=mask(ents),
        abstract_entities=ab_ents,
        abstract_entities_mask=mask(ab_ents),
    )
    return RecBatch(
        news=news,
        hist_idx=hist_idx,
        hist_mask=hist_idx != 0,
        cand_idx=cand_idx,
        cand_mask=np.ones((b, c), dtype=bool),
        labels=labels,
        user_idx=rng.integers(1, cfg.num_users, size=b).astype(np.int32),
        impression_valid=np.ones(b, dtype=bool),
    )


SERVING_ENTITIES = 800  # entity vocabulary of make_serving_workload
SERVING_USERS = 1000  # user ids of make_serving_workload lie in [1, SERVING_USERS)


def realistic_title_lens(rng: np.random.Generator, n: int, title_len: int = 30) -> np.ndarray:
    """Title token counts ~ Poisson(11) clipped to [4, title_len], as on the
    MIND corpus (mean about 11 tokens, padded to 30)."""
    return np.clip(rng.poisson(11.0, size=n), 4, title_len)


def make_serving_workload(
    rng: np.random.Generator,
    corpus: int = 32768,
    n_impressions: int = 16384,
    hist_len: int = 50,
    num_candidates: int = 32,
    title_len: int = 30,
    vocab_size: int = 60000,
) -> Tuple[NewsStore, Impressions]:
    """The cached-serving workload of ``bench.py``: a corpus of ``corpus``
    articles with categories and sentiments, and impressions with 5 to
    ``hist_len`` clicks and ``num_candidates`` candidates, one positive.

    The articles also carry abstracts (0 to 50 tokens), subcategories (50
    classes) and 10 title and 10 abstract entity slots (each an entity of
    ``SERVING_ENTITIES`` with probability 0.3), as the MIND data path gives
    them, for the models that read more than titles, each impression a
    user id below ``SERVING_USERS`` (LSTUR and NPA read it), and each
    article a sentiment score in [-1, 1] (SentiRec reads it).  They are
    drawn after everything else, in that order, so the titles, histories
    and candidates of a seed are those of ``bench.py``'s workload, and the
    other fields those of the earlier workloads."""
    title = np.zeros((corpus + 1, title_len), dtype=np.int32)
    lens = realistic_title_lens(rng, corpus, title_len)
    for i in range(corpus):
        title[i + 1, : lens[i]] = rng.integers(2, vocab_size, size=lens[i])
    store = NewsStore(
        nid2row={f"N{i}": i for i in range(1, corpus + 1)},
        title=title,
        category=rng.integers(1, 19, size=corpus + 1).astype(np.int32),
        sentiment=rng.integers(1, 4, size=corpus + 1).astype(np.int32),
    )
    store.category[0] = 0
    store.sentiment[0] = 0

    hists = [rng.integers(1, corpus + 1, size=int(rng.integers(5, hist_len + 1)))
             for _ in range(n_impressions)]
    cands = [rng.integers(1, corpus + 1, size=num_candidates) for _ in range(n_impressions)]
    labels = []
    for _ in cands:
        lab = np.zeros(num_candidates, dtype=np.int8)
        lab[rng.integers(0, num_candidates)] = 1
        labels.append(lab)
    imp = Impressions.from_lists(hists, cands, labels, np.ones(n_impressions, dtype=np.int32))
    n = corpus + 1
    abstract = np.where(np.arange(50)[None, :] < rng.integers(0, 51, size=(n, 1)),
                        rng.integers(2, vocab_size, size=(n, 50)), 0)
    ents = [np.where(rng.random((n, 10)) < 0.3,
                     rng.integers(1, SERVING_ENTITIES, size=(n, 10)), 0)
            for _ in range(2)]
    store.abstract, store.title_entities, store.abstract_entities = (
        a.astype(np.int32) for a in (abstract, *ents))
    store.subcategory = rng.integers(1, 50, size=n).astype(np.int32)
    for a in (store.abstract, store.title_entities, store.abstract_entities,
              store.subcategory):
        a[0] = 0
    imp.user_idx[:] = rng.integers(1, SERVING_USERS, size=len(imp))
    store.sentiment_score = rng.uniform(-1, 1, size=n).astype(np.float32)
    store.sentiment_score[0] = 0.0
    return store, imp
