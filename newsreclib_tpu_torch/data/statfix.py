"""The MINDsmall-scale statistical fixture (a copy of
``write_mind_small_statfix`` and its helpers from
``newsreclib_tpu/data/statfix.py``).

It writes raw MIND files (``MINDsmall_{train,dev}/news.tsv``,
``behaviors.tsv``, ``entity_embedding.vec``) and a GloVe-format file that
match MINDsmall's shape statistics and carry a learnable preference signal:
224,665 behaviors, 65,238 articles in 17 categories, titles of 8-14 tokens
whose signature words tell the category, users with sparse category
preferences, impression positives mixing that preference with uniform
exploration.  It is not the real MINDsmall.

The code draws the same random numbers in the same order as the JAX
package's, so for a seed the files are byte-identical.  The v2, Adressa
and xMIND generators are not here.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

N_CATEGORIES = 17
N_SUBCATS_PER = 4
SIG_WORDS_PER_CAT = 1200
COMMON_WORDS = 7600
N_ENTITIES = 5000
TRAIN_NEWS = 65238
TRAIN_BEHAVIORS = 152327
DEV_BEHAVIORS = 72338
N_USERS = 50000

# click-model calibration (see module docstring).  With r = P_RANDOM_CLICK,
# model AUC ≈ r·0.5 + (1−r)·AUC_signal; measured AUC_signal ≈ 0.91 for NRMS
# at canonical hparams (r=0.35 run scored 0.767), so r=0.6 centers the
# literature band (0.60–0.70).
P_RANDOM_CLICK = 0.6  # exploration noise: positive chosen uniformly
PREF_SHARPNESS = 3.0  # softmax sharpness over category preference


# words the offline lexicon annotator scores, so the fixture exercises all
# 3 sentiment classes (+pad = 4, the reference's num_sent_classes)
_POS = "good great win success happy amazing excellent hope triumph boost".split()
_NEG = "bad worst lose fail sad crisis war attack fear crash".split()


def _make_vocab():
    cats = [f"cat{c}" for c in range(N_CATEGORIES)]
    sig = {
        c: [f"w{c}_{i}" for i in range(SIG_WORDS_PER_CAT)] for c in range(N_CATEGORIES)
    }
    common = [f"c{i}" for i in range(COMMON_WORDS)]
    return cats, sig, common


def _zipf_probs(n: int, a: float = 1.05) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** a
    return p / p.sum()


def write_mind_small_statfix(data_dir: str, seed: int = 42) -> None:
    """Write MINDsmall_{train,dev} raw splits + GloVe + entity vectors."""
    rng = np.random.default_rng(seed)
    cats, sig, common = _make_vocab()
    sub_names = [f"{c}_sub{j}" for c in cats for j in range(N_SUBCATS_PER)]
    common_p = _zipf_probs(COMMON_WORDS)
    sig_p = _zipf_probs(SIG_WORDS_PER_CAT)
    entities = [f"Q{i+1}" for i in range(N_ENTITIES)]

    # ---- article pool: shared between splits.  (The real dev news.tsv is a
    # ~51k subset; histories/candidates here draw from the full pool, so the
    # dev file must carry every referenced article — we keep one pool.) ----
    total_news = TRAIN_NEWS
    news_cat = rng.integers(0, N_CATEGORIES, size=total_news)
    news_sub = news_cat * N_SUBCATS_PER + rng.integers(0, N_SUBCATS_PER, size=total_news)
    title_lens = rng.integers(8, 15, size=total_news)

    def title_for(i: int) -> str:
        c = int(news_cat[i])
        L = int(title_lens[i])
        n_sig = max(1, int(round(L * 0.6)))
        words = list(rng.choice(sig[c], size=n_sig, p=sig_p))
        words += list(rng.choice(common, size=L - n_sig, p=common_p))
        r = rng.random()
        if r < 0.22:  # ~MIND-like positive share
            words += list(rng.choice(_POS, size=int(rng.integers(1, 3))))
        elif r < 0.40:  # negative share
            words += list(rng.choice(_NEG, size=int(rng.integers(1, 3))))
        rng.shuffle(words)
        return " ".join(words)

    def abstract_for(i: int) -> str:
        c = int(news_cat[i])
        L = int(rng.integers(15, 35))
        n_sig = int(round(L * 0.4))
        words = list(rng.choice(sig[c], size=n_sig, p=sig_p))
        words += list(rng.choice(common, size=L - n_sig, p=common_p))
        rng.shuffle(words)
        return " ".join(words)

    # news rows are generated ONCE (titles must be identical across the
    # train/dev files)
    print("statfix: generating article rows...")
    news_rows: List[str] = []
    for i in range(total_news):
        nid = f"N{i+1}"
        n_ents = int(rng.integers(0, 4))
        ents = [
            {
                "WikidataId": entities[int(rng.integers(0, N_ENTITIES))],
                "Confidence": round(float(0.55 + 0.45 * rng.random()), 3),
                "OccurrenceOffsets": [int(rng.integers(0, 40))],
            }
            for _ in range(n_ents)
        ]
        news_rows.append("\t".join([
            nid, cats[news_cat[i]], sub_names[news_sub[i]], title_for(i),
            abstract_for(i) if rng.random() > 0.06 else "",
            f"https://example.com/{nid}", json.dumps(ents), json.dumps([]),
        ]))

    train_rows_idx = np.arange(TRAIN_NEWS)
    dev_rows_idx = np.arange(total_news)

    # ---- users: sparse category preferences ----
    user_pref = rng.dirichlet(np.full(N_CATEGORIES, 0.15), size=N_USERS)
    hist_lens = np.clip(
        np.round(rng.lognormal(mean=3.0, sigma=0.8, size=N_USERS)), 1, 200
    ).astype(np.int64)

    # per-category article lists (train pool only: histories/candidates are
    # served from the articles live in the period)
    by_cat = [np.nonzero(news_cat[:TRAIN_NEWS] == c)[0] for c in range(N_CATEGORIES)]

    def sample_articles_for_user(u: int, n: int) -> np.ndarray:
        cs = rng.choice(N_CATEGORIES, size=n, p=user_pref[u])
        return np.array([by_cat[c][rng.integers(0, len(by_cat[c]))] for c in cs])

    # precompute each user's persistent history once
    print("statfix: generating user histories...")
    user_hist: List[np.ndarray] = [
        sample_articles_for_user(u, int(hist_lens[u])) for u in range(N_USERS)
    ]

    def behaviors_rows(n_rows: int, times: List[str], uid_pool: np.ndarray,
                       start_impid: int) -> List[str]:
        rows = []
        cand_sizes = np.clip(
            np.round(rng.lognormal(mean=3.4, sigma=0.55, size=n_rows)), 2, 300
        ).astype(np.int64)
        uids = uid_pool[rng.integers(0, len(uid_pool), size=n_rows)]
        t_idx = rng.integers(0, len(times), size=n_rows)
        for i in range(n_rows):
            u = int(uids[i])
            ncand = int(cand_sizes[i])
            cand = rng.integers(0, TRAIN_NEWS, size=ncand)  # editorial pool
            n_pos = min(int(1 + (rng.random() < 0.25) + (rng.random() < 0.08)), ncand - 1) \
                if ncand > 1 else 1
            if rng.random() < P_RANDOM_CLICK:
                pos_idx = rng.choice(ncand, size=n_pos, replace=False)
            else:
                logits = PREF_SHARPNESS * np.log(
                    user_pref[u][news_cat[cand]] + 1e-4
                )
                p = np.exp(logits - logits.max())
                p /= p.sum()
                pos_idx = rng.choice(ncand, size=n_pos, replace=False, p=p)
            labels = np.zeros(ncand, dtype=np.int64)
            labels[pos_idx] = 1
            hist = user_hist[u]
            rows.append("\t".join([
                str(start_impid + i), f"U{u+1}", times[t_idx[i]],
                " ".join(f"N{a+1}" for a in hist),
                " ".join(f"N{c+1}-{l}" for c, l in zip(cand, labels)),
            ]))
        return rows

    train_times = [
        f"11/{d}/2019 {h}:{m:02d}:00 {ap}"
        for d in (9, 10, 11, 12, 13) for h in (8, 11, 3, 7) for m in (5, 35)
        for ap in ("AM", "PM")
    ] + [f"11/14/2019 {h}:15:00 AM" for h in (7, 9, 11)]  # val side of split
    dev_times = [f"11/15/2019 {h}:30:00 AM" for h in (8, 10)]

    print("statfix: writing splits...")
    ent_vectors = rng.normal(size=(N_ENTITIES, 100)) * 0.3
    for split, n_bhv, times, idxs in (
        ("train", TRAIN_BEHAVIORS, train_times, train_rows_idx),
        ("dev", DEV_BEHAVIORS, dev_times, dev_rows_idx),
    ):
        d = os.path.join(data_dir, f"MINDsmall_{split}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "news.tsv"), "w") as f:
            for i in idxs:
                f.write(news_rows[int(i)] + "\n")
        uid_pool = np.arange(N_USERS)
        with open(os.path.join(d, "behaviors.tsv"), "w") as f:
            f.write("\n".join(behaviors_rows(n_bhv, times, uid_pool, 1)) + "\n")
        with open(os.path.join(d, "entity_embedding.vec"), "w") as f:
            for e, vec in zip(entities, ent_vectors):
                f.write(e + "\t" + "\t".join(f"{v:.3f}" for v in vec) + "\n")

    # ---- GloVe-format embeddings: signature words cluster per category ----
    print("statfix: writing glove file...")
    centroids = rng.normal(size=(N_CATEGORIES, 300)) * 0.8
    glove = os.path.join(data_dir, "glove_statfix.txt")
    with open(glove, "w") as f:
        for c in range(N_CATEGORIES):
            for w in sig[c]:
                vec = centroids[c] + rng.normal(size=300) * 0.4
                f.write(w + " " + " ".join(f"{v:.3f}" for v in vec) + "\n")
        for w in common:
            vec = rng.normal(size=300) * 0.5
            f.write(w + " " + " ".join(f"{v:.3f}" for v in vec) + "\n")
    print("statfix: done.")
