"""The MINDsmall-scale statistical fixtures (copies of
``write_mind_small_statfix``, ``write_mind_small_statfix_v2`` and their
helpers from ``newsreclib_tpu/data/statfix.py``).

It writes raw MIND files (``MINDsmall_{train,dev}/news.tsv``,
``behaviors.tsv``, ``entity_embedding.vec``) and a GloVe-format file that
match MINDsmall's shape statistics and carry a learnable preference signal:
224,665 behaviors, 65,238 articles in 17 categories, titles of 8-14 tokens
whose signature words tell the category, users with sparse category
preferences, impression positives mixing that preference with uniform
exploration.  It is not the real MINDsmall.

v2 writes the same files at the same scale with two planted signals: a
topic carried only by the entities, and a sentiment bias (users with a
polarity affinity, histories and clicks skewed toward it), plus the
generative truth ``statfix_v2_truth.npz``; it is the fixture of the
``*_statfix2_*`` experiments.

The code draws the same random numbers in the same order as the JAX
package's, so for a seed the files are byte-identical.  The Adressa and
xMIND generators are not here.
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


# ---------------------------------------------------------------------------
# Statfix v2 — planted sentiment-bias + entity-topic signals (round 5)
# ---------------------------------------------------------------------------
#
# v1 proves the accuracy path (models learn category preference from text)
# but carries NO signal for the components that distinguish the fairness
# family and the entity channel: sentiment words are sprinkled uniformly
# (nothing for SentiRec/SentiDebias to act on) and entities are random
# (nothing for DKN's KCNN / CAUM / MINER entity towers to learn).  v2 plants
# both, at the same corpus scale, with the same file contract:
#
#   * TOPICS: a second latent dimension (N_TOPICS), independent of category,
#     carried ONLY by entities — each topic owns a disjoint entity pool and
#     the entity_embedding.vec vectors cluster by topic centroid.  Titles
#     carry NO topic information, so the AUC gap between a text-only model
#     and an entity-aware model measures exactly the entity channel's
#     contribution (VERDICT r4: DKN must gain >=0.02 AUC over its
#     entity-ablated self; ref news.py:186-299).
#   * SENTIMENT BIAS: each user has a polarity affinity p_u in [-1, 1];
#     histories are rejection-skewed toward matching-polarity articles and
#     clicks get a polarity-match logit boost.  A plain recommender amplifies
#     the bias (high sent_pers / low sent_div); SentiRec's diversity penalty
#     (ref sentirec_module.py:348-366) and SentiDebias's bias-free head
#     (ref senti_debias_module.py:431) now have a measurable job to do.
#
# Calibration: benchmarks/calibrate_statfix_v2.py simulates the click model
# and reports oracle AUCs per signal subset; the constants below were chosen
# so the text-observable oracle sits in the v1 band and the topic component
# adds ~0.03-0.04 AUC of entity-only headroom.

N_TOPICS = 20
V2_P_RANDOM_CLICK = 0.5
V2_SHARP_CAT = 3.0
V2_SHARP_TOPIC = 3.0
V2_S_SENT = 2.0         # click-logit boost per unit polarity match
V2_S_SENT_HIST = 1.2    # history rejection-sampling skew strength
V2_P_SENT = (0.30, 0.27, 0.43)   # article polarity priors: pos, neg, neutral
V2_USER_POLARITY = ((0.9, -0.9, 0.0), (0.4, 0.4, 0.2))  # values, probs


def write_mind_small_statfix_v2(data_dir: str, seed: int = 42) -> None:
    """Write the v2 fixture (same splits/scale/file layout as v1)."""
    rng = np.random.default_rng(seed)
    cats, sig, common = _make_vocab()
    sub_names = [f"{c}_sub{j}" for c in cats for j in range(N_SUBCATS_PER)]
    common_p = _zipf_probs(COMMON_WORDS)
    sig_p = _zipf_probs(SIG_WORDS_PER_CAT)
    entities = [f"Q{i+1}" for i in range(N_ENTITIES)]
    ents_per_topic = N_ENTITIES // N_TOPICS
    ent_pool_p = _zipf_probs(ents_per_topic)

    total_news = TRAIN_NEWS
    news_cat = rng.integers(0, N_CATEGORIES, size=total_news)
    news_sub = news_cat * N_SUBCATS_PER + rng.integers(0, N_SUBCATS_PER, size=total_news)
    news_topic = rng.integers(0, N_TOPICS, size=total_news)
    # polarity: +1 pos / -1 neg / 0 neutral, sampled from the marginal prior
    news_pol = rng.choice([1, -1, 0], size=total_news, p=V2_P_SENT)
    title_lens = rng.integers(8, 15, size=total_news)

    def title_for(i: int) -> str:
        c = int(news_cat[i])
        L = int(title_lens[i])
        n_sig = max(1, int(round(L * 0.6)))
        words = list(rng.choice(sig[c], size=n_sig, p=sig_p))
        words += list(rng.choice(common, size=L - n_sig, p=common_p))
        # sentiment words follow the article's ASSIGNED polarity (v1 sampled
        # them independently -> no bias to plant); the offline lexicon
        # annotator then recovers exactly this class
        if news_pol[i] > 0:
            words += list(rng.choice(_POS, size=int(rng.integers(1, 3))))
        elif news_pol[i] < 0:
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

    print("statfix_v2: generating article rows...")
    news_rows: List[str] = []
    for i in range(total_news):
        nid = f"N{i+1}"
        t = int(news_topic[i])
        # entities carry the topic: ids drawn from the topic's disjoint pool
        n_ents = 0 if rng.random() < 0.06 else int(rng.integers(1, 4))
        ents = [
            {
                "WikidataId": entities[t * ents_per_topic
                                       + int(rng.choice(ents_per_topic, p=ent_pool_p))],
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

    # ---- users: category prefs + topic prefs + polarity affinity ----
    user_pref = rng.dirichlet(np.full(N_CATEGORIES, 0.15), size=N_USERS)
    user_topic_pref = rng.dirichlet(np.full(N_TOPICS, 0.2), size=N_USERS)
    pol_vals, pol_probs = V2_USER_POLARITY
    user_pol = rng.choice(pol_vals, size=N_USERS, p=pol_probs)
    hist_lens = np.clip(
        np.round(rng.lognormal(mean=3.0, sigma=0.8, size=N_USERS)), 1, 200
    ).astype(np.int64)

    # (category, topic) -> article lists; topic pools within a category can
    # be thin (65k/(17*20) ~ 190 each) but never empty at this scale
    by_cat = [np.nonzero(news_cat[:TRAIN_NEWS] == c)[0] for c in range(N_CATEGORIES)]
    by_cat_topic = [
        [cands[news_topic[cands] == t] for t in range(N_TOPICS)]
        for cands in by_cat
    ]

    def sample_articles_for_user(u: int, n: int) -> np.ndarray:
        cs = rng.choice(N_CATEGORIES, size=n, p=user_pref[u])
        ts = rng.choice(N_TOPICS, size=n, p=user_topic_pref[u])
        out = np.empty(n, dtype=np.int64)
        for j in range(n):
            pool = by_cat_topic[cs[j]][ts[j]]
            if len(pool) == 0:
                pool = by_cat[cs[j]]
            # sentiment skew: pick among a few draws by polarity-match weight
            picks = pool[rng.integers(0, len(pool), size=3)]
            w = np.exp(V2_S_SENT_HIST * user_pol[u] * news_pol[picks])
            out[j] = picks[rng.choice(3, p=w / w.sum())]
        return out

    print("statfix_v2: generating user histories...")
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
            cand = rng.integers(0, TRAIN_NEWS, size=ncand)
            n_pos = min(int(1 + (rng.random() < 0.25) + (rng.random() < 0.08)), ncand - 1) \
                if ncand > 1 else 1
            if rng.random() < V2_P_RANDOM_CLICK:
                pos_idx = rng.choice(ncand, size=n_pos, replace=False)
            else:
                logits = (
                    V2_SHARP_CAT * np.log(user_pref[u][news_cat[cand]] + 1e-4)
                    + V2_SHARP_TOPIC * np.log(
                        user_topic_pref[u][news_topic[cand]] + 1e-4)
                    + V2_S_SENT * user_pol[u] * news_pol[cand]
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
    ] + [f"11/14/2019 {h}:15:00 AM" for h in (7, 9, 11)]
    dev_times = [f"11/15/2019 {h}:30:00 AM" for h in (8, 10)]

    print("statfix_v2: writing splits...")
    # entity vectors cluster by TOPIC centroid: the pretrained entity space
    # itself carries the plantable signal (KCNN transforms it, news.py:186-299)
    topic_centroids = rng.normal(size=(N_TOPICS, 100)) * 0.8
    ent_vectors = np.vstack([
        topic_centroids[i // ents_per_topic] + rng.normal(size=100) * 0.3
        for i in range(N_ENTITIES)
    ])
    for split, n_bhv, times in (
        ("train", TRAIN_BEHAVIORS, train_times),
        ("dev", DEV_BEHAVIORS, dev_times),
    ):
        d = os.path.join(data_dir, f"MINDsmall_{split}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "news.tsv"), "w") as f:
            for row in news_rows:
                f.write(row + "\n")
        uid_pool = np.arange(N_USERS)
        with open(os.path.join(d, "behaviors.tsv"), "w") as f:
            f.write("\n".join(behaviors_rows(n_bhv, times, uid_pool, 1)) + "\n")
        with open(os.path.join(d, "entity_embedding.vec"), "w") as f:
            for e, vec in zip(entities, ent_vectors):
                f.write(e + "\t" + "\t".join(f"{v:.3f}" for v in vec) + "\n")

    print("statfix_v2: writing glove file...")
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
    # ground-truth sidecar so probes can score against the generative model
    np.savez(
        os.path.join(data_dir, "statfix_v2_truth.npz"),
        news_cat=news_cat, news_topic=news_topic, news_pol=news_pol,
        user_pol=user_pol,
    )
    print("statfix_v2: done.")
