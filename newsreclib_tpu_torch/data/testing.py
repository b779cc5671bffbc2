"""Synthetic raw fixtures (a copy of ``newsreclib_tpu/data/testing.py``,
with the same seeds and outputs): MIND's ``news.tsv`` / ``behaviors.tsv`` /
``entity_embedding.vec`` in the raw layout the ETL consumes plus a tiny
GloVe-format file, and a tar.gz of Adressa one_week event files.  Nothing is
downloaded.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

_CATEGORIES = ["news", "sports", "finance", "travel", "lifestyle"]
_SUBCATS = ["newsus", "newsworld", "football_nfl", "markets", "traveltips", "shopping"]
_WORDS = (
    "the a of to in on for with wins loses market team game stock price city "
    "world cup final election storm health study food home car tech phone "
    "season star movie deal crisis win great bad top best new old report says "
    "plans year day week strong weak growth fall rise"
).split()


def _title(rng) -> str:
    return " ".join(rng.choice(_WORDS, size=rng.integers(4, 10)))


def write_mind_fixture(
    data_dir: str,
    dataset_size: str = "demo",
    num_news: int = 120,
    num_users: int = 40,
    num_train_behaviors: int = 150,
    num_dev_behaviors: int = 60,
    seed: int = 0,
) -> None:
    """Write MIND-format raw splits under data_dir/MIND<size>_{train,dev}."""
    rng = np.random.default_rng(seed)
    nids = [f"N{i+1}" for i in range(num_news)]
    entities = [f"Q{i}" for i in range(30)]

    def news_rows(nid_subset: List[str]) -> List[str]:
        rows = []
        for nid in nid_subset:
            categ = rng.choice(_CATEGORIES)
            subcat = rng.choice(_SUBCATS)
            title = _title(rng)
            abstract = _title(rng) if rng.random() > 0.2 else ""
            ents = [
                {
                    "WikidataId": str(rng.choice(entities)),
                    "Confidence": float(rng.random()),
                    "OccurrenceOffsets": [int(rng.integers(0, 30))],
                }
                for _ in range(rng.integers(0, 3))
            ]
            rows.append(
                "\t".join(
                    [
                        nid, categ, subcat, title, abstract,
                        f"https://example.com/{nid}",
                        json.dumps(ents), json.dumps([]),
                    ]
                )
            )
        return rows

    def behaviors_rows(n: int, start_impid: int, times: Tuple[str, ...]) -> List[str]:
        rows = []
        for i in range(n):
            uid = f"U{rng.integers(1, num_users + 1)}"
            t = times[rng.integers(0, len(times))]
            hist_len = rng.integers(0, 12)
            hist = " ".join(rng.choice(nids, size=hist_len, replace=False)) if hist_len else ""
            n_cand = int(rng.integers(2, 16))
            cands = rng.choice(nids, size=n_cand, replace=False)
            n_pos = int(rng.integers(1, min(3, n_cand)))
            labels = np.zeros(n_cand, dtype=int)
            labels[rng.choice(n_cand, n_pos, replace=False)] = 1
            imp = " ".join(f"{c}-{l}" for c, l in zip(cands, labels))
            rows.append("\t".join([str(start_impid + i), uid, t, hist, imp]))
        return rows

    train_times = (
        "11/11/2019 10:00:00 AM", "11/12/2019 1:30:00 PM", "11/13/2019 8:15:00 AM",
        "11/14/2019 9:00:00 AM",  # falls in the val side of the time split
    )
    dev_times = ("11/15/2019 11:00:00 AM",)

    for split, n_bhv, times in (
        ("train", num_train_behaviors, train_times),
        ("dev", num_dev_behaviors, dev_times),
    ):
        d = os.path.join(data_dir, f"MIND{dataset_size}_{split}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "news.tsv"), "w") as f:
            f.write("\n".join(news_rows(nids)) + "\n")
        with open(os.path.join(d, "behaviors.tsv"), "w") as f:
            f.write("\n".join(behaviors_rows(n_bhv, 1, times)) + "\n")
        with open(os.path.join(d, "entity_embedding.vec"), "w") as f:
            for e in entities:
                vec = rng.normal(size=100)
                f.write(e + "\t" + "\t".join(f"{v:.4f}" for v in vec) + "\n")

    # tiny GloVe-format file covering some fixture words
    glove = os.path.join(data_dir, "glove_demo.txt")
    with open(glove, "w") as f:
        for w in _WORDS[:30]:
            vec = rng.normal(size=300)
            f.write(w + " " + " ".join(f"{v:.4f}" for v in vec) + "\n")


def write_adressa_fixture(
    data_dir: str,
    num_news: int = 60,
    num_users: int = 25,
    events_per_day: int = 120,
    num_days: int = 7,
    seed: int = 0,
) -> str:
    """Write a tar.gz of newline-JSON event files in the raw Adressa one_week
    layout (one member per day, day index = last char of the member name).
    Returns the tar path (``<data_dir>/one_week.tar.gz``)."""
    import io
    import json
    import tarfile

    rng = np.random.default_rng(seed)
    os.makedirs(data_dir, exist_ok=True)
    tar_path = os.path.join(data_dir, "one_week.tar.gz")
    cats = ["nyheter|innenriks", "sport|fotball", "kultur|musikk", "okonomi"]
    news = [
        {
            "id": f"art{i}",
            "title": _title(rng),
            "category1": cats[int(rng.integers(0, len(cats)))],
        }
        for i in range(num_news)
    ]
    with tarfile.open(tar_path, "w:gz") as tar:
        for day in range(1, num_days + 1):
            lines = []
            base_time = 1483225200 + day * 86400
            for _ in range(events_per_day):
                art = news[int(rng.integers(0, num_news))]
                ev = {
                    "id": art["id"],
                    "title": art["title"],
                    "category1": art["category1"],
                    "userId": f"cx:{int(rng.integers(0, num_users))}",
                    "time": int(base_time + rng.integers(0, 86400)),
                }
                lines.append(json.dumps(ev))
            blob = ("\n".join(lines) + "\n").encode("utf-8")
            info = tarfile.TarInfo(name=f"one_week/2017010{day}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return tar_path
