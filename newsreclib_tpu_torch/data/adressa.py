"""Adressa dataset ETL without pandas (counterpart of
``newsreclib_tpu/data/adressa.py``; reference
``newsreclib/data/components/adressa_dataframe.py:29-738`` and
``adressa_user_info.py:8-77``).

* Newline-JSON events are streamed from the ``one_week`` / ``three_month``
  tar.gz, members in ``getmembers()`` order; news (id, title, ``category1``
  -> category | subcategory) get dense ``N<i>`` ids in order of first
  appearance.
* Each user's clicks are split into history / train / test by day index
  (one_week: the last character of the member name; three_month: the ISO
  week) at ``train_date_split`` / ``test_date_split``.
* Every positive click becomes one impression with ``neg_num`` negatives
  drawn uniformly from the news the user never clicked: one
  ``numpy.random.default_rng(seed)`` draws them per positive in the order
  of the users' first clicks, then shuffles the train lines and then the
  test lines, which ``user_dev_size`` cuts into dev and test.  Test
  histories hold the train clicks too.
* Tokens, vocabulary, category and sentiment maps and the dense store are
  built as for MIND, from ``news.tsv`` read back with the pandas rules of
  ``data/mind.py`` (quoting, NA strings: a missing title has no tokens).

The files and caches are the JAX package's, under the same names and
byte-identical: ``Adressa_<size>/news.tsv``, ``nid2index.tsv``,
``{word2index,categ2index,subcateg2index,sentiment2index}.tsv``,
``behaviors_<seed>.tsv`` (train), ``{dev,test}/behaviors_<seed>.tsv`` and
``news_store.npz``.  The ``val`` split reads the ``dev`` behaviors.
Behavior lines are parsed by the native host parser (``data/fastetl.py``).
With ``use_plm`` the titles are tokenised by the local tokenizer directory
``plm_tokenizer`` (``data/plm_tokenizer.py``) at ``tokenizer_max_len``, into
``news_store_plm.npz`` beside the word-level cache.
"""

from __future__ import annotations

import json
import os
import tarfile
from collections import defaultdict
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional, Tuple

import numpy as np

from newsreclib_tpu_torch.data import fastetl
from newsreclib_tpu_torch.data.batching import Impressions
from newsreclib_tpu_torch.data.embeddings import build_embedding_matrix
from newsreclib_tpu_torch.data.mind import PLMTokenizing, _map_to_tsv, _read_raw, _to_tsv
from newsreclib_tpu_torch.data.news_store import NewsStore, build_news_store
from newsreclib_tpu_torch.data.sentiment import SentimentAnnotator, get_annotator
from newsreclib_tpu_torch.data.tokenize import (
    build_index_map,
    build_vocab,
    tokens_to_ids,
    word_tokenize,
)

ADRESSA_URLS = {
    "one_week": "https://reclab.idi.ntnu.no/dataset/one_week.tar.gz",
    "three_month": "https://reclab.idi.ntnu.no/dataset/three_month.tar.gz",
}
NEWS_COLUMNS = ["nid", "category", "subcategory", "title"]


@dataclass
class AdressaConfig:
    data_dir: str
    dataset_size: str = "one_week"
    train_date_split: int = 6
    test_date_split: int = 7
    neg_num: int = 20
    user_dev_size: float = 0.2
    max_title_len: int = 30
    word_embeddings_fpath: Optional[str] = None
    word_embed_dim: int = 300
    categ_embed_dim: int = 300
    use_pretrained_categ_embeddings: bool = True
    sentiment_annotator: str = "lexicon"
    sentiment_annotator_kwargs: dict = field(default_factory=dict)
    download: bool = False
    seed: int = 42
    use_plm: bool = False  # titles by the PLM tokenizer
    plm_tokenizer: Optional[str] = None  # a local tokenizer directory
    tokenizer_max_len: int = 96


class _UserTimeline:
    """One user's clicks partitioned by date (``adressa_user_info.py:8-77``)."""

    __slots__ = ("hist", "train", "test")

    def __init__(self):
        self.hist: List[Tuple[int, int]] = []  # (time, nindex)
        self.train: List[Tuple[int, int]] = []
        self.test: List[Tuple[int, int]] = []

    def update(self, nindex: int, click_time: int, date: int, train_split: int,
               test_split: int):
        if train_split <= date < test_split:
            self.train.append((click_time, nindex))
        elif date >= test_split:
            self.test.append((click_time, nindex))
        else:
            self.hist.append((click_time, nindex))

    def sorted(self):
        return (
            [n for _, n in sorted(self.hist)],
            [n for _, n in sorted(self.train)],
            [n for _, n in sorted(self.test)],
        )


def _events(tar: tarfile.TarFile, members):
    """``(member, event)`` for every JSON line of ``members``, lines that do
    not decode skipped."""
    for member in members:
        f = tar.extractfile(member)
        if f is None:
            continue
        for raw in f:
            try:
                yield member, json.loads(raw.decode("utf-8").strip())
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue


class AdressaData(PLMTokenizing):
    """The interface of ``MINDData``: ``news_store(split)``,
    ``impressions(split)``, ``vocab_size``, ``num_users``, ``num_classes``,
    ``split_dir``.  One store serves every split."""

    def __init__(self, cfg: AdressaConfig, annotator: Optional[SentimentAnnotator] = None):
        self.cfg = cfg
        self.annotator = annotator or get_annotator(
            cfg.sentiment_annotator, **cfg.sentiment_annotator_kwargs
        )
        self.root = os.path.join(cfg.data_dir, f"Adressa_{cfg.dataset_size}")
        self._store: Optional[NewsStore] = None
        self._maps: Optional[Dict[str, Dict[str, int]]] = None

    # ---------- raw processing ----------

    def _tar_path(self) -> str:
        return os.path.join(self.cfg.data_dir, f"{self.cfg.dataset_size}.tar.gz")

    def _behaviors_path(self, stage: Optional[str] = None) -> str:
        name = f"behaviors_{self.cfg.seed}.tsv"
        return os.path.join(self.root, name) if stage is None else os.path.join(
            self.root, stage, name)

    def prepare_raw(self) -> None:
        """tar.gz -> ``news.tsv``, ``nid2index.tsv`` and the behaviors files
        (nothing to do when ``news.tsv`` and the train behaviors exist)."""
        news_f = os.path.join(self.root, "news.tsv")
        bhv_f = self._behaviors_path()
        if os.path.exists(news_f) and os.path.exists(bhv_f):
            return
        tar_path = self._tar_path()
        if not os.path.exists(tar_path):
            if not self.cfg.download:
                raise FileNotFoundError(f"{tar_path} missing and download disabled")
            from newsreclib_tpu_torch.data import download as dl

            dl.maybe_download(ADRESSA_URLS[self.cfg.dataset_size], tar_path)

        news_title: Dict[str, str] = {}
        news_category: Dict[str, str] = {}
        news_subcategory: Dict[str, str] = {}
        uid2index: Dict[str, int] = {}
        timelines: Dict[str, _UserTimeline] = defaultdict(_UserTimeline)

        with tarfile.open(tar_path, "r:gz") as tar:
            members = [m for m in tar.getmembers() if m.isfile()]
            for _, ev in _events(tar, members):
                if not ("id" in ev and "title" in ev and "category1" in ev):
                    continue
                nid = ev["id"]
                if nid not in news_title:
                    news_title[nid] = ev["title"]
                    news_category[nid] = ev["category1"].split("|")[0]
                    news_subcategory[nid] = ev["category1"].split("|")[-1]
            nid2index = {k: f"N{i}" for i, k in enumerate(news_title, start=1)}

            for member, ev in _events(tar, members):
                if not ("id" in ev and "title" in ev and ev.get("id") in nid2index):
                    continue
                uid = str(ev.get("userId"))
                if uid not in uid2index:
                    uid2index[uid] = len(uid2index)
                click_time = int(ev["time"])
                if self.cfg.dataset_size == "one_week":
                    date = int(member.name[-1])
                else:
                    date = datetime.fromtimestamp(click_time, tz=timezone.utc).isocalendar()[1]
                nindex = int(nid2index[ev["id"]][1:])
                timelines[f"U{uid2index[uid]}"].update(
                    nindex, click_time, date,
                    self.cfg.train_date_split, self.cfg.test_date_split,
                )

        os.makedirs(self.root, exist_ok=True)
        with open(news_f, "w", encoding="utf-8") as f:
            for nid, title in news_title.items():
                f.write("\t".join([nid2index[nid], news_category[nid], news_subcategory[nid],
                                   title]) + "\n")
        _to_tsv({"nid": list(nid2index), "index": list(nid2index.values())},
                os.path.join(self.root, "nid2index.tsv"))

        # synthesized impressions: the draws' order is the JAX package's
        rng = np.random.default_rng(self.cfg.seed)
        n_news = len(news_title)
        train_lines: List[str] = []
        test_lines: List[str] = []
        for uid, tl in timelines.items():
            hist, train, test = tl.sorted()
            interacted = set(hist) | set(train) | set(test)
            pool = np.asarray(
                [i for i in range(1, n_news + 1) if i not in interacted], dtype=np.int64
            )
            if len(pool) == 0:
                continue
            hist_str = " ".join(f"N{n}" for n in hist)
            for pos in train:
                negs = rng.choice(pool, size=min(self.cfg.neg_num, len(pool)), replace=False)
                imp = " ".join([f"N{pos}-1"] + [f"N{n}-0" for n in negs])
                train_lines.append(f"{uid}\t{hist_str}\t{imp}\n")
            test_hist_str = " ".join(f"N{n}" for n in hist + train)
            for pos in test:
                negs = rng.choice(pool, size=min(self.cfg.neg_num, len(pool)), replace=False)
                imp = " ".join([f"N{pos}-1"] + [f"N{n}-0" for n in negs])
                test_lines.append(f"{uid}\t{test_hist_str}\t{imp}\n")

        rng.shuffle(train_lines)
        rng.shuffle(test_lines)
        n_dev = int(len(test_lines) * self.cfg.user_dev_size)
        dev_lines, final_test = test_lines[:n_dev], test_lines[n_dev:]

        with open(bhv_f, "w", encoding="utf-8") as f:
            f.writelines(train_lines)
        for stage, lines in (("dev", dev_lines), ("test", final_test)):
            os.makedirs(os.path.join(self.root, stage), exist_ok=True)
            with open(self._behaviors_path(stage), "w", encoding="utf-8") as f:
                f.writelines(lines)

    # ---------- parsing ----------

    def _load_maps(self) -> Dict[str, Dict[str, int]]:
        """The vocabulary and class maps, built from ``news.tsv`` (and
        written beside it)."""
        if self._maps is not None:
            return self._maps
        self.prepare_raw()
        news = _read_raw(os.path.join(self.root, "news.tsv"), NEWS_COLUMNS)
        tok_titles = [word_tokenize(t) for t in news["title"]]
        maps = {
            "word2index": build_vocab(tok_titles),
            "categ2index": build_index_map(news["category"]),
            "subcateg2index": build_index_map(news["subcategory"]),
        }
        results = self.annotator.annotate_many(news["title"])
        news["sentiment_label"] = [r[0] for r in results]
        news["sentiment_score"] = [r[1] for r in results]
        maps["sentiment2index"] = build_index_map(news["sentiment_label"])
        for name, m in maps.items():
            _map_to_tsv(m, "key", os.path.join(self.root, f"{name}.tsv"))
        self._news = news
        self._tok_titles = tok_titles
        self._maps = maps
        return maps

    def news_store(self, split: str = "train") -> NewsStore:
        """The dense store of every split (cached as ``news_store.npz``, or
        ``news_store_plm.npz`` with ``use_plm``)."""
        if self._store is not None:
            return self._store
        cache = os.path.join(self.root, f"news_store{'_plm' if self.cfg.use_plm else ''}.npz")
        if os.path.exists(cache):
            self._store = NewsStore.load(cache)
            return self._store
        maps = self._load_maps()
        news = self._news
        if self.cfg.word_embeddings_fpath and os.path.exists(self.cfg.word_embeddings_fpath):
            build_embedding_matrix(
                maps["word2index"], self.cfg.word_embeddings_fpath,
                self.cfg.word_embed_dim, seed=self.cfg.seed,
                out_fpath=os.path.join(self.root, "transformed_word_embeddings.npy"),
            )
            if self.cfg.use_pretrained_categ_embeddings:
                build_embedding_matrix(
                    maps["categ2index"], self.cfg.word_embeddings_fpath,
                    self.cfg.categ_embed_dim, seed=self.cfg.seed,
                    out_fpath=os.path.join(self.root, "transformed_categ_embeddings.npy"),
                )
        if self.cfg.use_plm:
            titles = self._plm_tokenize(news["title"], self.cfg.tokenizer_max_len)
            width = self.cfg.tokenizer_max_len
        else:
            titles = [tokens_to_ids(t, maps["word2index"]) for t in self._tok_titles]
            width = self.cfg.max_title_len
        store = build_news_store(
            nids=news["nid"],
            tokenized_titles=titles,
            max_title_len=width,
            categories=[maps["categ2index"].get(c, 0) for c in news["category"]],
            subcategories=[maps["subcateg2index"].get(c, 0) for c in news["subcategory"]],
            sentiments=[maps["sentiment2index"].get(c, 0) for c in news["sentiment_label"]],
            sentiment_scores=news["sentiment_score"],
        )
        store.save(cache)
        self._store = store
        return store

    def impressions(self, split: str) -> Impressions:
        """CSR impressions of ``split``: ``train`` from the train behaviors,
        ``val`` from ``dev/`` (the reference has no val sub-split for
        Adressa), ``test`` from ``test/``; ``user_idx = uid + 1``.  The lines
        are parsed by the native host parser where it is built, else in
        Python (the same arrays)."""
        self.prepare_raw()
        store = self.news_store()
        stage = {"train": None, "val": "dev"}.get(split, "test")
        with open(self._behaviors_path(stage), encoding="utf-8") as f:
            lines = f.read().splitlines()
        uids, hists, imps = [], [], []
        for line in lines:
            uid, hist, imp = line.split("\t")
            uids.append(uid)
            hists.append(hist)
            imps.append(imp)
        nidmap = fastetl.StrMap(store.nid2row)
        caph = max((h.count(" ") + 1 for h in hists), default=1)
        capc = max((i.count(" ") + 1 for i in imps), default=1)
        hist_rows, hist_lens = fastetl.parse_id_lists(hists, nidmap, cap=caph)
        cand_rows, cand_labels, cand_lens = fastetl.parse_impressions(imps, nidmap, cap=capc)
        user_idx = np.asarray([int(u[1:]) + 1 for u in uids], dtype=np.int32)
        return Impressions.from_padded(
            hist_rows, hist_lens, cand_rows, cand_labels, cand_lens, user_idx, user_idx,
        )

    def vocab_size(self) -> int:
        return len(self._load_maps()["word2index"]) + 1

    def num_users(self) -> int:
        """The largest train user id + 2 (``user_idx`` is id + 1; row 0 pads)."""
        self.prepare_raw()
        n = 0
        with open(self._behaviors_path()) as f:
            for line in f:
                n = max(n, int(line.split("\t", 1)[0][1:]))
        return n + 2

    def num_classes(self) -> Dict[str, int]:
        maps = self._load_maps()
        return {
            "category": len(maps["categ2index"]) + 1,
            "subcategory": len(maps["subcateg2index"]) + 1,
            "sentiment": len(maps["sentiment2index"]) + 1,
            "entity": 1,
        }

    def split_dir(self, raw_split: str) -> str:
        return self.root
