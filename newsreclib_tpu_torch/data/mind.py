"""MIND dataset ETL without pandas (counterpart of
``newsreclib_tpu/data/mind.py``).

It reads the raw ``MIND<size>_{train,dev}/{news,behaviors}.tsv`` and reads
and writes the JAX package's caches under the same names and in the same
layouts, so either package picks up the other's:

* ``MIND<size>_train/{word,entity,categ,subcateg,sentiment,uid}2index.tsv``:
  the maps built on the train split, read back by the dev split;
* ``<split>/parsed_news.tsv`` and ``<split>/{train_,val_,}parsed_behaviors.tsv``;
* ``MIND<size>_train/transformed_{word,entity}_embeddings.npy``;
* ``<split>/news_store.npz`` (``NewsStore.save``) and
  ``<split>/{train_,val_,}impressions.npz`` (CSR arrays).

The JAX package parses the TSVs with ``pandas.read_table`` and writes them
with ``DataFrame.to_csv``; this module gives the same values:

* fields are tab-separated, and a ``"`` that opens a field quotes it
  (``""`` inside is one quote), as in pandas' C parser; ``csv`` does the
  same with these settings;
* a field that is empty or one of pandas' NA strings (``NA``, ``null``,
  ``nan``, ``None``, ...) is missing (``None`` here, NaN there): a missing
  title has no tokens, a missing abstract is ``""`` and missing entities are
  ``[]``;
* an id map's keys are read back through ``astype(str)``, which (pandas 3)
  keeps a missing key missing: a key that is an NA string (the words
  ``nan`` or ``null``) comes back as one NaN key that no token matches,
  and several such keys collapse into one entry;
* behavior times are parsed with ``%m/%d/%Y %I:%M:%S %p``; the train split
  keeps times ``<`` ``valid_time_split`` and the val split ``>=`` it;
* rows with an empty history are dropped; ``uid2index`` follows the order
  of first appearance in the train split; an unknown news id maps to row 0.

``download=True`` raises unless the raw files are present: the port fetches
nothing.  With ``use_plm`` titles and abstracts are tokenised by the local
tokenizer directory ``plm_tokenizer`` (``data/plm_tokenizer.py``) at
``tokenizer_max_len``, into ``<split>/news_store_plm.npz`` beside the
word-level cache; the word-level maps and matrices are built as without it.
"""

from __future__ import annotations

import ast
import csv
import json
import os
import time
from dataclasses import dataclass, field
from datetime import datetime
from typing import Dict, Iterator, List, Optional

import numpy as np

from newsreclib_tpu_torch.data.batching import Impressions
from newsreclib_tpu_torch.data.embeddings import (
    build_embedding_matrix,
    build_entity_embedding_matrix,
)
from newsreclib_tpu_torch.data.news_store import NewsStore, build_news_store
from newsreclib_tpu_torch.data.plm_tokenizer import load_tokenizer
from newsreclib_tpu_torch.data.sentiment import SentimentAnnotator, get_annotator
from newsreclib_tpu_torch.data.tokenize import (
    build_index_map,
    build_vocab,
    tokens_to_ids,
    word_tokenize,
)

ID2INDEX_FILENAMES = {
    "word2index": "word2index.tsv",
    "entity2index": "entity2index.tsv",
    "categ2index": "categ2index.tsv",
    "subcateg2index": "subcateg2index.tsv",
    "sentiment2index": "sentiment2index.tsv",
    "uid2index": "uid2index.tsv",
}
# pandas.read_table's default NA strings (pandas._libs.parsers.STR_NA_VALUES)
NA_VALUES = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
NEWS_COLUMNS = ["nid", "category", "subcategory", "title", "abstract", "url",
                "title_entities", "abstract_entities"]
BEHAVIOR_COLUMNS = ["impid", "uid", "time", "history", "impressions"]
TIME_FORMAT = "%m/%d/%Y %I:%M:%S %p"
_CSV = dict(delimiter="\t", quotechar='"', doublequote=True)


def _rows(fpath: str) -> Iterator[List[str]]:
    """The records of a TSV as pandas' C parser splits them; blank lines skipped."""
    with open(fpath, newline="", encoding="utf-8-sig") as f:
        for row in csv.reader(f, strict=False, **_CSV):
            if row:
                yield row


def _read_raw(fpath: str, names: List[str]) -> Dict[str, list]:
    """``pd.read_table(fpath, header=None, names=names, usecols=...)`` as
    columns of strings, ``None`` for a missing field."""
    n = len(names)
    cols: List[list] = [[] for _ in names]
    for row in _rows(fpath):
        row = row[:n] + [""] * (n - len(row))
        for c, v in zip(cols, row):
            c.append(None if v in NA_VALUES else v)
    return dict(zip(names, cols))


def _read_table(fpath: str) -> Dict[str, list]:
    """A TSV with a header row, as columns of raw strings."""
    rows = _rows(fpath)
    header = next(rows)
    cols: List[list] = [[] for _ in header]
    for row in rows:
        row = row[:len(header)] + [""] * (len(header) - len(row))
        for c, v in zip(cols, row):
            c.append(v)
    return dict(zip(header, cols))


def _cell(v) -> str:
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def _to_tsv(columns: Dict[str, list], fpath: str) -> None:
    """``pd.DataFrame(columns).to_csv(fpath, sep="\\t", index=False)``."""
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    with open(fpath, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, quoting=csv.QUOTE_MINIMAL, lineterminator="\n", **_CSV)
        w.writerow(list(columns))
        for row in zip(*columns.values()):
            w.writerow([_cell(v) for v in row])


def _map_to_tsv(mapping: Dict, key_name: str, fpath: str) -> None:
    _to_tsv({key_name: list(mapping), "index": list(mapping.values())}, fpath)


_NA_KEY = float("nan")  # one object: equal to itself as a dict key, to no string


def _load_idx_map(fpath: str) -> Dict[str, int]:
    """The id map of a two-column TSV; every NA key becomes ``_NA_KEY``."""
    cols = list(_read_table(fpath).values())
    keys = [_NA_KEY if k in NA_VALUES else k for k in cols[0]]
    return dict(zip(keys, (int(v) for v in cols[1])))


@dataclass
class MINDConfig:
    data_dir: str
    dataset_size: str = "small"  # small | large | demo
    valid_time_split: str = "2019-11-14 00:00:00"
    max_title_len: int = 30
    max_abstract_len: int = 50
    max_entities: int = 10
    entity_freq_threshold: int = 2
    entity_confidence_threshold: float = 0.5
    word_embeddings_fpath: Optional[str] = None  # glove.840B.300d.txt
    word_embed_dim: int = 300
    entity_embed_dim: int = 100
    categ_embed_dim: int = 300
    use_pretrained_categ_embeddings: bool = False
    sentiment_annotator: str = "lexicon"  # lexicon | vader | bert
    sentiment_annotator_kwargs: dict = field(default_factory=dict)
    download: bool = False
    seed: int = 0
    use_plm: bool = False  # titles / abstracts by the PLM tokenizer
    plm_tokenizer: Optional[str] = None  # a local tokenizer directory
    tokenizer_max_len: int = 96


class PLMTokenizing:
    """PLM-mode tokenisation of a dataset (``cfg.use_plm``): the tokenizer
    of ``cfg.plm_tokenizer``, loaded once, and the seconds spent in it."""

    plm_tokenize_seconds = 0.0
    _tokenizer = None

    def _plm_tokenize(self, texts, max_len: int) -> List[List[int]]:
        if not self.cfg.plm_tokenizer:
            raise ValueError("data.use_plm needs data.plm_tokenizer, a local tokenizer "
                             "directory")
        t0 = time.time()
        if self._tokenizer is None:
            self._tokenizer = load_tokenizer(self.cfg.plm_tokenizer)
        ids = self._tokenizer.encode_batch(texts, max_len)
        self.plm_tokenize_seconds += time.time() - t0
        return ids


class MINDData(PLMTokenizing):
    """MIND's splits: ``train`` and ``val`` are the raw train file cut at
    ``valid_time_split``; ``test`` is the raw dev file."""

    def __init__(self, cfg: MINDConfig, annotator: Optional[SentimentAnnotator] = None):
        self.cfg = cfg
        self.annotator = annotator or get_annotator(
            cfg.sentiment_annotator, **cfg.sentiment_annotator_kwargs
        )
        self._stores: Dict[str, NewsStore] = {}

    # ---------- paths ----------

    def split_dir(self, raw_split: str) -> str:
        return os.path.join(self.cfg.data_dir, f"MIND{self.cfg.dataset_size}_{raw_split}")

    def map_path(self, name: str) -> str:
        return os.path.join(self.split_dir("train"), ID2INDEX_FILENAMES[name])

    def prepare_raw(self, raw_split: str) -> str:
        d = self.split_dir(raw_split)
        news_f = os.path.join(d, "news.tsv")
        if not os.path.exists(news_f):
            raise FileNotFoundError(
                f"{news_f} missing; the port downloads nothing"
                + (" (data.download=true is not honoured)" if self.cfg.download else "")
            )
        return d

    # ---------- news ----------

    def load_news(self, raw_split: str) -> Dict[str, list]:
        """The parsed news table of a raw split as columns (from
        ``parsed_news.tsv`` if present); the train split builds the id maps
        and the embedding matrices."""
        d = self.split_dir(raw_split)
        parsed = os.path.join(d, "parsed_news.tsv")
        if os.path.exists(parsed):
            return self._read_parsed_news(parsed)

        self.prepare_raw(raw_split)
        news = _read_raw(os.path.join(d, "news.tsv"), NEWS_COLUMNS)
        del news["url"]
        news["abstract"] = [a or "" for a in news["abstract"]]
        for col in ("title_entities", "abstract_entities"):
            news[col] = ["[]" if e is None else e for e in news[col]]

        results = self.annotator.annotate_many(news["title"])
        news["sentiment_label"] = [r[0] for r in results]
        news["sentiment_score"] = [r[1] for r in results]

        tok_titles = [word_tokenize(t) for t in news["title"]]
        tok_abstracts = [word_tokenize(t) for t in news["abstract"]]

        if raw_split == "train":
            word2index = build_vocab(
                [t for pair in zip(tok_titles, tok_abstracts) for t in pair]
            )
            entity2index = self._build_entity_map(news)
            categ2index = build_index_map(news["category"])
            subcateg2index = build_index_map(news["subcategory"])
            sentiment2index = build_index_map(news["sentiment_label"])
            for name, mapping, key in (
                ("word2index", word2index, "word"),
                ("entity2index", entity2index, "entity"),
                ("categ2index", categ2index, "category"),
                ("subcateg2index", subcateg2index, "subcategory"),
                ("sentiment2index", sentiment2index, "sentiment"),
            ):
                _map_to_tsv(mapping, key, self.map_path(name))
        else:
            if not os.path.exists(self.map_path("word2index")):
                self.load_news("train")  # dev depends on the train-built maps
            word2index = _load_idx_map(self.map_path("word2index"))
            entity2index = _load_idx_map(self.map_path("entity2index"))
            categ2index = _load_idx_map(self.map_path("categ2index"))
            subcateg2index = _load_idx_map(self.map_path("subcateg2index"))
            sentiment2index = _load_idx_map(self.map_path("sentiment2index"))

        if raw_split == "train" and self.cfg.word_embeddings_fpath:
            build_embedding_matrix(
                word2index, self.cfg.word_embeddings_fpath, self.cfg.word_embed_dim,
                seed=self.cfg.seed, out_fpath=os.path.join(d, "transformed_word_embeddings.npy"),
            )
            if self.cfg.use_pretrained_categ_embeddings:
                build_embedding_matrix(
                    categ2index, self.cfg.word_embeddings_fpath, self.cfg.categ_embed_dim,
                    seed=self.cfg.seed,
                    out_fpath=os.path.join(d, "transformed_categ_embeddings.npy"),
                )
        entity_vec = os.path.join(d, "entity_embedding.vec")
        if raw_split == "train" and os.path.exists(entity_vec):
            build_entity_embedding_matrix(
                entity2index, entity_vec, self.cfg.entity_embed_dim, seed=self.cfg.seed,
                out_fpath=os.path.join(d, "transformed_entity_embeddings.npy"),
            )

        news["tokenized_title"] = [tokens_to_ids(t, word2index) for t in tok_titles]
        news["tokenized_abstract"] = [tokens_to_ids(t, word2index) for t in tok_abstracts]
        news["category_class"] = [categ2index.get(c, 0) for c in news["category"]]
        news["subcategory_class"] = [subcateg2index.get(c, 0) for c in news["subcategory"]]
        news["sentiment_class"] = [sentiment2index.get(c, 0) for c in news["sentiment_label"]]
        for col in ("title_entities", "abstract_entities"):
            news[col] = [self._filter_entities(e, entity2index) for e in news[col]]
        _to_tsv(news, parsed)
        return news

    @staticmethod
    def _read_parsed_news(fpath: str) -> Dict[str, list]:
        raw = _read_table(fpath)
        news: Dict[str, list] = {k: [None if v in NA_VALUES else v for v in vals]
                                 for k, vals in raw.items()}
        for col in ("tokenized_title", "tokenized_abstract", "title_entities",
                    "abstract_entities"):
            news[col] = [ast.literal_eval(v) for v in raw[col]]
        for col in ("category_class", "subcategory_class", "sentiment_class"):
            news[col] = [int(v) for v in raw[col]]
        news["sentiment_score"] = [float(v) for v in raw["sentiment_score"]]
        news["abstract"] = [a or "" for a in news["abstract"]]
        return news

    def _build_entity_map(self, news: Dict[str, list]) -> Dict[str, int]:
        """Entities whose occurrences x confidence summed over the split
        exceed ``entity_freq_threshold``, numbered from 1."""
        freq: Dict[str, float] = {}
        for col in ("title_entities", "abstract_entities"):
            for row in news[col]:
                for ent in _parse_entities(row):
                    times = len(ent.get("OccurrenceOffsets", []) or []) * float(
                        ent.get("Confidence", 0.0)
                    )
                    wid = ent.get("WikidataId")
                    if wid and times > 0:
                        freq[wid] = freq.get(wid, 0.0) + times
        out: Dict[str, int] = {}
        for wid, f in freq.items():
            if f > self.cfg.entity_freq_threshold:
                out[wid] = len(out) + 1
        return out

    def _filter_entities(self, row, entity2index: Dict[str, int]) -> List[int]:
        """Entity JSON -> indices of the known entities above the confidence
        threshold."""
        out = []
        for ent in _parse_entities(row):
            if float(ent.get("Confidence", 0.0)) > self.cfg.entity_confidence_threshold:
                idx = entity2index.get(ent.get("WikidataId"), 0)
                if idx:
                    out.append(idx)
        return out

    # ---------- behaviors ----------

    def load_behaviors(self, split: str) -> Dict[str, list]:
        """The parsed behaviors of ``split`` (train, val or test) as columns
        ``uid``, ``user``, ``history``, ``candidates``, ``labels``."""
        raw_split = "dev" if split == "test" else "train"
        d = self.split_dir(raw_split)
        prefix = {"train": "train_", "val": "val_", "test": ""}[split]
        parsed = os.path.join(d, prefix + "parsed_behaviors.tsv")
        if os.path.exists(parsed):
            raw = _read_table(parsed)
            return {
                "uid": raw["uid"],
                "user": [int(u) for u in raw["user"]],
                "history": [_parse_str_list(x) for x in raw["history"]],
                "candidates": [_parse_str_list(x) for x in raw["candidates"]],
                "labels": [_parse_int_list(x) for x in raw["labels"]],
            }

        self.prepare_raw(raw_split)
        raw = _read_raw(os.path.join(d, "behaviors.tsv"), BEHAVIOR_COLUMNS)
        keep = [i for i, h in enumerate(raw["history"]) if h is not None and h.split()]
        uids = [raw["uid"][i] for i in keep]
        times = [datetime.strptime(raw["time"][i], TIME_FORMAT) for i in keep]
        history = [raw["history"][i].split() for i in keep]
        impressions = [raw["impressions"][i].split() for i in keep]
        split_at = datetime.fromisoformat(self.cfg.valid_time_split)
        if split == "train":
            sel = [i for i, t in enumerate(times) if t < split_at]
        elif split == "val":
            sel = [i for i, t in enumerate(times) if t >= split_at]
        else:
            sel = list(range(len(times)))
        uid_path = os.path.join(self.split_dir("train"), ID2INDEX_FILENAMES["uid2index"])
        if split == "train":
            uid2index: Dict[str, int] = {}
            for i in sel:
                if uids[i] not in uid2index:
                    uid2index[uids[i]] = len(uid2index) + 1
            _map_to_tsv(uid2index, "uid", uid_path)
        else:
            if not os.path.exists(uid_path):
                self.load_behaviors("train")  # builds uid2index
            uid2index = _load_idx_map(uid_path)

        bhv = {
            "uid": [uids[i] for i in sel],
            "user": [uid2index.get(uids[i], 0) for i in sel],
            "history": [history[i] for i in sel],
            "candidates": [[c.split("-")[0] for c in impressions[i]] for i in sel],
            "labels": [[int(c.split("-")[1]) for c in impressions[i]] for i in sel],
        }
        _to_tsv(bhv, parsed)
        return bhv

    # ---------- dense assembly ----------

    def news_store(self, split: str) -> NewsStore:
        """The dense tokenized store of the raw split behind ``split``."""
        raw_split = "dev" if split == "test" else "train"
        if raw_split in self._stores:
            return self._stores[raw_split]
        suffix = "_plm" if self.cfg.use_plm else ""
        cache = os.path.join(self.split_dir(raw_split), f"news_store{suffix}.npz")
        if os.path.exists(cache):
            store = NewsStore.load(cache)
        else:
            news = self.load_news(raw_split)
            if self.cfg.use_plm:
                width = self.cfg.tokenizer_max_len
                titles = self._plm_tokenize(news["title"], width)
                abstracts = self._plm_tokenize(news["abstract"], width)
                title_width = abstract_width = width
            else:
                titles, abstracts = news["tokenized_title"], news["tokenized_abstract"]
                title_width, abstract_width = self.cfg.max_title_len, self.cfg.max_abstract_len
            store = build_news_store(
                nids=news["nid"],
                tokenized_titles=titles,
                max_title_len=title_width,
                tokenized_abstracts=abstracts,
                max_abstract_len=abstract_width,
                categories=news["category_class"],
                subcategories=news["subcategory_class"],
                sentiments=news["sentiment_class"],
                sentiment_scores=news["sentiment_score"],
                title_entities=news["title_entities"],
                abstract_entities=news["abstract_entities"],
                max_entities=self.cfg.max_entities,
            )
            store.save(cache)
        self._stores[raw_split] = store
        return store

    def impressions(self, split: str) -> Impressions:
        """CSR impressions of ``split`` over the store's rows (cached as
        ``<prefix>impressions.npz``)."""
        raw_split = "dev" if split == "test" else "train"
        prefix = {"train": "train_", "val": "val_", "test": ""}[split]
        cache = os.path.join(self.split_dir(raw_split), prefix + "impressions.npz")
        if os.path.exists(cache):
            z = np.load(cache, allow_pickle=False)
            return Impressions(
                z["hist_flat"], z["hist_offsets"], z["cand_flat"],
                z["cand_offsets"], z["labels_flat"], z["user_idx"], z["user_ids"],
            )
        nid2row = self.news_store(split).nid2row
        bhv = self.load_behaviors(split)

        def csr(lists):
            offsets = np.zeros(len(lists) + 1, dtype=np.int64)
            np.cumsum([len(x) for x in lists], out=offsets[1:])
            rows = np.fromiter((nid2row.get(n, 0) for x in lists for n in x),
                               dtype=np.int64, count=int(offsets[-1]))
            return rows.astype(np.int32), offsets

        hist_flat, hist_off = csr(bhv["history"])
        cand_flat, cand_off = csr(bhv["candidates"])
        labels_flat = (np.concatenate([np.asarray(x, dtype=np.int8) for x in bhv["labels"]])
                       if bhv["labels"] else np.zeros(0, np.int8))
        user_ids = np.asarray([int(u.split("U")[-1]) for u in bhv["uid"]])
        imp = Impressions(
            hist_flat, hist_off, cand_flat, cand_off, labels_flat,
            np.asarray(bhv["user"], dtype=np.int32), user_ids,
        )
        np.savez_compressed(
            cache,
            hist_flat=imp.hist_flat, hist_offsets=imp.hist_offsets,
            cand_flat=imp.cand_flat, cand_offsets=imp.cand_offsets,
            labels_flat=imp.labels_flat, user_idx=imp.user_idx, user_ids=imp.user_ids,
        )
        return imp

    def num_users(self) -> int:
        fpath = os.path.join(self.split_dir("train"), ID2INDEX_FILENAMES["uid2index"])
        if not os.path.exists(fpath):
            self.load_behaviors("train")  # builds uid2index
        return len(_load_idx_map(fpath)) + 1

    def vocab_size(self) -> int:
        if not os.path.exists(self.map_path("word2index")):
            self.load_news("train")
        return len(_load_idx_map(self.map_path("word2index"))) + 1

    def num_classes(self) -> Dict[str, int]:
        if not os.path.exists(self.map_path("categ2index")):
            self.load_news("train")
        return {
            "category": len(_load_idx_map(self.map_path("categ2index"))) + 1,
            "subcategory": len(_load_idx_map(self.map_path("subcateg2index"))) + 1,
            "sentiment": len(_load_idx_map(self.map_path("sentiment2index"))) + 1,
            "entity": len(_load_idx_map(self.map_path("entity2index"))) + 1,
        }


def _parse_entities(row) -> List[dict]:
    if not isinstance(row, str) or not row.strip():
        return []
    try:
        parsed = ast.literal_eval(
            row.replace("true", "True").replace("false", "False").replace("null", "None")
        )
        return parsed if isinstance(parsed, list) else []
    except (ValueError, SyntaxError):
        try:
            return json.loads(row)
        except json.JSONDecodeError:
            return []


def _parse_str_list(x: str) -> List[str]:
    x = x.strip("[]")
    if not x:
        return []
    return [s.strip().strip("'\"") for s in x.split(",")]


def _parse_int_list(x: str) -> List[int]:
    x = x.strip("[]")
    return list(map(int, x.split(", "))) if x else []
