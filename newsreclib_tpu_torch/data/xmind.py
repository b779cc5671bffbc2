"""xMIND, multilingual MIND, without pandas (counterpart of
``newsreclib_tpu/data/xmind.py``; reference
``newsreclib/data/components/xmind_dataframe.py:22-605``).

MIND's behaviors and news metadata with target-language translations of
the news from ``xMIND/<lang>/<split>/news.tsv`` (``nid``, ``title``,
``abstract``): a translated article becomes an extra store row
``<nid>_<lang>`` that inherits the English article's metadata.
**Bilingual mixing** replaces ``ceil(pct * n)`` of an impression's history,
and of its positives and negatives drawn separately, with their translations
(``xmind_dataframe.py:497-539``).  Zero-shot: train in English, test with
``pct_tgt_lang_test``; bilingual: mix both.

The reference's xMIND is PLM-only; here the text stays word-level: the
train-built vocabulary is extended with the translations' words
(``xMIND/<lang>/word2index.tsv`` and a ``.meta.json`` fingerprint of the
base vocabulary), and the embedding matrix with vectors from a MUSE-style
aligned file (``xMIND/<lang>/aligned_embeddings.txt``), seeded random rows
for the words it lacks (``transformed_word_embeddings.npy`` there, which
``models/factory.py::load_data_info`` reads).

Reference behaviour kept: the mixing looks translations up in the first
store this object cached (``train`` in a CLI run), not in the split's own
store, as the JAX package does.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from newsreclib_tpu_torch.data.batching import Impressions
from newsreclib_tpu_torch.data.mind import MINDData, _load_idx_map, _map_to_tsv, _read_raw
from newsreclib_tpu_torch.data.news_store import NewsStore, pad_token_lists
from newsreclib_tpu_torch.data.tokenize import tokens_to_ids, word_tokenize

log = logging.getLogger("newsreclib_tpu_torch")

XNEWS_COLUMNS = ["nid", "title", "abstract"]


@dataclass
class XMINDConfig:
    tgt_lang: str = "fin"
    bilingual_train: bool = False
    bilingual_test: bool = False
    pct_tgt_lang_train: float = 0.5
    pct_tgt_lang_test: float = 1.0
    seed: int = 42


def _read_xnews(path: str) -> Dict[str, list]:
    """A translated ``news.tsv`` as columns; a missing abstract is ``""``."""
    xnews = _read_raw(path, XNEWS_COLUMNS)
    xnews["abstract"] = [a or "" for a in xnews["abstract"]]
    return xnews


class XMINDData:
    """A ``MINDData`` with translated news rows and bilingual mixing."""

    def __init__(self, mind: MINDData, cfg: XMINDConfig):
        self.mind = mind
        self.cfg = cfg
        self._stores: Dict[str, NewsStore] = {}
        self._ext_vocab = None

    def xmind_news_path(self, raw_split: str) -> str:
        return os.path.join(
            self.mind.cfg.data_dir, "xMIND", self.cfg.tgt_lang, raw_split, "news.tsv"
        )

    def news_store(self, split: str) -> NewsStore:
        """The MIND store extended with ``<nid>_<lang>`` rows for the
        translated news whose English article it holds."""
        raw_split = "dev" if split == "test" else "train"
        if raw_split in self._stores:
            return self._stores[raw_split]
        base = self.mind.news_store(split)
        xnews_path = self.xmind_news_path(raw_split)
        if not os.path.exists(xnews_path):
            raise FileNotFoundError(
                f"{xnews_path} missing: download xMIND {self.cfg.tgt_lang} news.tsv"
            )
        xnews = _read_xnews(xnews_path)
        keep = [i for i, n in enumerate(xnews["nid"]) if n in base.nid2row]
        xnews = {k: [v[i] for i in keep] for k, v in xnews.items()}

        word2index = self._word2index()
        tok_titles = [tokens_to_ids(word_tokenize(t), word2index) for t in xnews["title"]]
        tok_abstracts = [tokens_to_ids(word_tokenize(t), word2index) for t in xnews["abstract"]]
        base_rows = np.asarray([base.nid2row[n] for n in xnews["nid"]], dtype=np.int64)

        extra_title = pad_token_lists(tok_titles, base.title.shape[1])
        extra_abstract = (None if base.abstract is None
                          else pad_token_lists(tok_abstracts, base.abstract.shape[1]))

        def cat(a, b):
            if a is None or b is None:
                return a
            return np.concatenate([a, b], axis=0)

        def inherited(fieldname):
            arr = getattr(base, fieldname)
            return None if arr is None else arr[base_rows]

        nid2row = dict(base.nid2row)
        start = base.title.shape[0]
        for i, nid in enumerate(xnews["nid"]):
            nid2row[f"{nid}_{self.cfg.tgt_lang}"] = start + i

        store = NewsStore(
            nid2row=nid2row,
            title=cat(base.title, extra_title),
            abstract=cat(base.abstract, extra_abstract),
            **{f: cat(getattr(base, f), inherited(f)) for f in (
                "category", "subcategory", "sentiment", "sentiment_score",
                "title_entities", "abstract_entities")},
        )
        self._stores[raw_split] = store
        return store

    # ---- extended vocabulary / aligned embeddings --------------------------

    def lang_dir(self) -> str:
        return os.path.join(self.mind.cfg.data_dir, "xMIND", self.cfg.tgt_lang)

    def _word2index(self):
        return self._ensure_extended_vocab()[0]

    @staticmethod
    def _base_fingerprint(base: dict) -> str:
        """A content fingerprint of the base vocabulary: a base regenerated
        at the same size with another word order invalidates the extended
        caches."""
        items = sorted(base.items(), key=lambda kv: kv[1])
        h = hashlib.sha256(str(len(base)).encode())
        for w, i in items[:64] + items[-64:]:
            h.update(f"{w}:{i};".encode())
        return h.hexdigest()[:16]

    def _ensure_extended_vocab(self):
        """``(word2index extended with the translations' words, size of the
        base)``, cached in ``xMIND/<lang>/word2index.tsv`` while the base's
        fingerprint matches."""
        if self._ext_vocab is not None:
            return self._ext_vocab
        base = _load_idx_map(self.mind.map_path("word2index"))
        map_path = os.path.join(self.lang_dir(), "word2index.tsv")
        meta_path = os.path.join(self.lang_dir(), "word2index.meta.json")
        base_fp = self._base_fingerprint(base)
        if os.path.exists(map_path) and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("n_base") == len(base) and meta.get("base_fp") == base_fp:
                self._ext_vocab = (_load_idx_map(map_path), len(base))
                return self._ext_vocab

        ext = dict(base)
        found_any = False
        for raw_split in ("train", "dev"):
            p = self.xmind_news_path(raw_split)
            if not os.path.exists(p):
                continue
            found_any = True
            xnews = _read_xnews(p)
            for col in ("title", "abstract"):
                for text in xnews[col]:
                    for w in word_tokenize(text):
                        if w not in ext:
                            ext[w] = len(ext) + 1
        if found_any:
            # only a map that saw translated news is kept: a base-only map
            # would tokenize translations that arrive later to zeros
            _map_to_tsv(ext, "word", map_path)
            with open(meta_path, "w") as f:
                json.dump({"n_base": len(base), "base_fp": base_fp}, f)
        self._ext_vocab = (ext, len(base))
        return self._ext_vocab

    def ensure_word_embeddings(self) -> Optional[str]:
        """Build (or reuse) the extended embedding matrix and return its
        directory, or None without a base matrix."""
        self.mind.ensure_word_embeddings()
        base_npy = os.path.join(self.mind.split_dir("train"), "transformed_word_embeddings.npy")
        if not os.path.exists(base_npy):
            return None
        out = os.path.join(self.lang_dir(), "transformed_word_embeddings.npy")
        out_meta = out + ".meta.json"
        ext, n_base = self._ensure_extended_vocab()
        base_fp = self._base_fingerprint(_load_idx_map(self.mind.map_path("word2index")))
        if os.path.exists(out) and os.path.exists(out_meta):
            with open(out_meta) as f:
                m = json.load(f)
            # the row count alone does not tell a regenerated base vocabulary
            if np.load(out, mmap_mode="r").shape[0] == len(ext) + 1 and m.get(
                    "base_fp") == base_fp:
                return self.lang_dir()
        base = np.load(base_npy)
        dim = base.shape[1]
        n_new = len(ext) - n_base
        rng = np.random.default_rng(self.cfg.seed)
        rows = rng.normal(size=(n_new, dim)).astype(np.float32)
        aligned = os.path.join(self.lang_dir(), "aligned_embeddings.txt")
        if os.path.exists(aligned):
            hit = 0
            with open(aligned, encoding="utf-8") as f:
                for line in f:
                    parts = line.rstrip().split(" ")
                    if len(parts) < dim + 1:
                        continue
                    idx = ext.get(parts[0])
                    if idx is not None and idx > n_base:
                        rows[idx - n_base - 1] = np.asarray(parts[-dim:], dtype=np.float32)
                        hit += 1
            log.info("xMIND aligned embeddings: %d/%d translated words matched", hit, n_new)
            if n_new and hit == 0:
                log.warning("aligned_embeddings.txt matched no translated word: zero-shot "
                            "transfer will not work (format drift?)")
        matrix = np.vstack([base, rows])
        np.save(out, matrix)
        with open(out_meta, "w") as f:
            json.dump({"base_fp": base_fp, "n_rows": matrix.shape[0]}, f)
        return self.lang_dir()

    def impressions(self, split: str) -> Impressions:
        """MIND behaviors with bilingual mixing as the split's config says:
        ``train`` / ``val`` mixed at ``pct_tgt_lang_train`` when
        ``bilingual_train``, ``test`` always at ``pct_tgt_lang_test``; the
        draws from ``default_rng((seed, split index))``."""
        store = self.news_store(split)
        bhv = self.mind.load_behaviors(split)
        train_like = split in ("train", "val")
        pct = self.cfg.pct_tgt_lang_train if train_like else self.cfg.pct_tgt_lang_test
        if train_like and not self.cfg.bilingual_train:
            pct = 0.0
        split_ix = {"train": 0, "val": 1, "test": 2}.get(split, 3)
        rng = np.random.default_rng((self.cfg.seed, split_ix))

        histories, candidates, labels_out, user_idx = [], [], [], []
        for hist, cands, labels, user in zip(
            bhv["history"], bhv["candidates"], bhv["labels"], bhv["user"]
        ):
            if pct > 0:
                hist = self._mix(hist, pct, rng)
                cands = self._mix_candidates(cands, labels, pct, rng)
            histories.append(store.rows(hist))
            candidates.append(store.rows(cands))
            labels_out.append(labels)
            user_idx.append(user)
        user_ids = [int(u.split("U")[-1]) for u in bhv["uid"]]
        return Impressions.from_lists(histories, candidates, labels_out, user_idx, user_ids)

    def _tgt(self, nid: str) -> str:
        return f"{nid}_{self.cfg.tgt_lang}"

    def _first_store(self) -> NewsStore:
        """The store cached first (the reference behaviour the module doc names)."""
        return next(iter(self._stores.values()))

    def _mix(self, nids: List[str], pct: float, rng) -> List[str]:
        """Replace ``ceil(pct * len)`` random entries with their translation
        where the store has one (``xmind_dataframe.py:497-510``)."""
        if not nids:
            return nids
        store = self._first_store()
        n_replace = math.ceil(pct * len(nids))
        chosen = set(
            rng.choice(np.asarray(nids, dtype=object), size=n_replace, replace=False).tolist()
        )
        return [self._tgt(n) if n in chosen and self._tgt(n) in store.nid2row else n
                for n in nids]

    def _mix_candidates(self, cands: List[str], labels: List[int], pct: float,
                        rng) -> List[str]:
        """Positives and negatives drawn separately (``:512-539``)."""
        pos = [c for c, lab in zip(cands, labels) if lab == 1]
        neg = [c for c, lab in zip(cands, labels) if lab != 1]
        chosen = set()
        for group in (pos, neg):
            if group:
                k = math.ceil(pct * len(group))
                chosen |= set(
                    rng.choice(np.asarray(group, dtype=object), size=k, replace=False).tolist()
                )
        store = self._first_store()
        return [self._tgt(c) if c in chosen and self._tgt(c) in store.nid2row else c
                for c in cands]

    # pass-throughs
    def vocab_size(self) -> int:
        return len(self._ensure_extended_vocab()[0]) + 1

    def num_users(self) -> int:
        return self.mind.num_users()

    def num_classes(self) -> Dict[str, int]:
        return self.mind.num_classes()

    def split_dir(self, raw_split: str) -> str:
        return self.mind.split_dir(raw_split)
