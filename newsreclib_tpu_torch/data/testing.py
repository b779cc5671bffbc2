"""Synthetic raw fixtures (a copy of ``newsreclib_tpu/data/testing.py``,
with the same seeds and outputs): MIND's ``news.tsv`` / ``behaviors.tsv`` /
``entity_embedding.vec`` in the raw layout the ETL consumes plus a tiny
GloVe-format file, and a tar.gz of Adressa one_week event files.  Nothing is
downloaded.  The port's own additions: ``write_fixture_tokenizer``, a
WordPiece or byte-level BPE tokenizer directory learned from a corpus, and
``write_fixture_classifier``, a random BERT / RoBERTa sequence classifier
beside one.
"""

from __future__ import annotations

import json
import os
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np

from newsreclib_tpu_torch.data import plm_tokenizer as pt

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


FIXTURE_SPECIALS = {
    "wordpiece": {"pad_token": "[PAD]", "unk_token": "[UNK]", "cls_token": "[CLS]",
                  "sep_token": "[SEP]", "mask_token": "[MASK]"},
    "bpe": {"bos_token": "<s>", "pad_token": "<pad>", "eos_token": "</s>", "unk_token": "<unk>",
            "mask_token": "<mask>"},
}


def _learn_bpe_merges(words: Counter, vocab: Dict[str, int], vocab_size: int):
    """Merges learned greedily: the most frequent adjacent pair of the
    corpus's words (the first in order of sort among equals) until the
    vocabulary holds ``vocab_size`` tokens or no pair occurs twice."""
    splits = {w: list(w) for w in words}
    merges = []
    while len(vocab) < vocab_size:
        pairs: Counter = Counter()
        for w, n in words.items():
            s = splits[w]
            for pair in zip(s, s[1:]):
                pairs[pair] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=lambda p: pairs[p])
        if pairs[best] < 2:
            break
        merges.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        for w, s in splits.items():
            i = 0
            while i < len(s) - 1:
                if (s[i], s[i + 1]) == best:
                    s[i:i + 2] = [best[0] + best[1]]
                i += 1
    return merges


def write_fixture_tokenizer(out_dir: str, texts, kind: str = "wordpiece",
                            vocab_size: int = 1000) -> str:
    """Write a deterministic tokenizer directory in the Hugging Face format
    (``tokenizer.json``, the legacy files and ``tokenizer_config.json``)
    learned from ``texts``, for tests and smoke runs where no pretrained
    tokenizer files are at hand.  ``kind="wordpiece"``: a lowercasing,
    accent-stripping BERT WordPiece tokenizer whose vocabulary is the
    specials, every character of the corpus with its ``##`` form, then the
    most frequent whole words (first seen first among equals) up to
    ``vocab_size``.  ``kind="bpe"``: a RoBERTa byte-level BPE tokenizer
    (``add_prefix_space`` false): the specials, the 256 byte characters,
    then merges learned greedily from the corpus up to ``vocab_size``.
    Returns ``out_dir``."""
    specials = FIXTURE_SPECIALS[kind]
    vocab: Dict[str, int] = {}
    for tok in dict.fromkeys(specials.values()):
        vocab[tok] = len(vocab)
    texts = [t for t in texts if isinstance(t, str)]
    added = [{"id": vocab[t], "content": t, "single_word": False,
              "lstrip": kind == "bpe" and t == "<mask>", "rstrip": False, "normalized": False,
              "special": True} for t in vocab]
    os.makedirs(out_dir, exist_ok=True)
    if kind == "wordpiece":
        norm = pt.BertNormalizer(lowercase=True)
        words = Counter(w for t in texts for w in pt.bert_pre_tokenize(norm(t)))
        chars = sorted({c for w in words for c in w})
        for tok in chars + ["##" + c for c in chars]:
            vocab.setdefault(tok, len(vocab))
        for w, _ in sorted(words.items(), key=lambda kv: -kv[1]):
            if len(vocab) >= vocab_size:
                break
            vocab.setdefault(w, len(vocab))
        model = {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                 "max_input_chars_per_word": 100, "vocab": vocab}
        pipeline = {
            "normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": True, "strip_accents": None,
                           "lowercase": True},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {
                "type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}},
                           {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
                "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                         {"Sequence": {"id": "A", "type_id": 0}},
                         {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                         {"Sequence": {"id": "B", "type_id": 1}},
                         {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
                "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                                   for t in ("[CLS]", "[SEP]")}},
            "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        }
        config = {"tokenizer_class": "BertTokenizer", "do_lower_case": True,
                  "strip_accents": None, "tokenize_chinese_chars": True}
        with open(os.path.join(out_dir, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("".join(t + "\n" for t in vocab))
    elif kind == "bpe":
        for b in range(256):
            vocab.setdefault(pt.BYTE_CHARS[b], len(vocab))
        split = pt.ByteLevel(add_prefix_space=False)
        words = Counter(w for t in texts for w in split(t))
        merges = _learn_bpe_merges(words, vocab, vocab_size)
        model = {"type": "BPE", "dropout": None, "unk_token": None,
                 "continuing_subword_prefix": None, "end_of_word_suffix": None,
                 "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                 "vocab": vocab, "merges": [list(m) for m in merges]}
        pipeline = {
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                              "trim_offsets": True, "use_regex": True},
            "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", vocab["</s>"]],
                               "cls": ["<s>", vocab["<s>"]], "trim_offsets": True,
                               "add_prefix_space": False},
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True},
        }
        config = {"tokenizer_class": "RobertaTokenizer", "add_prefix_space": False,
                  "errors": "replace", "trim_offsets": True}
        with open(os.path.join(out_dir, "vocab.json"), "w", encoding="utf-8") as f:
            json.dump(vocab, f, ensure_ascii=False)
        with open(os.path.join(out_dir, "merges.txt"), "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    else:
        raise ValueError(f"unknown fixture tokenizer kind {kind!r}: wordpiece or bpe")
    tokenizer = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
                 **pipeline, "model": model}
    with open(os.path.join(out_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tokenizer, f, ensure_ascii=False)
    decoder = {str(t["id"]): {k: t[k] for k in ("content", "lstrip", "normalized", "rstrip",
                                                "single_word", "special")} for t in added}
    names = dict(specials, **({"sep_token": "</s>", "cls_token": "<s>"} if kind == "bpe" else {}))
    config.update({"added_tokens_decoder": decoder, "clean_up_tokenization_spaces": False,
                   "model_max_length": 512, **names})
    special_map = dict(names)
    if kind == "bpe":  # the mask token with its flags, as transformers writes it
        special_map["mask_token"] = {k: v for k, v in decoder[str(vocab["<mask>"])].items()
                                     if k != "special"}
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, ensure_ascii=False)
    with open(os.path.join(out_dir, "special_tokens_map.json"), "w", encoding="utf-8") as f:
        json.dump(special_map, f, indent=2, ensure_ascii=False)
    return out_dir


FIXTURE_LABELS = {1: ("LABEL_0",), 2: ("NEGATIVE", "POSITIVE"),
                  3: ("negative", "neutral", "positive")}


def write_fixture_classifier(out_dir: str, texts, kind: str = "bpe", num_labels: int = 3,
                             hidden_dim: int = 64, num_layers: int = 2, num_heads: int = 4,
                             intermediate_dim: int = 128, max_len: int = 64,
                             vocab_size: int = 1000, seed: int = 0) -> str:
    """Write a sequence-classification checkpoint directory with random
    weights from ``seed`` beside ``write_fixture_tokenizer``'s files of
    ``kind`` learned from ``texts``: a ``RobertaForSequenceClassification``
    for ``bpe``, a ``BertForSequenceClassification`` for ``wordpiece``, the
    labels of ``FIXTURE_LABELS[num_labels]``, truncation at ``max_len``
    tokens (``model_max_length``).  For tests and smoke runs of the BERT
    sentiment annotator where no pretrained classifier is at hand.  Returns
    ``out_dir``."""
    import torch

    from newsreclib_tpu_torch.models.components.plm import (
        SequenceClassifier,
        save_as_hf_classifier,
    )

    write_fixture_tokenizer(out_dir, texts, kind, vocab_size)
    config_path = os.path.join(out_dir, "tokenizer_config.json")
    with open(config_path, encoding="utf-8") as f:
        config = json.load(f)
    config["model_max_length"] = max_len
    with open(config_path, "w", encoding="utf-8") as f:
        json.dump(config, f, indent=2, ensure_ascii=False)
    roberta = kind == "bpe"
    encoder = dict(vocab_size=pt.load_tokenizer(out_dir).max_id() + 1, hidden_dim=hidden_dim,
                   num_layers=num_layers, num_heads=num_heads,
                   intermediate_dim=intermediate_dim,
                   max_position=max_len + 2 if roberta else max_len,
                   type_vocab_size=1 if roberta else 2, dropout=0.1,
                   layer_norm_eps=1e-5 if roberta else 1e-12, pad_token_id=1 if roberta else 0,
                   position_offset=2 if roberta else 0)
    model = SequenceClassifier(encoder, num_labels, torch.Generator().manual_seed(seed))
    return save_as_hf_classifier(model, encoder, dict(enumerate(FIXTURE_LABELS[num_labels])),
                                 out_dir, "roberta" if roberta else "bert")


def main(argv=None) -> None:
    """``python -m newsreclib_tpu_torch.data.testing OUT_DIR NEWS_TSV ...
    [--kind wordpiece|bpe] [--vocab-size N]``: ``write_fixture_tokenizer``
    learned from the titles and abstracts of MIND-layout ``news.tsv``
    files."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("news_tsv", nargs="+")
    ap.add_argument("--kind", default="wordpiece", choices=sorted(FIXTURE_SPECIALS))
    ap.add_argument("--vocab-size", type=int, default=1000)
    args = ap.parse_args(argv)
    texts = []
    for path in args.news_tsv:
        with open(path, encoding="utf-8") as f:
            for line in f:
                texts += line.rstrip("\n").split("\t")[3:5]
    write_fixture_tokenizer(args.out_dir, texts, args.kind, args.vocab_size)
    print(json.dumps({"out_dir": args.out_dir, "texts": len(texts),
                      "vocab_size": pt.load_tokenizer(args.out_dir).max_id() + 1}))


if __name__ == "__main__":
    main()
