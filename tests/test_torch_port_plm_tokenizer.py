"""The port's reader of PLM tokenizer files (``data/plm_tokenizer.py``)
against ``transformers.AutoTokenizer`` on the CPU, id for id, as the JAX ETL
calls it (``truncation=True, max_length=..., padding=False``).

Tokenizer directories, made here: a lowercasing, accent-stripping WordPiece
and a cased WordPiece, and a RoBERTa-style byte-level BPE
(``add_prefix_space`` false), each trained with ``tokenizers`` on the demo
corpus and saved by ``transformers``; a copy of each with the legacy files
only (no ``tokenizer.json``); copies that ``transformers`` adjusts on
loading (added tokens with ``single_word``, ``lstrip`` / ``rstrip`` and
``normalized``; ``add_prefix_space`` and ``do_lower_case`` set in
``tokenizer_config.json`` over ``tokenizer.json``); and both kinds of
``write_fixture_tokenizer``.
Texts: ``data/demo``'s titles and abstracts, statfix-style texts
(``w3_12 c45 good``) and, with ``hypothesis``, Unicode text with accents,
CJK, punctuation, digits, control characters, whitespace runs, added-token
literals and the empty string, at ``max_len`` 96 and at 8 (which
truncates).  The Unicode classes behind the normalizer and the
pre-tokenizers are held against ``tokenizers`` at every code point.  The
refusals: a path that is not a local directory (with no network call), a
directory without tokenizer files, and each unsupported component.
"""

import json
import shutil
import socket
import string
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from newsreclib_tpu_torch.data import plm_tokenizer as pt
from newsreclib_tpu_torch.data import statfix
from newsreclib_tpu_torch.data.testing import write_fixture_tokenizer

ROOT = Path(__file__).resolve().parents[1]
SPECIALS = {"bert": ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
            "roberta": ["<s>", "<pad>", "</s>", "<unk>", "<mask>"]}
TRAINED = ("wordpiece_lower", "wordpiece_cased", "bpe")
# copies that ``transformers`` adjusts on loading: added tokens with every
# flag, tokenizer_config.json's add_prefix_space and do_lower_case over
# tokenizer.json's
ADJUSTED = ("wordpiece_added", "bpe_prefix_space", "wordpiece_config_lower",
            "wordpiece_model_type", "wordpiece_sequence")
TOKENIZERS = (TRAINED + tuple(f"{n}_legacy" for n in TRAINED) + ADJUSTED
              + ("fixture_wordpiece", "fixture_bpe"))


def demo_texts():
    texts = []
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        with open(ROOT / "data" / "demo" / split / "news.tsv", encoding="utf-8") as f:
            for line in f:
                fields = line.rstrip("\n").split("\t")
                texts += [fields[3], fields[4]]
    return texts


def statfix_texts(n=300, seed=0):
    """Titles drawn as the statfix generator draws them: category words,
    common words and sentiment words."""
    rng = np.random.default_rng(seed)
    _, sig, common = statfix._make_vocab()
    out = []
    for _ in range(n):
        c = int(rng.integers(0, statfix.N_CATEGORIES))
        words = list(rng.choice(sig[c], size=int(rng.integers(4, 10))))
        words += list(rng.choice(common, size=int(rng.integers(1, 6))))
        words += list(rng.choice(statfix._POS + statfix._NEG, size=int(rng.integers(0, 3))))
        rng.shuffle(words)
        out.append(" ".join(words))
    return out


TEXTS = {"demo": demo_texts(), "statfix": statfix_texts()}


def _train(kind: str, out: Path) -> None:
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers
    from tokenizers import processors, trainers
    from transformers import BertTokenizerFast, RobertaTokenizerFast

    corpus = TEXTS["demo"] + TEXTS["statfix"][:100]
    if kind == "bpe":
        tok = Tokenizer(models.BPE())
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.train_from_iterator(corpus, trainers.BpeTrainer(
            vocab_size=700, special_tokens=SPECIALS["roberta"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
        tok.post_processor = processors.RobertaProcessing(
            ("</s>", tok.token_to_id("</s>")), ("<s>", tok.token_to_id("<s>")))
        tok.decoder = decoders.ByteLevel()
        RobertaTokenizerFast(tokenizer_object=tok).save_pretrained(str(out))
        return
    lower = kind == "wordpiece_lower"
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.BertNormalizer(lowercase=lower)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.train_from_iterator(corpus, trainers.WordPieceTrainer(
        vocab_size=500, special_tokens=SPECIALS["bert"]))
    cls, sep = tok.token_to_id("[CLS]"), tok.token_to_id("[SEP]")
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
        special_tokens=[("[CLS]", cls), ("[SEP]", sep)])
    tok.decoder = decoders.WordPiece()
    BertTokenizerFast(tokenizer_object=tok, do_lower_case=lower).save_pretrained(str(out))


@pytest.fixture(scope="module")
def tokenizer_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    dirs = {}
    for name in TRAINED:
        _train(name, root / name)
        legacy = root / f"{name}_legacy"
        shutil.copytree(root / name, legacy)
        (legacy / "tokenizer.json").unlink()
        dirs[name], dirs[f"{name}_legacy"] = root / name, legacy
    from tokenizers import AddedToken
    from transformers import AutoTokenizer

    hf = AutoTokenizer.from_pretrained(str(root / "wordpiece_lower"))
    hf.add_tokens([AddedToken("hello world", single_word=True, normalized=True),
                   AddedToken("foo", lstrip=True, rstrip=True, normalized=False),
                   AddedToken("bar_", single_word=True, normalized=False),
                   AddedToken("été", normalized=True)])
    hf.save_pretrained(str(root / "wordpiece_added"))
    dirs["wordpiece_added"] = root / "wordpiece_added"
    for name, base, key in (("bpe_prefix_space", "bpe", "add_prefix_space"),
                            ("wordpiece_config_lower", "wordpiece_cased", "do_lower_case")):
        shutil.copytree(root / base, root / name)
        config = json.loads((root / name / "tokenizer_config.json").read_text())
        assert config[key] is False
        (root / name / "tokenizer_config.json").write_text(json.dumps(dict(config, **{key: True})))
        dirs[name] = root / name
    # no tokenizer class named: config.json's model type picks BERT's, which
    # lowercases by default
    d = root / "wordpiece_model_type"
    shutil.copytree(root / "wordpiece_cased", d)
    config = json.loads((d / "tokenizer_config.json").read_text())
    del config["tokenizer_class"], config["do_lower_case"]
    (d / "tokenizer_config.json").write_text(json.dumps(config))
    (d / "config.json").write_text(json.dumps({"model_type": "bert"}))
    dirs[d.name] = d
    # the normalizer inside a Sequence (transformers leaves it as it is)
    d = root / "wordpiece_sequence"
    shutil.copytree(root / "wordpiece_lower", d)
    tok = json.loads((d / "tokenizer.json").read_text())
    tok["normalizer"] = {"type": "Sequence", "normalizers": [tok["normalizer"]]}
    (d / "tokenizer.json").write_text(json.dumps(tok))
    dirs[d.name] = d
    for kind, size in (("wordpiece", 300), ("bpe", 400)):
        dirs[f"fixture_{kind}"] = Path(write_fixture_tokenizer(
            str(root / f"fixture_{kind}"), TEXTS["demo"], kind, size))
    return dirs


@pytest.fixture(scope="module")
def loaded(tokenizer_dirs):
    """``name -> (AutoTokenizer, the port's reader)``."""
    from transformers import AutoTokenizer

    return {name: (AutoTokenizer.from_pretrained(str(d)), pt.load_tokenizer(str(d)))
            for name, d in tokenizer_dirs.items()}


def assert_same_ids(pair, texts, max_len):
    hf, ours = pair
    want = hf(list(texts), truncation=True, max_length=max_len, padding=False)["input_ids"]
    got = ours.encode_batch(texts, max_len)
    bad = [(t, w, g) for t, w, g in zip(texts, want, got) if w != g]
    assert not bad, bad[:3]


@pytest.mark.parametrize("max_len", [96, 8])
@pytest.mark.parametrize("texts", sorted(TEXTS))
@pytest.mark.parametrize("name", TOKENIZERS)
def test_reader_matches_autotokenizer(loaded, name, texts, max_len):
    assert_same_ids(loaded[name], TEXTS[texts], max_len)
    if max_len == 8:  # the specials are counted: the text keeps 6 pieces
        assert max(len(ids) for ids in loaded[name][1].encode_batch(TEXTS[texts], 8)) == 8


def test_the_legacy_files_give_the_same_ids(loaded):
    """Without ``tokenizer.json`` the reader builds what ``transformers``
    converts the legacy files to: the same ids as the full directory."""
    for name in TRAINED:
        full, legacy = loaded[name][1], loaded[f"{name}_legacy"][1]
        texts = TEXTS["demo"][:50] + ["[MASK] <mask> [SEP]", "ÉTÉ été", ""]
        assert full.encode_batch(texts, 96) == legacy.encode_batch(texts, 96), name


ACCENTS = "éÉèüÜñÅøæçœ" + "\u0327\u0301\u0308"  # and combining marks
CJK = "中文字日本語漢字한국어カタカナ"
PUNCT = string.punctuation + "¿¡«»—–…“”‘’·•§"
DIGITS = string.digits + "٣۴३¹½"
CONTROL = "\x00\x01\x07\x1b\x1c\x1f\x7f\x85\u200b\u200d\ufeff\ufffd"
SPACES = " \t\n\r\x0b\x0c\xa0\u2009\u3000"
LITERALS = ["[SEP]", "[CLS]", "[MASK]", "[PAD]", "[UNK]", "[sep]", "<mask>", "<s>", "</s>",
            "<pad>", " <mask>", "'ll", "'s", "'RE", "w3_12", "c45", "good", "hello world",
            "Hello World", " foo ", "foo", "bar_", "été", "ÉTÉ"]
PIECES = st.one_of(
    st.text(alphabet=st.sampled_from(string.ascii_letters + ACCENTS + CJK + PUNCT + DIGITS),
            max_size=8),
    st.text(alphabet=st.sampled_from(CONTROL + SPACES), min_size=1, max_size=4),
    st.sampled_from(LITERALS),
    st.text(max_size=4),  # any code point
    st.characters(min_codepoint=0x4E00, max_codepoint=0x9FFF),
)
UNICODE_TEXTS = st.lists(PIECES, max_size=10).map("".join)


@pytest.mark.parametrize("name", TOKENIZERS)
@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(texts=st.lists(UNICODE_TEXTS, min_size=1, max_size=6))
def test_reader_matches_autotokenizer_on_unicode(loaded, name, texts):
    for max_len in (96, 8):
        assert_same_ids(loaded[name], texts, max_len)


def test_a_text_that_is_not_a_string_is_empty(loaded):
    hf, ours = loaded["wordpiece_lower"]
    assert ours.encode_batch([None, float("nan"), 3], 96) == [ours.encode("", 96)] * 3
    assert ours.encode("", 96) == hf([""])["input_ids"][0]


# Every code point, in strings of 2,048 ("a<c>b " each), through the
# normalizer and the pre-tokenizers of both: the Unicode classes and the
# exception tables of the port's reader.
CODE_POINTS = [chr(c) for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
CHUNK = 2048


def _differing(fn_want, fn_got, pattern, code_points=CODE_POINTS):
    bad = []
    for i in range(0, len(code_points), CHUNK):
        chunk = code_points[i:i + CHUNK]
        if fn_want(pattern(chunk)) != fn_got(pattern(chunk)):
            bad += [hex(ord(c)) for c in chunk if fn_want(pattern([c])) != fn_got(pattern([c]))]
    return bad


@pytest.mark.parametrize("opts", [dict(lowercase=True), dict(lowercase=False,
                                                             strip_accents=True)],
                         ids=["lowercase", "cased_strip_accents"])
def test_bert_normalizer_matches_at_every_code_point(opts):
    from tokenizers import normalizers

    want = normalizers.BertNormalizer(**opts).normalize_str
    assert _differing(want, pt.BertNormalizer(**opts),
                      lambda cs: "".join(f"a{c}b " for c in cs)) == []


def test_bert_pre_tokenizer_matches_at_every_code_point():
    from tokenizers import pre_tokenizers

    hf = pre_tokenizers.BertPreTokenizer()
    assert _differing(lambda s: [w for w, _ in hf.pre_tokenize_str(s)], pt.bert_pre_tokenize,
                      lambda cs: "".join(f"a{c}b " for c in cs)) == []


BYTE_LEVEL_PATTERNS = {"between_letters": lambda cs: "".join(f"a{c}b " for c in cs),
                       "doubled_with_contraction": lambda cs: "".join(f"{c}{c}1'll  {c}x"
                                                                      for c in cs)}


@pytest.mark.parametrize("half", [0, 1])
@pytest.mark.parametrize("pattern", BYTE_LEVEL_PATTERNS)
def test_byte_level_split_matches_at_every_code_point(pattern, half):
    """Each pattern and each half of the code points is a case of its own,
    so that the passes over every code point run on several workers."""
    from tokenizers import pre_tokenizers

    hf = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    ours = pt.ByteLevel(add_prefix_space=False)
    cut = len(CODE_POINTS) // 2 // CHUNK * CHUNK
    assert _differing(lambda s: [w for w, _ in hf.pre_tokenize_str(s)], ours,
                      BYTE_LEVEL_PATTERNS[pattern],
                      CODE_POINTS[cut:] if half else CODE_POINTS[:cut]) == []


def test_fixture_tokenizers_are_deterministic(tmp_path, tokenizer_dirs):
    """Written twice from the same texts, every file is the same; the
    specials take ids 0-4 and the vocabulary holds at most ``vocab_size``
    tokens (the characters and the specials always)."""
    for kind, size in (("wordpiece", 300), ("bpe", 400)):
        again = Path(write_fixture_tokenizer(str(tmp_path / kind), TEXTS["demo"], kind, size))
        first = tokenizer_dirs[f"fixture_{kind}"]
        names = sorted(p.name for p in first.iterdir())
        assert names == sorted(p.name for p in again.iterdir())
        assert all((first / n).read_bytes() == (again / n).read_bytes() for n in names)
        spec = json.loads((first / "tokenizer.json").read_text())
        vocab = spec["model"]["vocab"]
        family = "bert" if kind == "wordpiece" else "roberta"
        assert [vocab[t] for t in SPECIALS[family]] == list(range(5))
        assert len(vocab) <= size
    small = pt.load_tokenizer(write_fixture_tokenizer(str(tmp_path / "chars"), ["Ab cd"],
                                                      "wordpiece", 0))
    assert len(small.model.vocab) == 5 + 2 * 4  # a, b, c, d and their ## forms
    assert small.encode("abc dab", 96) == [2, 5, 10, 11, 8, 9, 10, 3]


def test_a_path_that_is_not_a_local_directory_is_refused_without_fetching(monkeypatch,
                                                                          tmp_path):
    def no_network(*a, **k):
        raise AssertionError("a network call was made")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    for path in ("roberta-base", "NbAiLab/nb-bert-base", str(tmp_path / "absent")):
        with pytest.raises(FileNotFoundError, match="fetches nothing") as err:
            pt.load_tokenizer(path)
        assert "tokenizer.json" in str(err.value) and "vocab.txt" in str(err.value)
    with pytest.raises(FileNotFoundError, match="holds none of tokenizer.json, vocab.txt"):
        pt.load_tokenizer(str(tmp_path))


@pytest.mark.parametrize("part,spec,named", [
    ("model", {"type": "Unigram", "vocab": [["<unk>", 0.0]]}, "Unigram"),
    ("model", {"type": "WordLevel", "vocab": {"a": 0}}, "WordLevel"),
    ("normalizer", {"type": "NFKC"}, "NFKC"),
    ("normalizer", {"type": "Sequence", "normalizers": [{"type": "Lowercase"}]}, "Lowercase"),
    ("model", {"type": "BPE", "vocab": {"a": 0}, "merges": [],
               "continuing_subword_prefix": "##"}, "BPE option continuing_subword_prefix"),
    ("pre_tokenizer", {"type": "Metaspace", "replacement": "▁"}, "Metaspace"),
    ("pre_tokenizer", None, "None"),
    ("post_processor", {"type": "Custom"}, "Custom"),
])
def test_unsupported_components_are_refused_by_name(tokenizer_dirs, tmp_path, part, spec,
                                                    named):
    d = tmp_path / "tok"
    shutil.copytree(tokenizer_dirs["wordpiece_lower"], d)
    tok = json.loads((d / "tokenizer.json").read_text())
    tok[part] = spec
    (d / "tokenizer.json").write_text(json.dumps(tok))
    with pytest.raises(ValueError, match=f"unsupported .*{named}"):
        pt.load_tokenizer(str(d))
