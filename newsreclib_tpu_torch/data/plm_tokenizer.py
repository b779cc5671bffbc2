"""Tokenizers of pretrained language models read from local files, without
``transformers``, ``tokenizers`` or ``regex`` (counterpart of the JAX ETL's
``AutoTokenizer.from_pretrained(cfg.plm_tokenizer)``, ``newsreclib_tpu/data/
mind.py:347-357`` and ``adressa.py:272-282``).

``load_tokenizer(path).encode_batch(texts, max_len)`` gives, id for id, what
``AutoTokenizer.from_pretrained(path)(texts, truncation=True,
max_length=max_len, padding=False)["input_ids"]`` gives; a text that is not
a string is ``""``.  ``path`` must be a local directory; nothing is fetched.

It reads ``tokenizer.json`` (the ``tokenizers`` serialization) with

* a ``WordPiece`` or ``BPE`` model;
* a ``BertNormalizer``, no normalizer, or a ``Sequence`` of those;
* a ``BertPreTokenizer`` or a ``ByteLevel`` pre-tokenizer;
* a ``BertProcessing``, ``RobertaProcessing`` or ``TemplateProcessing``
  post-processor;
* its ``added_tokens``, split out of the raw text (``normalized`` false) or
  of the normalized text (``normalized`` true) before the pre-tokenizer,
  with their ``lstrip``, ``rstrip`` and ``single_word`` flags;

and, where ``tokenizer.json`` is absent, the files ``AutoTokenizer``
converts from: ``vocab.txt`` (a BERT WordPiece tokenizer, with
``tokenizer_config.json``'s ``do_lower_case``, ``strip_accents`` and
``tokenize_chinese_chars``) or ``vocab.json`` with ``merges.txt`` (a RoBERTa
byte-level BPE tokenizer).  ``tokenizer_config.json`` adjusts either as
``transformers`` does on loading: its ``add_prefix_space`` (default false)
replaces a ``ByteLevel`` pre-tokenizer's, a BERT tokenizer class's
``do_lower_case`` (default true), ``strip_accents`` and
``tokenize_chinese_chars`` replace its ``BertNormalizer``'s, and the special
tokens it or the class names that are not added tokens yet are added.  Any
other model, normalizer, pre-tokenizer or post-processor raises, naming it.

Unicode classes follow the Rust crates behind ``tokenizers``: whitespace is
the ``White_Space`` property (``str.isspace`` also takes U+001C-U+001F),
control characters are the ``Cc``, ``Cf`` and ``Co`` categories but tab,
newline and carriage return, punctuation is ASCII 33-47, 58-64, 91-96,
123-126 and the ``P*`` categories, letters and numbers of the byte-level
split are ``L*`` and ``N*``; ``unicodedata`` gives them, and the tables
below correct it where those crates' Unicode versions differ.
"""

from __future__ import annotations

import heapq
import json
import os
import unicodedata
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

# Rust's char::is_whitespace (the White_Space property), also Oniguruma's \s
WHITESPACE = frozenset(map(chr, (*range(0x9, 0xE), 0x20, 0x85, 0xA0, 0x1680,
                                 *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F,
                                 0x3000)))
# BertNormalizer's CJK blocks (tokenizers' is_chinese_char)
CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
              (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))
BERT_CLASSES = ("BertTokenizer", "BertTokenizerFast")
# the special tokens a tokenizer class adds where its files do not name them
CLASS_SPECIALS = {
    "bert": {"unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
             "cls_token": "[CLS]", "mask_token": "[MASK]"},
    "roberta": {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>",
                "mask_token": {"content": "<mask>", "lstrip": True}},
}
SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                "mask_token")
LOOKED_FOR = ("tokenizer.json", "vocab.txt", "vocab.json + merges.txt")

# Where Python's unicodedata (Unicode 15.0) and the tables compiled into
# ``tokenizers`` 0.22 (older for the categories of BertNormalizer and
# BertPreTokenizer, Unicode 16.0 for the byte-level split and the lowercase
# mapping) disagree, found by comparing every code point: hexadecimal code
# points and ranges.
NOT_CONTROL = """890-891 8E2 110CD 13430-1343F"""
NOT_DECOMPOSED = """11938"""  # a starter that NFD keeps whole there
NOT_NONSPACING_MARK = """
    7FD 898-89F 8CA-8E1 9FE AFA-AFF B55 C04 C3C D00 D3B-D3C D81 EBA ECE 180F
    1885-1886 1ABF-1ACE 1DF6-1DFB A82C A8C5 A8FF A9BD 10D24-10D27 10EAB-10EAC
    10EFD-10EFF 10F46-10F50 10F82-10F85 11070 11073-11074 110C2 111C9 111CF 1123E
    11241 1133B 11438-1143F 11442-11444 11446 1145E 1182F-11837 11839-1183A
    1193B-1193C 1193E 11943 119D4-119D7 119DA-119DB 119E0 11A01-11A0A 11A33-11A38
    11A3B-11A3E 11A47 11A51-11A56 11A59-11A5B 11A8A-11A96 11A98-11A99 11C30-11C36
    11C38-11C3D 11C3F 11C92-11CA7 11CAA-11CB0 11CB2-11CB3 11CB5-11CB6 11D31-11D36
    11D3A 11D3C-11D3D 11D3F-11D45 11D47 11D90-11D91 11D95 11D97 11EF3-11EF4
    11F00-11F01 11F36-11F3A 11F40 11F42 13440 13447-13455 16F4F 16FE4 1CF00-1CF2D
    1CF30-1CF46 1E000-1E006 1E008-1E018 1E01B-1E021 1E023-1E024 1E026-1E02A 1E08F
    1E130-1E136 1E2AE 1E2EC-1E2EF 1E4EC-1E4EF 1E944-1E94A
"""
EXTRA_NONSPACING_MARK = """1734"""
NOT_PUNCTUATION = """
    61D 9FD A76 C77 C84 1B7D-1B7E 2E43-2E4F 2E52-2E5D 10EAD 10F55-10F59 10F86-10F89
    1144B-1144F 1145A-1145B 1145D 11660-1166C 116B9 1183B 11944-11946 119E2
    11A3F-11A46 11A9A-11A9C 11A9E-11AA2 11B00-11B09 11C41-11C45 11C70-11C71
    11EF7-11EF8 11F43-11F4F 11FFF 12FF1-12FF2 16E97-16E9A 16FE2 1E95E-1E95F
"""
EXTRA_PUNCTUATION = """166D 111C9"""
EXTRA_LETTER = """
    1C89-1C8A A7CB-A7CD A7DA-A7DC 105C0-105F3 10D4A-10D65 10D6F-10D85 10EC2-10EC4
    11380-11389 1138B 1138E 11390-113B5 113B7 113D1 113D3 11BC0-11BE0 13460-143FA
    16100-1611D 16D40-16D6C 18CFF 1E5D0-1E5ED 1E5F0 2EBF0-2EE5D
"""
EXTRA_NUMBER = """
    10D40-10D49 116D0-116E3 11BF0-11BF9 16130-16139 16D70-16D79 1CCF0-1CCF9
    1E5F1-1E5FA
"""
# lowercase mappings of Unicode 16.0 that Unicode 15.0 lacks: range, lowercase of its first
EXTRA_LOWERCASE = """1C89:1C8A A7CB:264 A7CC:A7CD A7CE:A7CF A7D2:A7D3 A7D4:A7D5 A7DA:A7DB
    A7DC:19B 10D50-10D65:10D70 16EA0-16EB8:16EBB"""


def _code_points(spec: str) -> frozenset:
    out = set()
    for item in spec.split():
        lo, _, hi = item.partition("-")
        out.update(map(chr, range(int(lo, 16), int(hi or lo, 16) + 1)))
    return frozenset(out)


def _lowercase_table(spec: str) -> Dict[str, str]:
    out = {}
    for item in spec.split():
        span, _, first = item.partition(":")
        lo, _, hi = span.partition("-")
        for o in range(int(lo, 16), int(hi or lo, 16) + 1):
            out[chr(o)] = chr(int(first, 16) + o - int(lo, 16))
    return out


NOT_CONTROL, NOT_DECOMPOSED, NOT_NONSPACING_MARK, EXTRA_NONSPACING_MARK, NOT_PUNCTUATION, \
    EXTRA_PUNCTUATION, EXTRA_LETTER, EXTRA_NUMBER = map(_code_points, (
        NOT_CONTROL, NOT_DECOMPOSED, NOT_NONSPACING_MARK, EXTRA_NONSPACING_MARK,
        NOT_PUNCTUATION, EXTRA_PUNCTUATION, EXTRA_LETTER, EXTRA_NUMBER))
EXTRA_LOWERCASE = _lowercase_table(EXTRA_LOWERCASE)


def _is_control(c: str) -> bool:
    return (unicodedata.category(c) in ("Cc", "Cf", "Co") and c not in "\t\n\r"
            and c not in NOT_CONTROL)


def _is_punctuation(c: str) -> bool:
    o = ord(c)
    return (33 <= o <= 47 or 58 <= o <= 64 or 91 <= o <= 96 or 123 <= o <= 126
            or (unicodedata.category(c)[0] == "P" and c not in NOT_PUNCTUATION)
            or c in EXTRA_PUNCTUATION)


def _is_nonspacing_mark(c: str) -> bool:
    return ((unicodedata.category(c) == "Mn" and c not in NOT_NONSPACING_MARK)
            or c in EXTRA_NONSPACING_MARK)


def _nfd(s: str) -> str:
    if NOT_DECOMPOSED.isdisjoint(s):
        return unicodedata.normalize("NFD", s)
    out, start = [], 0
    for i, c in enumerate(s):
        if c in NOT_DECOMPOSED:
            out += [unicodedata.normalize("NFD", s[start:i]), c]
            start = i + 1
    return "".join(out) + unicodedata.normalize("NFD", s[start:])


def _lower(c: str) -> str:
    return EXTRA_LOWERCASE.get(c) or c.lower()


def _is_cjk(c: str) -> bool:
    o = ord(c)
    return any(lo <= o <= hi for lo, hi in CJK_RANGES)


def _is_word_char(c: str) -> bool:
    return c.isalnum() or c == "_"


# ------------------------------------------------------------ normalizers

class BertNormalizer:
    def __init__(self, clean_text=True, handle_chinese_chars=True, strip_accents=None,
                 lowercase=True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.lowercase = lowercase

    def __call__(self, s: str) -> str:
        if self.clean_text:
            s = "".join(" " if c in WHITESPACE else c for c in s
                        if c not in "\x00\ufffd" and not _is_control(c))
        if self.handle_chinese_chars:
            s = "".join(f" {c} " if _is_cjk(c) else c for c in s)
        if self.strip_accents:
            s = "".join(c for c in _nfd(s) if not _is_nonspacing_mark(c))
        if self.lowercase:  # char by char, as Rust's char::to_lowercase (no final sigma)
            s = "".join(map(_lower, s))
        return s


class NormalizerSequence:
    def __init__(self, normalizers):
        self.normalizers = normalizers

    def __call__(self, s: str) -> str:
        for n in self.normalizers:
            s = n(s)
        return s


def _normalizer(spec: Optional[dict]):
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "BertNormalizer":
        return BertNormalizer(spec.get("clean_text", True), spec.get("handle_chinese_chars", True),
                              spec.get("strip_accents"), spec.get("lowercase", True))
    if kind == "Sequence":
        return NormalizerSequence([_normalizer(n) for n in spec["normalizers"]])
    raise ValueError(f"unsupported normalizer {kind!r}: the port reads BertNormalizer, "
                     "Sequence or none")


# ------------------------------------------------------------ pre-tokenizers

def bert_pre_tokenize(s: str) -> List[str]:
    """Whitespace removed, each punctuation character a word of its own."""
    words, cur = [], []
    for c in s:
        if c in WHITESPACE or _is_punctuation(c):
            if cur:
                words.append("".join(cur))
                cur = []
            if c not in WHITESPACE:
                words.append(c)
        else:
            cur.append(c)
    if cur:
        words.append("".join(cur))
    return words


def _byte_char_table() -> Dict[int, str]:
    """GPT-2's map of the 256 bytes to printable characters."""
    keep = [*range(ord("!"), ord("~") + 1), *range(ord("¡"), ord("¬") + 1),
            *range(ord("®"), ord("ÿ") + 1)]
    table, extra = {}, 0
    for b in range(256):
        if b in keep:
            table[b] = chr(b)
        else:
            table[b] = chr(256 + extra)
            extra += 1
    return table


BYTE_CHARS = _byte_char_table()


def _char_class(c: str) -> str:
    """``s`` (whitespace), ``L``, ``N`` or ``o`` (anything else)."""
    if c in WHITESPACE:
        return "s"
    if c in EXTRA_LETTER:
        return "L"
    if c in EXTRA_NUMBER:
        return "N"
    cat = unicodedata.category(c)[0]
    return cat if cat in "LN" else "o"


def byte_level_split(s: str) -> List[str]:
    """GPT-2's split ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``, written out: at each position
    the first alternative that matches, each as long as it goes."""
    classes = [_char_class(c) for c in s]
    n, i, out = len(s), 0, []
    while i < n:
        c = s[i]
        if c == "'" and s[i + 1:i + 3] in ("re", "ve", "ll"):
            j = i + 3
        elif c == "'" and i + 1 < n and s[i + 1] in "stmd":
            j = i + 2
        else:
            k = i + 1 if c == " " else i
            if k < n and classes[k] != "s":
                j = k + 1
                while j < n and classes[j] == classes[k]:
                    j += 1
            else:  # a whitespace run: all of it at the end, else all but its last
                j = i + 1
                while j < n and classes[j] == "s":
                    j += 1
                if j < n and j - i > 1:
                    j -= 1
        out.append(s[i:j])
        i = j
    return out


class ByteLevel:
    def __init__(self, add_prefix_space=True, use_regex=True):
        self.add_prefix_space = add_prefix_space
        self.use_regex = use_regex

    def __call__(self, s: str) -> List[str]:
        if self.add_prefix_space and not s.startswith(" "):
            s = " " + s
        words = byte_level_split(s) if self.use_regex else [s]
        return ["".join(BYTE_CHARS[b] for b in w.encode("utf-8")) for w in words]


def _pre_tokenizer(spec: Optional[dict]):
    kind = (spec or {}).get("type")
    if kind == "BertPreTokenizer":
        return bert_pre_tokenize
    if kind == "ByteLevel":
        return ByteLevel(spec.get("add_prefix_space", True), spec.get("use_regex", True))
    raise ValueError(f"unsupported pre-tokenizer {kind!r}: the port reads BertPreTokenizer "
                     "or ByteLevel")


# ------------------------------------------------------------ models

class WordPiece:
    def __init__(self, vocab: Dict[str, int], unk_token="[UNK]", continuing_subword_prefix="##",
                 max_input_chars_per_word=100):
        self.vocab = vocab
        self.unk_id = vocab[unk_token]
        self.prefix = continuing_subword_prefix
        self.max_chars = max_input_chars_per_word
        self._cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = self._tokenize(word)
        return ids

    def _tokenize(self, word: str) -> List[int]:
        """Greedy longest match from the left, pieces after the first with
        the prefix; the whole word ``[UNK]`` if a piece is not found or the
        word is too long."""
        if len(word) > self.max_chars:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else self.prefix + word[start:end]
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            else:
                return [self.unk_id]
            start = end
        return ids


class BPE:
    """Byte-level BPE: each character of a word a symbol (``unk_token``'s
    id where the vocabulary lacks it, dropped without one), then the merges
    by rank."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]],
                 unk_token=None):
        self.vocab = vocab
        self.unk_id = vocab.get(unk_token) if unk_token is not None else None
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(merges):
            self.merges[(vocab[a], vocab[b])] = (rank, vocab[a + b])  # the last one holds
        self._cache: Dict[str, List[int]] = {}

    def __call__(self, word: str) -> List[int]:
        if not word:
            return []
        ids = self._cache.get(word)
        if ids is None:
            ids = self._cache[word] = self._tokenize(word)
        return ids

    def _tokenize(self, word: str) -> List[int]:
        symbols = [self.vocab.get(c, self.unk_id) for c in word]
        return self._merge([i for i in symbols if i is not None])

    def _merge(self, symbols: List[int]) -> List[int]:
        """tokenizers' ``Word::merge_all``: the pair of lowest rank first
        (leftmost among equals), over a linked list of symbols."""
        n = len(symbols)
        nxt = list(range(1, n + 1))
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = [(self.merges[p][0], i, self.merges[p][1])
                for i, p in enumerate(zip(symbols, symbols[1:])) if p in self.merges]
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            if self.merges.get((symbols[pos], symbols[right]), (None, None))[1] != new:
                continue  # an entry that expired
            symbols[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            for a, b in ((prev[pos], pos), (pos, nxt[pos])):
                if a >= 0 and b < n:
                    m = self.merges.get((symbols[a], symbols[b]))
                    if m is not None:
                        heapq.heappush(heap, (m[0], a, m[1]))
        return [s for s, keep in zip(symbols, alive) if keep]


def _bpe_merges(raw) -> List[Tuple[str, str]]:
    """``["a b", ...]`` (older files) or ``[["a", "b"], ...]``."""
    return [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m) for m in raw]


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "WordPiece":
        return WordPiece(spec["vocab"], spec.get("unk_token", "[UNK]"),
                         spec.get("continuing_subword_prefix", "##"),
                         spec.get("max_input_chars_per_word", 100))
    if kind == "BPE":
        for option in ("dropout", "continuing_subword_prefix", "end_of_word_suffix",
                       "fuse_unk", "byte_fallback", "ignore_merges"):
            if spec.get(option):  # RoBERTa's BPE sets none of them
                raise ValueError(f"unsupported BPE option {option}={spec[option]!r}")
        return BPE(spec["vocab"], _bpe_merges(spec["merges"]), spec.get("unk_token"))
    raise ValueError(f"unsupported tokenizer model {kind!r}: the port reads WordPiece or BPE")


# ------------------------------------------------------------ post-processors

def _special_ids(spec: Optional[dict]) -> Tuple[List[int], List[int]]:
    """The ids a post-processor puts before and after a single sequence."""
    kind = (spec or {}).get("type")
    if kind in ("BertProcessing", "RobertaProcessing"):
        return [spec["cls"][1]], [spec["sep"][1]]
    if kind == "TemplateProcessing":
        before, after, seen = [], [], False
        for piece in spec["single"]:
            if "Sequence" in piece:
                seen = True
            else:
                ids = spec["special_tokens"][piece["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(ids)
        return before, after
    raise ValueError(f"unsupported post-processor {kind!r}: the port reads BertProcessing, "
                     "RobertaProcessing or TemplateProcessing")


# ------------------------------------------------------------ the tokenizer

class AddedToken(NamedTuple):
    content: str
    id: int
    lstrip: bool = False
    rstrip: bool = False
    single_word: bool = False
    normalized: bool = False


def _split_added(s: str, tokens: Dict[str, AddedToken]) -> List[Tuple[str, Optional[int]]]:
    """``s`` cut at the added tokens (the leftmost, then longest match),
    ``(text, None)`` between them and ``("", id)`` for each; whitespace that
    an ``lstrip`` / ``rstrip`` token takes goes with it."""
    if not tokens or not s:
        return [(s, None)] if s else []
    longest = max(map(len, tokens))
    starts = {t[0] for t in tokens}
    out, start, i = [], 0, 0
    while i < len(s):
        tok = None
        if s[i] in starts:
            for k in range(min(longest, len(s) - i), 0, -1):
                tok = tokens.get(s[i:i + k])
                if tok is not None:
                    break
        if tok is None:
            i += 1
            continue
        a, b = i, i + k
        if tok.single_word and ((a > 0 and _is_word_char(s[a - 1]))
                                or (b < len(s) and _is_word_char(s[b]))):
            i = b  # the search goes on after the match it turned down
            continue
        if tok.lstrip:
            while a > start and s[a - 1] in WHITESPACE:
                a -= 1
        if tok.rstrip:
            while b < len(s) and s[b] in WHITESPACE:
                b += 1
        if start < a:
            out.append((s[start:a], None))
        out.append(("", tok.id))
        start = i = b
    if start < len(s):
        out.append((s[start:], None))
    return out


class PLMTokenizer:
    """A tokenizer made of a normalizer, a pre-tokenizer, a model (WordPiece
    or BPE), added tokens and the special ids of a single sequence."""

    def __init__(self, model, normalizer, pre_tokenizer, added: Iterable[AddedToken],
                 special_ids: Tuple[List[int], List[int]]):
        self.model = model
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        added = list(added)
        # normalized tokens are matched in normalized text, by their normalized content
        self.raw_added = {t.content: t for t in added if not t.normalized}
        self.normalized_added = {(normalizer(t.content) if normalizer else t.content): t
                                 for t in added if t.normalized}
        self.before, self.after = special_ids

    @property
    def num_special_tokens(self) -> int:
        return len(self.before) + len(self.after)

    def tokenize(self, text: str) -> List[int]:
        """The ids of ``text`` without the specials of the post-processor."""
        ids: List[int] = []
        for raw, tok in _split_added(text, self.raw_added):
            if tok is not None:
                ids.append(tok)
                continue
            norm = self.normalizer(raw) if self.normalizer else raw
            for piece, tok2 in _split_added(norm, self.normalized_added):
                if tok2 is not None:
                    ids.append(tok2)
                    continue
                for word in self.pre_tokenizer(piece):
                    ids.extend(self.model(word))
        return ids

    def encode(self, text, max_len: Optional[int] = None) -> List[int]:
        """``text`` (``""`` if it is not a string) to ids, the specials
        included; with ``max_len``, the text keeps ``max_len`` minus the
        specials' count of its ids (all of them where ``max_len`` leaves no
        room for the specials: ``tokenizers`` then does not truncate)."""
        ids = self.tokenize(text if isinstance(text, str) else "")
        if max_len is not None and max_len >= self.num_special_tokens:
            ids = ids[:max_len - self.num_special_tokens]
        return self.before + ids + self.after

    def encode_batch(self, texts, max_len: Optional[int] = None) -> List[List[int]]:
        return [self.encode(t, max_len) for t in texts]

    def max_id(self) -> int:
        return max(max(self.model.vocab.values()),
                   *(t.id for t in self.raw_added.values()),
                   *(t.id for t in self.normalized_added.values()), -1)


def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _tokenizer_class(directory: str, config: dict) -> str:
    """``tokenizer_config.json``'s ``tokenizer_class``, else the class of
    ``config.json``'s ``model_type``, as ``AutoTokenizer`` picks it."""
    cls = config.get("tokenizer_class")
    if cls:
        return cls
    model_type = _read_json(os.path.join(directory, "config.json")).get("model_type")
    return {"bert": "BertTokenizerFast", "roberta": "RobertaTokenizerFast"}.get(
        model_type, "PreTrainedTokenizerFast")


def _token_spec(value) -> dict:
    return {"content": value} if isinstance(value, str) else dict(value)


def _legacy_spec(directory: str, config: dict) -> Tuple[dict, str]:
    """The ``tokenizer.json`` that ``transformers`` converts the legacy
    files to, and the family whose class defaults apply."""
    vocab_txt = os.path.join(directory, "vocab.txt")
    if os.path.exists(vocab_txt):
        vocab: Dict[str, int] = {}
        with open(vocab_txt, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        lower = config.get("do_lower_case", True)
        tokens = {k: _token_spec(config.get(k, v))["content"]
                  for k, v in CLASS_SPECIALS["bert"].items()}
        spec = {
            "model": {"type": "WordPiece", "vocab": vocab, "unk_token": tokens["unk_token"]},
            "normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": config.get("tokenize_chinese_chars", True),
                           "strip_accents": config.get("strip_accents"), "lowercase": lower},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {"type": "BertProcessing",
                               "cls": [tokens["cls_token"], vocab.get(tokens["cls_token"])],
                               "sep": [tokens["sep_token"], vocab.get(tokens["sep_token"])]},
        }
        return spec, "bert"
    vocab_json, merges_txt = (os.path.join(directory, f) for f in ("vocab.json", "merges.txt"))
    if os.path.exists(vocab_json) and os.path.exists(merges_txt):
        vocab = _read_json(vocab_json)
        with open(merges_txt, encoding="utf-8") as f:
            # the slow RoBERTa tokenizer drops the first line (the version) and the last
            # (duplicates once, at their first place)
            merges = list(dict.fromkeys(tuple(m.split()) for m in f.read().split("\n")[1:-1]))
        tokens = {k: _token_spec(config.get(k, v))["content"]
                  for k, v in CLASS_SPECIALS["roberta"].items()}
        spec = {
            "model": {"type": "BPE", "vocab": vocab, "merges": merges},
            "normalizer": None,
            "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
            "post_processor": {"type": "RobertaProcessing",
                               "cls": [tokens["cls_token"], vocab.get(tokens["cls_token"])],
                               "sep": [tokens["sep_token"], vocab.get(tokens["sep_token"])]},
        }
        return spec, "roberta"
    raise FileNotFoundError(f"{directory} holds none of {', '.join(LOOKED_FOR)}")


def load_tokenizer(path: str) -> PLMTokenizer:
    """The tokenizer of the local directory ``path`` (module doc).  Raises
    ``FileNotFoundError`` when ``path`` is not a local directory or holds
    no tokenizer files: nothing is fetched."""
    if not path or not os.path.isdir(path):
        raise FileNotFoundError(
            f"the PLM tokenizer {path!r} is not a local directory: the port reads "
            f"{', '.join(LOOKED_FOR)} from a local directory and fetches nothing; point "
            "data.plm_tokenizer at a directory that holds them")
    config = _read_json(os.path.join(path, "tokenizer_config.json"))
    cls = _tokenizer_class(path, config)
    family = "roberta" if cls.startswith("Roberta") else (
        "bert" if cls in BERT_CLASSES else None)
    tok_json = os.path.join(path, "tokenizer.json")
    if os.path.exists(tok_json):
        spec = _read_json(tok_json)
        added = [dict(t) for t in spec.get("added_tokens", [])]
    else:
        spec, family = _legacy_spec(path, config)
        added = []
    vocab = spec["model"]["vocab"]
    # the tokens of tokenizer_config.json and the class that are not added yet
    contents = {t["content"] for t in added}
    decoder = config.get("added_tokens_decoder", {})
    for idx, t in sorted(decoder.items(), key=lambda kv: int(kv[0])):
        if t["content"] not in contents:
            added.append({**t, "id": vocab.get(t["content"], int(idx))})
            contents.add(t["content"])
    defaults = CLASS_SPECIALS.get(family, {})
    for key in SPECIAL_KEYS:
        value = config.get(key, defaults.get(key))
        if value is None:
            continue
        t = {"normalized": False, **_token_spec(value)}
        if t["content"] not in contents:
            next_id = max([len(vocab)] + [a["id"] + 1 for a in added])
            added.append({**t, "id": vocab.get(t["content"], next_id)})
            contents.add(t["content"])

    normalizer_spec = spec.get("normalizer")
    if family == "bert" and normalizer_spec and normalizer_spec.get("type") == "BertNormalizer":
        normalizer_spec = dict(normalizer_spec,
                               lowercase=config.get("do_lower_case", True),
                               strip_accents=config.get("strip_accents"),
                               handle_chinese_chars=config.get("tokenize_chinese_chars", True))
    pre_spec = spec.get("pre_tokenizer")
    if pre_spec and pre_spec.get("type") == "ByteLevel":
        pre_spec = dict(pre_spec, add_prefix_space=config.get("add_prefix_space", False))
    normalizer = _normalizer(normalizer_spec)
    return PLMTokenizer(
        _model(spec["model"]), normalizer, _pre_tokenizer(pre_spec),
        [AddedToken(t["content"], t["id"], t.get("lstrip", False), t.get("rstrip", False),
                    t.get("single_word", False), t.get("normalized", False)) for t in added],
        _special_ids(spec.get("post_processor")))
