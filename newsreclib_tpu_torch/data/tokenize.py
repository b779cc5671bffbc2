"""Word tokenization and vocabulary construction (a copy of
``newsreclib_tpu/data/tokenize.py``): the regex word tokenizer of the
reference's ``data_utils.py:20-34`` and the word2index construction of its
``mind_dataframe.py:309-333`` (insertion-ordered counter, indices from 1,
0 reserved for padding / unknown).
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, Iterable, List

_TOKEN_PAT = re.compile(r"[\w]+|[.,!?;|]")


def word_tokenize(sentence) -> List[str]:
    """Lowercase regex word tokenizer (same pattern as the reference)."""
    if isinstance(sentence, str):
        return _TOKEN_PAT.findall(sentence.lower())
    return []


def build_vocab(token_lists: Iterable[List[str]]) -> Dict[str, int]:
    """word → index (1-based, insertion order of first occurrence), matching
    ``mind_dataframe.py:318-323``."""
    cnt = Counter()
    for tokens in token_lists:
        cnt.update(tokens)
    return {w: i + 1 for i, w in enumerate(cnt)}


def build_index_map(values: Iterable[str]) -> Dict[str, int]:
    """value → index (1-based, order of first occurrence) for categories /
    subcategories / sentiments (``mind_dataframe.py:357-397``)."""
    out: Dict[str, int] = {}
    for v in values:
        if v not in out:
            out[v] = len(out) + 1
    return out


def tokens_to_ids(tokens: List[str], vocab: Dict[str, int]) -> List[int]:
    return [vocab.get(t, 0) for t in tokens]
