"""Sentiment annotators: text -> (class label, signed score) (counterpart of
``newsreclib_tpu/data/sentiment.py``).

Classes are the strings ``positive`` / ``neutral`` / ``negative``; scores
are signed floats in [-1, 1].  ``lexicon`` is the small built-in annotator
that runs offline (the one the statfix and demo configs name); ``vader``
imports nltk when built and raises where it is missing, as the JAX
package's does; ``bert`` runs a local BERT / RoBERTa sequence-classification
checkpoint through the port's tokenizer reader and tower, on the card
unless given ``device="cpu"``, without ``transformers``.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Tuple

from newsreclib_tpu_torch.data.tokenize import word_tokenize

SentimentResult = Tuple[str, float]


def _classify(score: float, pos_thr: float = 0.05, neg_thr: float = -0.05) -> str:
    if score >= pos_thr:
        return "positive"
    if score <= neg_thr:
        return "negative"
    return "neutral"


class SentimentAnnotator:
    def __call__(self, text: str) -> SentimentResult:
        return self.annotate_many([text])[0]

    def annotate_many(self, texts: Iterable[str]) -> List[SentimentResult]:
        raise NotImplementedError


class VADERSentimentAnnotator(SentimentAnnotator):
    """VADER compound score -> class by the +-0.05 thresholds; needs nltk
    and its vader lexicon."""

    def __init__(self):
        try:
            from nltk.sentiment.vader import SentimentIntensityAnalyzer

            self._analyzer = SentimentIntensityAnalyzer()
        except LookupError as e:  # lexicon not downloaded
            raise RuntimeError(
                "VADER lexicon unavailable (offline?); use "
                "LexiconSentimentAnnotator or BERTSentimentAnnotator"
            ) from e

    def annotate_many(self, texts):
        out = []
        for t in texts:
            score = self._analyzer.polarity_scores(t if isinstance(t, str) else "")["compound"]
            out.append((_classify(score), float(score)))
        return out


class BERTSentimentAnnotator(SentimentAnnotator):
    """A sequence classifier read from the local checkpoint directory
    ``model_name`` (``config.json``, the weights, and tokenizer files that
    ``data/plm_tokenizer.py`` reads), as the JAX package's
    ``transformers`` pipeline runs it: texts tokenised with the specials
    and truncated at the tokenizer's ``model_max_length``, in batches of
    ``batch_size`` padded to their longest, the tower and its head
    (``models/components/plm.py::SequenceClassifier``), softmax over
    several labels (sigmoid for one, none for regression), the top label
    of ``config.json``'s ``id2label``.  A label holding "neg" gives
    ``("negative", -p)``, "pos" ``("positive", p)``, any other
    ``("neutral", p)``.  Nothing is fetched: a ``model_name`` that is not a
    local directory raises ``FileNotFoundError``."""

    def __init__(self, model_name: str = "cardiffnlp/twitter-roberta-base-sentiment-latest",
                 batch_size: int = 64, device="cuda"):
        from newsreclib_tpu_torch.data.plm_tokenizer import load_tokenizer
        from newsreclib_tpu_torch.device import resolve_device
        from newsreclib_tpu_torch.models.components.plm import load_hf_classifier

        if not os.path.isdir(model_name):
            raise FileNotFoundError(
                f"the sentiment classifier {model_name!r} is not a local directory: the port "
                "reads a BERT / RoBERTa sequence-classification checkpoint and its tokenizer "
                "from a local directory and fetches nothing")
        self._device = resolve_device(device)
        self._tokenizer = load_tokenizer(model_name)
        tok_config = os.path.join(model_name, "tokenizer_config.json")
        self._max_len = None  # transformers: no model_max_length, no truncation
        if os.path.exists(tok_config):
            with open(tok_config, encoding="utf-8") as f:
                self._max_len = json.load(f).get("model_max_length")
        model, config = load_hf_classifier(model_name)
        self._model = model.to(self._device)
        self._pad = int(config.get("pad_token_id") or 0)
        n = len(config.get("id2label") or {}) or config.get("num_labels", 2)
        self._labels = [(config.get("id2label") or {}).get(str(i), f"LABEL_{i}")
                        for i in range(n)]
        problem = config.get("problem_type")
        self._fn = ("none" if problem == "regression" else
                    "sigmoid" if problem == "multi_label_classification" or n == 1 else
                    "softmax")
        self._batch_size = batch_size

    def _probabilities(self, texts: List[str]):
        import torch

        ids = self._tokenizer.encode_batch(texts, self._max_len)
        width = max(len(i) for i in ids)
        tokens = torch.full((len(ids), width), self._pad, dtype=torch.long)
        mask = torch.zeros((len(ids), width), dtype=torch.bool)
        for r, row in enumerate(ids):
            tokens[r, :len(row)] = torch.tensor(row, dtype=torch.long)
            mask[r, :len(row)] = True
        with torch.inference_mode():
            logits = self._model(tokens.to(self._device), mask.to(self._device)).float()
        if self._fn == "softmax":
            return torch.softmax(logits, dim=-1).cpu()
        return (torch.sigmoid(logits) if self._fn == "sigmoid" else logits).cpu()

    def annotate_many(self, texts):
        texts = [t if isinstance(t, str) else "" for t in texts]
        out = []
        for start in range(0, len(texts), self._batch_size):
            probs = self._probabilities(texts[start:start + self._batch_size])
            for row in probs:
                top = int(row.argmax())
                label, score = self._labels[top].lower(), float(row[top])
                if "neg" in label:
                    out.append(("negative", -score))
                elif "pos" in label:
                    out.append(("positive", score))
                else:
                    out.append(("neutral", score))
        return out


_POS_WORDS = frozenset(
    "good great best love win wins winning success successful happy joy amazing "
    "beautiful excellent positive hope celebrates celebrate triumph record boost "
    "top star gain gains strong".split()
)
_NEG_WORDS = frozenset(
    "bad worst hate lose loses losing loss fail fails failure sad death dead dies "
    "die killed kill crisis war attack fear negative drop drops weak crash fraud "
    "scandal threat injury injured".split()
)


class LexiconSentimentAnnotator(SentimentAnnotator):
    """Built-in lexicon annotator: deterministic and offline (not a VADER
    replacement)."""

    def annotate_many(self, texts):
        out = []
        for t in texts:
            tokens = word_tokenize(t)
            pos = sum(tok in _POS_WORDS for tok in tokens)
            neg = sum(tok in _NEG_WORDS for tok in tokens)
            score = (pos - neg) / max(len(tokens), 1)
            score = max(-1.0, min(1.0, 3.0 * score))
            out.append((_classify(score, 0.01, -0.01), float(score)))
        return out


def get_annotator(name: str, **kwargs) -> SentimentAnnotator:
    if name == "vader":
        return VADERSentimentAnnotator()
    if name == "bert":
        return BERTSentimentAnnotator(**kwargs)
    if name == "lexicon":
        return LexiconSentimentAnnotator()
    raise ValueError(f"unknown sentiment annotator: {name}")
