"""Sentiment annotators: text -> (class label, signed score) (counterpart of
``newsreclib_tpu/data/sentiment.py``).

Classes are the strings ``positive`` / ``neutral`` / ``negative``; scores
are signed floats in [-1, 1].  ``lexicon`` is the small built-in annotator
that runs offline (the one the statfix and demo configs name); ``vader``
and ``bert`` import their packages when built and raise where those are
missing, as the JAX package's do.
"""

from __future__ import annotations

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
    """A transformers sequence-classification pipeline: +prob for positive,
    -prob for negative, prob for neutral; batched."""

    def __init__(self, model_name: str = "cardiffnlp/twitter-roberta-base-sentiment-latest",
                 batch_size: int = 64, device: str = "cpu"):
        from transformers import pipeline

        self._pipe = pipeline(
            "sentiment-analysis", model=model_name, device=device, truncation=True
        )
        self._batch_size = batch_size

    def annotate_many(self, texts):
        texts = [t if isinstance(t, str) else "" for t in texts]
        out = []
        for res in self._pipe(texts, batch_size=self._batch_size):
            label = res["label"].lower()
            score = float(res["score"])
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
