"""SentiDebias: adversarial removal of sentiment bias (counterpart of
``newsreclib_tpu/models/fair_rec/senti_debias.py``).

A generator (news and sentiment towers, one user encoder shared by a
bias-free and a bias-aware view, two dot-product heads, orthogonality
regularisers) is trained against a discriminator (a two-layer tanh MLP that
predicts the sentiment class from news vectors) by alternating two Adam
optimizers: G minimises ``rec + beta x orth - alpha x adv``, then D minimises
the sentiment cross-entropy on the updated G's news vectors.  Evaluation
uses the bias-free scores, which ``encode_news`` / ``score_with_vectors``
also give, so the generator is served through ``CachedScorer`` (the JAX
package evaluates it through its eval step; the scores are the same).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import nn

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.models.base import (
    encode_all_news,
    gather_news,
    late_fusion_user,
    news_field,
    news_valid,
)
from newsreclib_tpu_torch.models.components.category import SentimentEncoder
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.linear import Dense
from newsreclib_tpu_torch.models.components.losses import cross_entropy_loss
from newsreclib_tpu_torch.models.components.plm import share
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.user import NRMSUserEncoder
from newsreclib_tpu_torch.training.state import TrainState, create_train_state, make_optimizer
from newsreclib_tpu_torch.training.steps import (
    apply_in_dtype,
    as_dtype,
    data_mean,
    global_loss,
    reduce_gradients,
    rows_of,
)


def _abs_cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|cos(a, b)| over the last axis with max-guarded norms: a zero vector
    (a padding article) gives 0, and a finite gradient, not NaN.  The
    absolute value is JAX's, whose derivative at 0 is 1 (torch's ``abs``
    gives 0), so the gradient at a zero row is the JAX package's too."""
    na = (a * a).sum(-1).clamp_min(1e-16).sqrt()
    nb = (b * b).sum(-1).clamp_min(1e-16).sqrt()
    cos = (a * b).sum(-1) / (na * nb)
    return torch.where(cos >= 0, cos, -cos)


class SentiDebiasGenerator(nn.Module):
    """News and sentiment towers; ``forward`` gives the bias-free scores (the
    eval protocol), ``full_output`` everything the adversarial step needs.
    Weights are drawn on the CPU from ``generator`` and moved to ``device``."""

    def __init__(
        self,
        vocab_size: int,
        num_sent_classes: int = 3,
        embed_dim: int = 300,
        num_heads: int = 15,
        query_dim: int = 200,
        sent_embed_dim: int = 64,
        dropout: float = 0.2,
        late_fusion: bool = False,
        pretrained_embeddings: Optional[np.ndarray] = None,
        text_encoder_module: Optional[nn.Module] = None,
        text_encoder_dim: Optional[int] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.late_fusion = late_fusion
        if text_encoder_module is not None:  # a PLM tower of width text_encoder_dim
            self.text_encoder_module = text_encoder_module
            share(self, "news_encoder", text_encoder_module)
            embed_dim = text_encoder_dim
        else:
            self.news_encoder = MHSAAddAtt(vocab_size, embed_dim, num_heads, query_dim, dropout,
                                           pretrained_embeddings, generator)
        # the sentiment tower emits the news tower's width: the bias-aware
        # head dots the user vector of sentiment vectors with them
        self.sentiment_encoder = SentimentEncoder(num_sent_classes, sent_embed_dim, embed_dim,
                                                  generator)
        self.user_encoder = (None if late_fusion
                             else NRMSUserEncoder(embed_dim, num_heads, query_dim, generator))
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.news_encoder(news.title, news.title_mask, deterministic, generator)

    def _user(self, hist: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.late_fusion:
            return late_fusion_user(hist, mask)
        return self.user_encoder(hist, mask)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor) -> torch.Tensor:
        """The bias-free scores from unique-news vectors."""
        user = self._user(gather_news(news_vecs, batch.hist_idx), batch.hist_mask)
        return dot_product_scores(user, gather_news(news_vecs, batch.cand_idx))

    def full_output(self, batch: RecBatch, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        sent_vecs = self.sentiment_encoder(news_field(batch, "sentiment"))
        hist = gather_news(news_vecs, batch.hist_idx)
        cand = gather_news(news_vecs, batch.cand_idx)
        user_free = self._user(hist, batch.hist_mask)
        user_aware = self._user(gather_news(sent_vecs, batch.hist_idx), batch.hist_mask)

        # orthogonality regularisers over the unique news and the users
        valid = news_valid(batch)
        orth_news = (torch.where(valid, _abs_cos(news_vecs, sent_vecs).float(), 0.0).sum()
                     / valid.sum().clamp_min(1))
        orth_user = _abs_cos(user_free, user_aware).float().mean()
        bias_free = dot_product_scores(user_free, cand)
        bias_aware = dot_product_scores(user_aware, gather_news(sent_vecs, batch.cand_idx))
        return {
            "combined_scores": bias_free + bias_aware,
            "bias_free_scores": bias_free,
            "loss_orth": 2.0 * orth_news + orth_user,  # hist + cand news terms -> unique news
            "news_vecs": news_vecs,
            "news_valid": valid,
            "news_sentiments": news_field(batch, "sentiment"),
        }

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None, full: bool = False):
        """``(bias-free scores, {})``; with ``full``, ``full_output``'s dict."""
        out = self.full_output(batch, deterministic, generator)
        return out if full else (out["bias_free_scores"], {})


class SentiDebiasDiscriminator(nn.Module):
    """Two-layer tanh MLP sentiment classifier over news vectors:
    ``(U, D) -> (U, num_sent_classes + 1)`` logits."""

    def __init__(self, in_dim: int = 300, hidden_dim: int = 128, num_sent_classes: int = 3,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.linear1 = Dense(in_dim, hidden_dim, generator)
        self.linear2 = Dense(hidden_dim, num_sent_classes + 1, generator)
        self.to(device)

    def forward(self, news_vecs: torch.Tensor) -> torch.Tensor:
        return self.linear2(torch.tanh(self.linear1(news_vecs)))


class SentiDebiasState(NamedTuple):
    g: TrainState
    d: TrainState

    @property
    def model(self) -> SentiDebiasGenerator:
        """The generator, the model that is evaluated and served."""
        return self.g.model


def _sent_ce(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean sentiment cross-entropy over the rows where ``valid`` is set."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ce = -logp.gather(-1, labels.long()[:, None])[:, 0]
    valid = valid != 0
    return torch.where(valid, ce, 0.0).sum() / valid.sum().clamp_min(1)


def make_sentidebias_train_step(alpha: float = 0.15, beta: float = 10.0,
                                compute_dtype: Union[str, torch.dtype, None] = None):
    """The alternating G / D step (``newsreclib_tpu/models/fair_rec/
    senti_debias.py:161-207``): ``step(state, batch) -> (state, metrics)``,
    the state updated in place.

    1. G's loss ``rec + beta x orth - alpha x adv`` (CE of the combined scores,
       the orthogonality regulariser, D's sentiment CE on G's news vectors)
       is differentiated with respect to G's parameters only; D's gradients
       are not filled.
    2. G takes its Adam step.
    3. D is trained on the updated G's news vectors, detached.  The JAX step
       reuses G's dropout key there, so the port replays the same masks by
       restoring the generator state it drew them from; only the news tower
       runs again (the JAX second forward's user encoders are dead code), so
       a step launches the attention kernel forward 2 x segments + 2 times
       (G's towers and users, then the news tower) and backward
       segments + 2 times.

    ``compute_dtype`` ("bfloat16"): both networks run on bf16 casts of their
    float32 master parameters, losses in float32 (the JAX step has no
    mixed-precision route; the CLI's SentiDebias config trains in float32).

    On a data-parallel state (``state.g.grid``): G's recommendation loss is
    the global batch's (``training/steps.py::global_loss``), its other terms
    and D's loss (means over the replicated news table, and the users'
    orthogonality over the rank's rows) enter divided by the data size and
    are reported as their mean over the data ranks, and each network sums
    its own gradients over the data group.  On one device these are the
    plain losses and nothing is reduced."""
    cdtype = as_dtype(compute_dtype)

    def step(state: SentiDebiasState, batch: RecBatch):
        grid = state.g.grid
        n = 1 if grid is None else grid.data_size
        gen = state.g.dropout_generator()
        drawn_from = gen.get_state()
        with rows_of(grid):
            out = apply_in_dtype(state.g.model, cdtype, batch, deterministic=False,
                                 generator=gen, full=True)
        adv = _sent_ce(apply_in_dtype(state.d.model, cdtype, out["news_vecs"]),
                       out["news_sentiments"], out["news_valid"])
        rec_obj, rec = global_loss(cross_entropy_loss, out["combined_scores"].float(), batch,
                                   {}, grid)
        orth = out["loss_orth"].float()
        extra = beta * orth - alpha * adv
        (rec_obj + extra / n).backward(
            inputs=[p for p in state.g.model.parameters() if p.requires_grad])
        reduce_gradients(state.g)
        state.g.apply_gradients()

        gen.set_state(drawn_from)
        with torch.no_grad():
            news_vecs = encode_all_news(
                lambda news: apply_in_dtype(state.g.model.news_encoder, cdtype, news.title,
                                            news.title_mask, False, gen), batch)
        d_loss = _sent_ce(apply_in_dtype(state.d.model, cdtype, news_vecs),
                          out["news_sentiments"], out["news_valid"])
        (d_loss / n).backward()
        reduce_gradients(state.d)
        state.d.apply_gradients()
        g_loss = rec + data_mean(extra.detach(), grid)
        metrics = {"loss": g_loss, "g_loss": g_loss, "d_loss": data_mean(d_loss.detach(), grid),
                   "rec_loss": rec, "adv_loss": adv.detach(), "orth_loss": orth.detach()}
        return state, metrics

    return step


def create_sentidebias_state(generator: SentiDebiasGenerator,
                             discriminator: SentiDebiasDiscriminator, seed: int = 0,
                             g_lr: float = 1e-5, d_lr: float = 2e-5) -> SentiDebiasState:
    """Adam for each network (G lr 1e-5, D lr 2e-5 by default), distinct
    dropout seeds (D has no dropout)."""
    return SentiDebiasState(
        create_train_state(generator, make_optimizer(g_lr), dropout_seed=seed),
        create_train_state(discriminator, make_optimizer(d_lr), dropout_seed=seed + 1))
