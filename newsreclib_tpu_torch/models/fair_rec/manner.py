"""MANNeR: modular multi-aspect news recommendation (counterpart of
``newsreclib_tpu/models/fair_rec/manner.py``).

* CR-module (``MANNeRCR``): a news encoder over the concatenated title and
  abstract tokens (``MHSAAddAtt``), an optional entity tower
  (``EntityAddAtt`` over title and abstract entities) and a linear combine;
  late fusion by default; trained on slates with SupCon.  Its
  ``encode_news`` / ``score_with_vectors`` split serves it from the cached
  vector table.
* A-module (``MANNeRA``): the same news encoder trained with SupCon on the
  embeddings against an aspect label (``supcon_embedding_loss``,
  ``training/aspect.py``).
* Ensemble (``MANNeREnsemble``, ``evaluate_ensemble``): test-only; each
  module's late-fusion dot-product scores z-normalised per impression and
  summed with the configured weights, served from one vector table whose
  columns are the modules' vectors side by side.

On the card the text attention runs the ``fused_small_mhsa`` kernel at
L = title width + abstract width (66 and 80 on split statfix batches), 15
heads of 20: the kernel's wide instances (L above 64).
``MANNeRCR(remat=True)`` recomputes the news tower in the backward pass
instead of keeping its activations (the JAX model's ``nn.remat``),
replaying the forward's dropout masks (``checkpointed_news_encoder``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.device import resolve_device
from newsreclib_tpu_torch.models.base import encode_all_news, gather_news, late_fusion_user
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.linear import Dense
from newsreclib_tpu_torch.models.components.news import EntityAddAtt
from newsreclib_tpu_torch.models.components.plm import share
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.user import NRMSUserEncoder


def concat_text(news: NewsFeatures) -> Tuple[torch.Tensor, torch.Tensor]:
    """Title and abstract tokens side by side (the title alone without an
    abstract), with their mask."""
    if news.abstract is None:
        return news.title, news.title_mask
    return (torch.cat([news.title, news.abstract], dim=1),
            torch.cat([news.title_mask, news.abstract_mask], dim=1))


def concat_entities(news: NewsFeatures):
    """Title and abstract entities side by side, with their mask; (None,
    None) without title entities."""
    if news.title_entities is None:
        return None, None
    if news.abstract_entities is None:
        return news.title_entities, news.title_entities_mask
    return (torch.cat([news.title_entities, news.abstract_entities], dim=1),
            torch.cat([news.title_entities_mask, news.abstract_entities_mask], dim=1))


class MANNeRNewsEncoder(nn.Module):
    """The CR and A modules' news encoder: ``MHSAAddAtt`` over the
    concatenated text, with ``use_entities`` an ``EntityAddAtt`` tower and
    ``combine_linear`` from both vectors back to ``text_embed_dim`` (news
    without entities get the text vector alone, as in the JAX module).  A
    PLM tower (``text_encoder_module``, of width ``text_encoder_dim``) that
    the module above registers replaces ``MHSAAddAtt``."""

    def __init__(self, vocab_size: int, entity_vocab_size: int = 1, use_entities: bool = True,
                 text_embed_dim: int = 300, entity_embed_dim: int = 100, num_heads: int = 15,
                 query_dim: int = 200, dropout: float = 0.2,
                 pretrained_embeddings: Optional[np.ndarray] = None,
                 pretrained_entity_embeddings: Optional[np.ndarray] = None,
                 generator: Optional[torch.Generator] = None,
                 text_encoder_module: Optional[nn.Module] = None,
                 text_encoder_dim: Optional[int] = None):
        super().__init__()
        text_dim = text_embed_dim
        if text_encoder_module is not None:
            share(self, "text_encoder", text_encoder_module)
            text_dim = text_encoder_dim
        else:
            self.text_encoder = MHSAAddAtt(vocab_size, text_embed_dim, num_heads, query_dim,
                                           dropout, pretrained_embeddings, generator)
        self.entity_encoder = self.combine_linear = None
        if use_entities:
            self.entity_encoder = EntityAddAtt(entity_vocab_size, entity_embed_dim, query_dim,
                                               dropout, pretrained_entity_embeddings, generator)
            self.combine_linear = Dense(text_dim + entity_embed_dim, text_embed_dim,
                                        generator)

    def forward(self, news: NewsFeatures, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        tokens, mask = concat_text(news)
        text_vec = self.text_encoder(tokens, mask, deterministic, generator)
        ents, ents_mask = concat_entities(news)
        if self.entity_encoder is None or ents is None:
            return text_vec
        ent_vec = self.entity_encoder(ents, ents_mask, deterministic, generator)
        return self.combine_linear(torch.cat([text_vec, ent_vec], dim=-1))


def _parameter_slots(encoder: nn.Module):
    """``(module, name)`` of every parameter the news tower reads, a PLM
    tower that it reaches through ``share`` included."""
    modules = list(encoder.modules())
    tower = getattr(encoder, "text_encoder", None)
    if tower is not None and not any(tower is m for m in modules):
        modules += list(tower.modules())
    return [(m, n) for m in modules for n, p in m._parameters.items() if p is not None]


def checkpointed_news_encoder(encoder: nn.Module, news: NewsFeatures,
                              generator: Optional[torch.Generator]) -> torch.Tensor:
    """``encoder(news, False, generator)`` under ``torch.utils.checkpoint``
    (activations recomputed in the backward pass).

    Checkpoint restores the global RNG states only, and dropout draws from
    ``generator``: its state before the forward is kept, and the
    recomputation draws from that state (the forward's masks) and puts the
    generator back where it found it, so the generator ends the step where
    it would without the checkpoint.  The recomputation also reads the
    parameter tensors the forward read: under ``functional_call`` (the
    bf16 casts of ``apply_in_dtype``) the module holds them only during the
    forward."""
    slots = _parameter_slots(encoder)
    seen = [m._parameters[n] for m, n in slots]
    start = None if generator is None else generator.get_state()
    calls = []

    def run(news: NewsFeatures) -> torch.Tensor:
        if not calls:  # the forward
            calls.append(True)
            return encoder(news, False, generator)
        held = [m._parameters[n] for m, n in slots]  # the recomputation
        after = None if generator is None else generator.get_state()
        for (m, n), t in zip(slots, seen):
            m._parameters[n] = t
        if generator is not None:
            generator.set_state(start)
        try:
            return encoder(news, False, generator)
        finally:
            for (m, n), t in zip(slots, held):
                m._parameters[n] = t
            if generator is not None:
                generator.set_state(after)

    # without a generator, dropout draws from the global RNG, which checkpoint restores
    return checkpoint(run, news, use_reentrant=False, preserve_rng_state=generator is None)


class MANNeRCR(nn.Module):
    """CR-module, hyperparameters as the JAX ``MANNeRCR``.  Weights are drawn
    on the CPU from ``generator`` (seed 0 when none is given) and moved to
    ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, vocab_size: int, entity_vocab_size: int = 1, use_entities: bool = True,
                 text_embed_dim: int = 300, entity_embed_dim: int = 100, num_heads: int = 15,
                 query_dim: int = 200, dropout: float = 0.2, late_fusion: bool = True,
                 pretrained_embeddings: Optional[np.ndarray] = None,
                 pretrained_entity_embeddings: Optional[np.ndarray] = None,
                 remat: bool = False, text_encoder_module: Optional[nn.Module] = None,
                 text_encoder_dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.late_fusion = late_fusion
        self.remat = remat
        if text_encoder_module is not None:
            self.text_encoder_module = text_encoder_module
        self.news_encoder = MANNeRNewsEncoder(vocab_size, entity_vocab_size, use_entities,
                                              text_embed_dim, entity_embed_dim, num_heads,
                                              query_dim, dropout, pretrained_embeddings,
                                              pretrained_entity_embeddings, generator,
                                              text_encoder_module, text_encoder_dim)
        self.user_encoder = (None if late_fusion
                             else NRMSUserEncoder(text_embed_dim, num_heads, query_dim,
                                                  generator))
        self.to(device)

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Unique news -> (U, D) vectors (cacheable); with ``remat``, in a
        training forward (gradients on, dropout on), the news tower's
        activations are recomputed in the backward pass."""
        if self.remat and torch.is_grad_enabled() and not deterministic:
            return checkpointed_news_encoder(self.news_encoder, news, generator)
        return self.news_encoder(news, deterministic, generator)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor) -> torch.Tensor:
        hist = gather_news(news_vecs, batch.hist_idx)
        cand = gather_news(news_vecs, batch.cand_idx)
        if self.late_fusion:
            user = late_fusion_user(hist, batch.hist_mask)
        else:
            user = self.user_encoder(hist, batch.hist_mask)
        return dot_product_scores(user, cand)

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        return self.score_with_vectors(batch, news_vecs), {}


class MANNeRA(nn.Module):
    """A-module: ``forward(news)`` -> (U, D) aspect-space embeddings."""

    def __init__(self, vocab_size: int, entity_vocab_size: int = 1, use_entities: bool = True,
                 text_embed_dim: int = 300, entity_embed_dim: int = 100, num_heads: int = 15,
                 query_dim: int = 200, dropout: float = 0.2,
                 pretrained_embeddings: Optional[np.ndarray] = None,
                 pretrained_entity_embeddings: Optional[np.ndarray] = None,
                 text_encoder_module: Optional[nn.Module] = None,
                 text_encoder_dim: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if text_encoder_module is not None:
            self.text_encoder_module = text_encoder_module
        self.news_encoder = MANNeRNewsEncoder(vocab_size, entity_vocab_size, use_entities,
                                              text_embed_dim, entity_embed_dim, num_heads,
                                              query_dim, dropout, pretrained_embeddings,
                                              pretrained_entity_embeddings, generator,
                                              text_encoder_module, text_encoder_dim)
        self.to(device)

    def forward(self, news: NewsFeatures, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.news_encoder(news, deterministic, generator)


def supcon_embedding_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                          valid: Optional[torch.Tensor] = None,
                          temperature: float = 0.1) -> torch.Tensor:
    """Supervised contrastive loss on embeddings with dot-product similarity
    (pytorch-metric-learning ``SupConLoss(distance=DotProductSimilarity)``,
    AvgNonZero reduction).  Pairs are masked before the exp with -1e30 (the
    unmasked diagonal ``||e||^2 / tau`` leaves exp's range within a few
    steps), the row max is detached, and the mean runs over the anchors
    whose loss is not 0."""
    n = embeddings.shape[0]
    emb = embeddings.float()
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=emb.device)
    valid = valid.bool()
    sim = emb @ emb.T / temperature
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=emb.device)
    vpair = valid[:, None] & valid[None, :] & ~eye
    pos = same & vpair
    sim_masked = torch.where(vpair, sim, -1e30)
    m = sim_masked.max(dim=1, keepdim=True).values.detach()
    denom = torch.log(torch.exp(sim_masked - m).sum(dim=1)) + m[:, 0]
    log_prob = sim - denom[:, None]
    n_pos = pos.sum(dim=1).float()
    mean_log_prob_pos = torch.where(pos, log_prob, 0.0).sum(dim=1) / n_pos.clamp_min(1.0)
    per_anchor = torch.where((n_pos > 0) & valid, -mean_log_prob_pos, 0.0)
    nonzero = (per_anchor != 0).float()
    return per_anchor.sum() / nonzero.sum().clamp_min(1.0)


def zscore_per_impression(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-impression z-normalisation over the valid candidates, 0 at the
    padded ones (selects, never products with the mask)."""
    n = mask.to(scores.dtype).sum(dim=-1, keepdim=True).clamp_min(1.0)
    mean = torch.where(mask, scores, 0.0).sum(dim=-1, keepdim=True) / n
    var = torch.where(mask, (scores - mean) ** 2, 0.0).sum(dim=-1, keepdim=True) / n
    return torch.where(mask, (scores - mean) / torch.sqrt(var + 1e-8), 0.0)


def manner_ensemble_scores(cr_scores: torch.Tensor, aspect_scores: Dict[str, torch.Tensor],
                           weights: Dict[str, float], cand_mask: torch.Tensor) -> torch.Tensor:
    """Weighted sum of the per-impression z-scored module scores."""
    total = zscore_per_impression(cr_scores, cand_mask)
    for name, s in aspect_scores.items():
        total = total + weights.get(name, 0.0) * zscore_per_impression(s, cand_mask)
    return total


def aspect_module_scores(a_model: MANNeRA, batch: RecBatch) -> torch.Tensor:
    """Late-fusion dot-product scores from an A-module's embedding space."""
    news_vecs = encode_all_news(lambda news: a_model(news), batch)
    hist = gather_news(news_vecs, batch.hist_idx)
    cand = gather_news(news_vecs, batch.cand_idx)
    return dot_product_scores(late_fusion_user(hist, batch.hist_mask), cand)


class MANNeREnsemble(nn.Module):
    """The test-only ensemble as a servable model: ``encode_news`` puts the
    CR module's and every aspect tower's vectors side by side (one cached
    table), ``score_with_vectors`` slices each module's columns back, scores
    it by late fusion, z-normalises per impression and sums with the
    weights.  The submodules are ``cr`` and ``aspect_towers_<i>``, the JAX
    module's parameter names."""

    def __init__(self, cr: MANNeRCR, aspect_names: Sequence[str],
                 aspect_towers: Sequence[MANNeRA], aspect_weights: Sequence[float],
                 cr_dim: int = 300, aspect_dims: Optional[Sequence[int]] = None):
        super().__init__()
        self.cr = cr
        self.aspect_names = tuple(aspect_names)
        self.aspect_weights = tuple(float(w) for w in aspect_weights)
        for i, tower in enumerate(aspect_towers):
            setattr(self, f"aspect_towers_{i}", tower)
        self.cr_dim = cr_dim
        self.aspect_dims = (tuple(aspect_dims) if aspect_dims is not None
                            else (cr_dim,) * len(aspect_towers))

    @property
    def aspect_towers(self):
        return [getattr(self, f"aspect_towers_{i}") for i in range(len(self.aspect_names))]

    def encode_news(self, news: NewsFeatures, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
        vecs = [self.cr.encode_news(news, deterministic, generator)]
        vecs += [m(news, deterministic, generator) for m in self.aspect_towers]
        return torch.cat(vecs, dim=-1)

    def score_with_vectors(self, batch: RecBatch, news_vecs: torch.Tensor) -> torch.Tensor:
        fused = zscore_per_impression(
            self.cr.score_with_vectors(batch, news_vecs[:, :self.cr_dim]), batch.cand_mask)
        off = self.cr_dim
        for w, d in zip(self.aspect_weights, self.aspect_dims):
            a_vecs = news_vecs[:, off:off + d]
            off += d
            user = late_fusion_user(gather_news(a_vecs, batch.hist_idx), batch.hist_mask)
            fused = fused + w * zscore_per_impression(
                dot_product_scores(user, gather_news(a_vecs, batch.cand_idx)), batch.cand_mask)
        return fused

    def forward(self, batch: RecBatch, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        news_vecs = encode_all_news(
            lambda news: self.encode_news(news, deterministic, generator), batch)
        return self.score_with_vectors(batch, news_vecs), {}


def evaluate_ensemble(cr_model: MANNeRCR, aspect_modules: Dict[str, Tuple[MANNeRA, float]],
                      store, impressions, ranking=None, collect_auc: bool = True,
                      max_history_len: int = 50, target_cells: int = 8192,
                      device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    """The MANNeR ensemble over cached serving: ``aspect_modules`` maps a name
    to ``(A-module with its weights, weight)``; the modules lie on
    ``device``.  Each module's column width in the shared table is probed
    with a one-row encode (a module's ``text_embed_dim`` is not its output
    width when a PLM tower runs without an entity tower)."""
    from newsreclib_tpu_torch.serving import CachedScorer

    names = sorted(aspect_modules)
    probe = to_device(store.features_for(np.arange(1)), resolve_device(device))
    with torch.inference_mode():
        cr_dim = int(cr_model.eval().encode_news(probe).shape[-1])
        dims = [int(aspect_modules[n][0].eval()(probe).shape[-1]) for n in names]
    ens = MANNeREnsemble(cr_model, names, [aspect_modules[n][0] for n in names],
                         [aspect_modules[n][1] for n in names], cr_dim=cr_dim, aspect_dims=dims)
    return CachedScorer(ens, ranking=ranking, device=device).evaluate(
        store, impressions, max_history_len=max_history_len, target_cells=target_cells,
        collect_auc=collect_auc)
