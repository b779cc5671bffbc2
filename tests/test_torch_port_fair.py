"""The FairRec family in the port against the JAX package on the CPU:
SentiRec, SentiDebias and MANNeR (CR module, A-module, ensemble), their
blocks (``SentimentEncoder``, ``_abs_cos``, ``_sent_ce``,
``supcon_embedding_loss``, ``zscore_per_impression``), one optimizer step
each (SentiDebias's whole alternating G / D step), ``CachedScorer`` and
``evaluate_ensemble``, ``MPerClassNewsBatcher``, ``knn_label_purity``, the
factory's routes, the statfix v2 generator, and the CLI routes (the MANNeR
chain CR -> A-module -> the port's ``eval.py`` ensemble, SentiDebias with a
resume) on the demo data.

Inputs are made with numpy from a seed and fed to both packages; the JAX
modules' flax params become the port's state dicts
(``convert.flax_to_state_dict``), with no renaming.  Widths are small (2
heads of 8, titles of 12, abstracts of 6, vocab 200).  Tolerances (float32),
as ``test_torch_port_zoo2.py``: outputs and scores atol/rtol 1e-5, the
loss of one step rtol 1e-5, updated parameters atol 1e-6 (elements whose
gradient is float32 noise in both packages held through the gradient),
epoch metrics 1e-4.
"""

import filecmp
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.data import news_batching as jnews_batching
from newsreclib_tpu.data import statfix as jstatfix
from newsreclib_tpu.data.batching import EvalBatcher as JEvalBatcher
from newsreclib_tpu.data.batching import split_news_by_length
from newsreclib_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
from newsreclib_tpu.data.synthetic import make_batch as jmake_batch
from newsreclib_tpu.metrics import collector as jcollector
from newsreclib_tpu.models import factory as jfactory
from newsreclib_tpu.models import fair_rec as jfair
from newsreclib_tpu.models.components import category as jcategory
from newsreclib_tpu.models.components import losses as jlosses
from newsreclib_tpu.models.fair_rec import senti_debias as jsenti_debias
from newsreclib_tpu.serving import CachedScorer as JCachedScorer
from newsreclib_tpu.training import aspect as jaspect
from newsreclib_tpu.training import state as jstate
from newsreclib_tpu.training import steps as jsteps
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data import news_batching, statfix
from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.models import factory
from newsreclib_tpu_torch.models import fair_rec
from newsreclib_tpu_torch.models.components import category, losses
from newsreclib_tpu_torch.models.fair_rec import senti_debias
from newsreclib_tpu_torch.serving import CachedScorer
from newsreclib_tpu_torch.training import aspect
from newsreclib_tpu_torch.training import state as tstate
from newsreclib_tpu_torch.training import steps as tsteps
from tests.test_torch_port_data import SMALL_STATFIX
from tests.test_torch_port_zoo import (  # noqa: F401  (fixtures)
    EVAL,
    TOL,
    _np_params,
    _port,
    _t,
    few_torch_threads,
    zoo_store,
)
from tests.test_torch_port_zoo import CATEGORIES as ZOO_CATEGORIES
from tests.test_torch_port_zoo import ENTITIES as ZOO_ENTITIES
from tests.test_torch_port_zoo import VOCAB as ZOO_VOCAB
from tests.test_torch_port_zoo2 import NOISE_GRAD, QUIET_GRAD_ATOL

VOCAB, ENTITIES, CATEGORIES = 200, 40, 6
DATA = JSyntheticConfig(vocab_size=VOCAB, title_len=12, abstract_len=6, entity_len=4,
                        entity_vocab_size=ENTITIES, num_categories=CATEGORIES,
                        num_subcategories=CATEGORIES)
D, HEADS, QUERY = 16, 2, 4

# Small widths of each model, with the JAX constructor's names (the port's
# take the same keywords).
MODELS = {
    "sentirec": (jfair.SentiRec, fair_rec.SentiRec,
                 dict(embed_dim=D, num_heads=HEADS, query_dim=QUERY)),
    "manner_cr": (jfair.MANNeRCR, fair_rec.MANNeRCR,
                  dict(entity_vocab_size=ENTITIES, text_embed_dim=D, entity_embed_dim=6,
                       num_heads=HEADS, query_dim=QUERY)),
    "manner_cr_user": (jfair.MANNeRCR, fair_rec.MANNeRCR,
                       dict(entity_vocab_size=ENTITIES, text_embed_dim=D, entity_embed_dim=6,
                            num_heads=HEADS, query_dim=QUERY, late_fusion=False)),
    "manner_cr_text": (jfair.MANNeRCR, fair_rec.MANNeRCR,
                       dict(text_embed_dim=D, num_heads=HEADS, query_dim=QUERY,
                            use_entities=False)),
    "senti_debias": (jfair.SentiDebiasGenerator, fair_rec.SentiDebiasGenerator,
                     dict(embed_dim=D, num_heads=HEADS, query_dim=QUERY, sent_embed_dim=5)),
}
A_DIMS = dict(entity_vocab_size=ENTITIES, text_embed_dim=D, entity_embed_dim=6,
              num_heads=HEADS, query_dim=QUERY)


def jax_batch(seed, split=False, b=6):
    batch = jmake_batch(np.random.default_rng(seed), batch_size=b, hist_len=8, num_candidates=5,
                        unique_news=28, cfg=DATA)
    if split:
        n, n2, hist, cand = split_news_by_length(batch.news, batch.hist_idx, batch.cand_idx, 8,
                                                 min_tail=4)
        assert n2 is not None
        batch = batch._replace(news=n, news2=n2, hist_idx=hist, cand_idx=cand)
    return batch


def port_batch(b) -> RecBatch:
    fields = b._asdict()
    for seg in ("news", "news2"):
        if fields[seg] is not None:
            fields[seg] = NewsFeatures(*fields[seg])
    return to_device(RecBatch(**fields), "cpu")


def port_news(news) -> NewsFeatures:
    return to_device(NewsFeatures(*news), "cpu")


def both_models(name, batch, **kw):
    jcls, tcls, dims = MODELS[name]
    dims = {**dims, **kw}
    jm = jcls(vocab_size=VOCAB, **dims)
    params = jm.init(jax.random.key(0), batch)["params"]
    return jm, params, _port(tcls(VOCAB, device="cpu", **dims), params)


def both_aspect_modules(news, seed=0, **kw):
    jm = jfair.MANNeRA(vocab_size=VOCAB, **A_DIMS, **kw)
    params = jm.init(jax.random.key(seed), news)["params"]
    return jm, params, _port(fair_rec.MANNeRA(VOCAB, device="cpu", **A_DIMS, **kw), params)


# ------------------------------------------------------------------ blocks

def test_sentiment_encoder_matches_jax():
    ids = np.array([0, 1, 3, 2, 2, 0], dtype=np.int32)
    jm = jcategory.SentimentEncoder(num_sent_classes=3, sent_embed_dim=5, sent_output_dim=7)
    params = jm.init(jax.random.key(0), jnp.asarray(ids))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    tm = _port(category.SentimentEncoder(3, 5, 7), params)
    with torch.no_grad():
        got = tm(_t(ids))
    assert got.shape == (6, 7)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the pad class embeds to zero: tanh(bias) = 0 at init
    np.testing.assert_allclose(got[0].numpy(), np.tanh(params["linear"]["bias"]), **TOL)


def test_abs_cos_matches_jax_with_zero_rows():
    """Values and the gradient of a weighted sum, with zero rows (padding
    articles): 0, with JAX's finite gradient (its ``abs`` has derivative 1
    at 0, torch's 0)."""
    rng = np.random.default_rng(0)
    a, b = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(2))
    a[1] = 0.0
    b[3] = 0.0
    w = rng.normal(size=6).astype(np.float32)

    def jf(x, y):
        return jnp.sum(jsenti_debias._abs_cos(x, y) * w)

    want = np.asarray(jsenti_debias._abs_cos(jnp.asarray(a), jnp.asarray(b)))
    want_g = [np.asarray(g) for g in jax.grad(jf, argnums=(0, 1))(jnp.asarray(a),
                                                                     jnp.asarray(b))]
    ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
    got = senti_debias._abs_cos(ta, tb)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    for g, wg in zip((ta.grad, tb.grad), want_g):
        np.testing.assert_allclose(g.numpy(), wg, **TOL)
        assert np.isfinite(g.numpy()).all()
    assert got[1].item() == got[3].item() == 0.0


def test_sent_ce_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(7, 4)).astype(np.float32) * 3
    labels = np.array([0, 1, 2, 3, 3, 1, 2], dtype=np.int32)
    valid = np.array([0, 1, 1, 1, 0, 1, 1], dtype=np.float32)
    want = float(jsenti_debias._sent_ce(jnp.asarray(logits), jnp.asarray(labels),
                                        jnp.asarray(valid)))
    for v in (_t(valid), _t(valid != 0)):
        got = senti_debias._sent_ce(_t(logits), _t(labels), v).item()
        assert got == pytest.approx(want, rel=1e-6)
    assert senti_debias._sent_ce(_t(logits), _t(labels), torch.zeros(7)).item() == 0.0


SUPCON_CASES = ["plain", "masked_rows", "all_masked", "no_positives", "large_norms"]


@pytest.mark.parametrize("case", SUPCON_CASES)
def test_supcon_embedding_loss_matches_jax(case):
    """Value and gradient: invalid rows, every row invalid (0), no anchor
    with a positive (0), and embeddings whose unmasked diagonal
    ``||e||^2 / tau`` would overflow exp (finite in both)."""
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(10, 6)).astype(np.float32)
    labels = rng.integers(1, 4, size=10).astype(np.int32)
    valid = np.ones(10, dtype=bool)
    if case == "masked_rows":
        valid[[0, 4, 7]] = False
    elif case == "all_masked":
        valid[:] = False
    elif case == "no_positives":
        labels = np.arange(10, dtype=np.int32)
    elif case == "large_norms":
        emb *= 30.0

    def jf(e):
        return jfair.supcon_embedding_loss(e, jnp.asarray(labels), jnp.asarray(valid), 0.1)

    want = float(jf(jnp.asarray(emb)))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(emb)))
    te = _t(emb).requires_grad_()
    got = fair_rec.supcon_embedding_loss(te, _t(labels), _t(valid), 0.1)
    got.backward()
    assert math.isfinite(got.item()) and np.isfinite(te.grad.numpy()).all()
    assert got.item() == pytest.approx(want, rel=1e-5, abs=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), want_g, atol=1e-5, rtol=1e-4)
    if case in ("all_masked", "no_positives"):
        assert got.item() == 0.0
    # valid=None means every row valid
    if case == "plain":
        again = fair_rec.supcon_embedding_loss(_t(emb), _t(labels))
        assert again.item() == pytest.approx(got.item(), rel=1e-6)


def test_zscore_and_ensemble_fusion_match_jax():
    rng = np.random.default_rng(3)
    mask = np.arange(6)[None] < np.array([[6], [3], [1], [0]])
    cr, s1, s2 = (rng.normal(size=(4, 6)).astype(np.float32) * 5 for _ in range(3))
    want = np.asarray(jfair.zscore_per_impression(jnp.asarray(cr), jnp.asarray(mask)))
    got = fair_rec.zscore_per_impression(_t(cr), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[~mask], 0.0)
    weights = {"categ": 0.3, "sent": 0.1}
    want = np.asarray(jfair.manner_ensemble_scores(
        jnp.asarray(cr), {"categ": jnp.asarray(s1), "sent": jnp.asarray(s2)}, weights,
        jnp.asarray(mask)))
    got = fair_rec.manner_ensemble_scores(_t(cr), {"categ": _t(s1), "sent": _t(s2)}, weights,
                                          _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # a -1e30 padded score (served scores are masked so) stays out of the moments
    padded = np.where(mask, cr, -1e30).astype(np.float32)
    np.testing.assert_allclose(fair_rec.zscore_per_impression(_t(padded), _t(mask)).numpy(),
                               fair_rec.zscore_per_impression(_t(cr), _t(mask)).numpy(), **TOL)


@pytest.mark.parametrize("abstract", [True, False])
def test_manner_news_encoder_matches_jax(abstract):
    """Concatenated title + abstract tokens and title + abstract entities
    (the title and title entities alone without abstracts)."""
    news = jax_batch(seed=4).news
    if not abstract:
        news = news._replace(abstract=None, abstract_mask=None, abstract_entities=None,
                             abstract_entities_mask=None)
    jm, params, tm = both_aspect_modules(news)
    want = np.asarray(jm.apply({"params": params}, news))
    with torch.no_grad():
        got = tm(port_news(news))
    assert got.shape == (28, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_scores_match_jax(name, split):
    """Scores and the aux terms of the forward (SentiDebias: the bias-free
    scores, its eval protocol)."""
    b = jax_batch(seed=11, split=split)
    jm, params, tm = both_models(name, b)
    want, want_aux = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, aux = tm(port_batch(b))
    assert got.shape == (6, 5) and set(aux) == set(want_aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), **TOL, err_msg=k)
    if name == "sentirec":
        assert aux["sent_pred_loss"].item() > 0


@pytest.mark.parametrize("split", [False, True])
def test_senti_debias_full_output_matches_jax(split):
    b = jax_batch(seed=12, split=split)
    jm, params, tm = both_models("senti_debias", b)
    want = jm.apply({"params": params}, b, method=jfair.SentiDebiasGenerator.full_output)
    with torch.no_grad():
        got = tm.full_output(port_batch(b))
        served = tm.score_with_vectors(port_batch(b), got["news_vecs"])
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                   np.asarray(v, dtype=np.float64), **TOL, err_msg=k)
    np.testing.assert_allclose(served.numpy(), np.asarray(want["bias_free_scores"]), **TOL)


def test_manner_ensemble_and_aspect_scores_match_jax():
    """``MANNeREnsemble`` (CR + two aspect towers, one shared table) and
    ``aspect_module_scores`` on a split batch."""
    b = jax_batch(seed=17, split=True)
    jcr, cr_params, tcr = both_models("manner_cr", b)
    towers = [both_aspect_modules(b.news, seed=s) for s in (1, 2)]
    jens = jfair.MANNeREnsemble(cr=jcr, aspect_names=("categ", "sent"),
                                aspect_towers=tuple(t[0] for t in towers),
                                aspect_weights=(0.3, 0.1), cr_dim=D, aspect_dims=(D, D))
    params = {"cr": cr_params, "aspect_towers_0": towers[0][1], "aspect_towers_1": towers[1][1]}
    want = np.asarray(jens.apply({"params": params}, b)[0])
    tens = fair_rec.MANNeREnsemble(tcr, ("categ", "sent"), [t[2] for t in towers], (0.3, 0.1),
                                   cr_dim=D, aspect_dims=(D, D))
    assert set(tens.state_dict()) == set(flax_to_state_dict(_np_params(params)))
    with torch.no_grad():
        got = tens(port_batch(b))[0]
        a_scores = fair_rec.aspect_module_scores(towers[0][2], port_batch(b))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_a = np.asarray(jfair.aspect_module_scores(towers[0][0].apply, towers[0][1], b))
    np.testing.assert_allclose(a_scores.numpy(), want_a, **TOL)


def _gradients_of(jopt_state, model, opt):
    """The gradients of one step from Adam's first moments (0.1 g after one
    update), JAX's and the port's, by parameter name."""
    mu = next(s.mu for s in jax.tree.leaves(jopt_state, is_leaf=lambda x: hasattr(x, "mu"))
              if hasattr(s, "mu"))
    want = {k: 10.0 * v.numpy() for k, v in flax_to_state_dict(_np_params(mu)).items()}
    got = {n: 10.0 * opt.state[p]["exp_avg"].numpy() for n, p in model.named_parameters()}
    return got, want


def assert_same_update(jparams, jopt_state, model, opt):
    """Every updated parameter within atol 1e-6 of JAX's, but the elements
    whose gradient is float32 noise in both packages (held through the
    gradient, ``test_torch_port_zoo2.py``); at least a third of the
    elements with a gradient are held through their update."""
    got_g, want_g = _gradients_of(jopt_state, model, opt)
    want = flax_to_state_dict(_np_params(jparams))
    got = model.state_dict()
    assert set(got) == set(want) == set(got_g)
    held = total = 0
    for k, v in want.items():
        quiet = (np.abs(got_g[k]) < NOISE_GRAD) & (np.abs(want_g[k]) < NOISE_GRAD)
        np.testing.assert_allclose(got[k].numpy()[~quiet], v.numpy()[~quiet], atol=1e-6, rtol=0,
                                   err_msg=k)
        np.testing.assert_allclose(got_g[k][quiet], want_g[k][quiet], atol=QUIET_GRAD_ATOL,
                                   rtol=0, err_msg=k)
        held += int((~quiet).sum())
        total += int(((got_g[k] != 0) | (want_g[k] != 0)).sum())
    assert held >= total / 3, (held, total)


@pytest.mark.parametrize("name,loss", [("sentirec", "cross_entropy_loss"),
                                       ("manner_cr", "sup_con_loss")])
def test_one_adam_step_matches_jax(name, loss):
    """One train step (the configs' loss plus the aux terms, Adam lr 1e-4,
    dropout off) on a split batch from the same parameters: the loss and
    the aux terms, and every updated parameter."""
    b = jax_batch(seed=19, split=True)
    jm, params, tm = both_models(name, b, dropout=0.0)
    js = jstate.create_train_state(jm, b, jax.random.key(0), jstate.make_optimizer(1e-4))
    js = js.replace(params=params)
    ts = tstate.create_train_state(tm.train(), tstate.make_optimizer(1e-4), dropout_seed=0)
    jloss = jlosses.get_loss_fn(loss, temperature=0.1)
    tloss = losses.get_loss_fn(loss, temperature=0.1)
    js, jout = jsteps.make_train_step(jloss, donate=False)(js, b)
    ts, tout = tsteps.make_train_step(tloss)(ts, port_batch(b))
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=1e-5, err_msg=k)
    assert_same_update(js.params, js.opt_state, ts.model, ts.opt)


def test_sentidebias_alternating_step_matches_jax():
    """One whole alternating step (alpha 0.15, beta 10, G lr 1e-3, D lr
    2e-3, dropout off) from the same parameters: the six loss metrics and
    both networks' parameters after it."""
    b = jax_batch(seed=15, split=True, b=8)
    jgen, gparams, tgen = both_models("senti_debias", b, dropout=0.0)
    jdisc = jfair.SentiDebiasDiscriminator(hidden_dim=7)
    js = jfair.create_sentidebias_state(jgen, jdisc, b, jax.random.key(0), g_lr=1e-3, d_lr=2e-3)
    js = js._replace(g=js.g.replace(params=gparams))
    tdisc = _port(fair_rec.SentiDebiasDiscriminator(D, 7, device="cpu"), js.d.params)
    ts = fair_rec.create_sentidebias_state(tgen.train(), tdisc.train(), g_lr=1e-3, d_lr=2e-3)
    js2, jout = jfair.make_sentidebias_train_step(0.15, 10.0)(js, b)
    ts, tout = fair_rec.make_sentidebias_train_step(0.15, 10.0)(ts, port_batch(b))
    assert set(tout) == set(jout) == {"loss", "g_loss", "d_loss", "rec_loss", "adv_loss",
                                      "orth_loss"}
    for k in jout:
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=1e-5, err_msg=k)
    assert_same_update(js2.g.params, js2.g.opt_state, ts.g.model, ts.g.opt)
    assert_same_update(js2.d.params, js2.d.opt_state, ts.d.model, ts.d.opt)
    assert ts.g.step == ts.d.step == 1


def test_sentidebias_step_replays_the_dropout_masks():
    """With dropout on, D's step sees the news vectors of the updated G
    under the masks G's step drew: the same vectors as a fresh forward of
    the updated news tower from the generator reseeded at the step's seed."""
    b = port_batch(jax_batch(seed=16, split=True))
    gen, disc = factory.build_senti_debias(
        {"embed_dim": D, "num_heads": HEADS, "query_dim": QUERY, "sent_embed_dim": 5,
         "discriminator_hidden_dim": 7}, factory.DataInfo(vocab_size=VOCAB), device="cpu")
    state = fair_rec.create_sentidebias_state(gen, disc, seed=3)
    seen = []
    hook = disc.linear1.register_forward_hook(lambda m, i, o: seen.append(i[0].detach()))
    fair_rec.make_sentidebias_train_step()(state, b)
    hook.remove()
    def tower(step):
        state.g.step = step
        g = state.g.dropout_generator()
        with torch.no_grad():
            return torch.cat([gen.news_encoder(n.title, n.title_mask, False, g)
                              for n in (b.news, b.news2)])

    assert len(seen) == 2
    torch.testing.assert_close(seen[1], tower(0), rtol=0, atol=0)
    assert not torch.equal(seen[1], tower(1))  # other masks give other vectors


def test_aspect_step_matches_jax():
    """One A-module SupCon step (Adam lr 1e-3, dropout off) on an
    ``MPerClassNewsBatcher`` batch: the loss and the updated parameters."""
    jstore, store = _stores()
    jb = next(jnews_batching.MPerClassNewsBatcher(jstore, "category", batch_size=12,
                                                  m_per_class=3, seed=0).epoch(0))
    tb = next(news_batching.MPerClassNewsBatcher(store, "category", batch_size=12,
                                                 m_per_class=3, seed=0).epoch(0))
    jm, params, tm = both_aspect_modules(jb.news, dropout=0.0)
    js = jstate.TrainState.create(apply_fn=jm.apply, params=params,
                                  tx=jstate.make_optimizer(1e-3), dropout_rng=jax.random.key(1))
    js, jout = jaspect.make_aspect_train_step(0.1)(js, jb)
    ts = tstate.create_train_state(tm.train(), tstate.make_optimizer(1e-3))
    ts, tout = aspect.make_aspect_train_step(0.1)(ts, to_device(tb, "cpu"))
    np.testing.assert_allclose(tout["loss"].item(), float(jout["loss"]), rtol=1e-5)
    assert_same_update(js.params, js.opt_state, ts.model, ts.opt)
    ev = aspect.make_aspect_eval_loss(0.1)(ts, to_device(tb, "cpu")).item()
    assert ev == pytest.approx(float(jaspect.make_aspect_eval_loss(0.1)(js, jb)), rel=1e-5)


def test_train_aspect_module_matches_jax():
    """``train_aspect_module`` over two epochs of two m-per-class batches
    each (Adam lr 1e-3, dropout off): the JAX package's parameters, atol
    1e-5 after four updates (elements whose gradient is float32 noise in
    both packages, as an attention scorer's last bias, follow it through
    Adam: 1.7e-6 apart here, the rest within 1e-6)."""
    jstore, store = _stores()
    kw = dict(aspect="sentiment", batch_size=12, m_per_class=4, seed=1)
    jbatcher = jnews_batching.MPerClassNewsBatcher(jstore, **kw)
    jm, params, tm = both_aspect_modules(next(jbatcher.epoch(0)).news, dropout=0.0)
    js = jstate.TrainState.create(apply_fn=jm.apply, params=params,
                                  tx=jstate.make_optimizer(1e-3), dropout_rng=jax.random.key(1))
    js = jaspect.train_aspect_module(js, jbatcher, epochs=2, limit_batches=2)
    ts = aspect.train_aspect_module(
        tstate.create_train_state(tm.train(), tstate.make_optimizer(1e-3)),
        news_batching.MPerClassNewsBatcher(store, **kw), epochs=2, limit_batches=2)
    assert ts.step == 4
    for k, v in flax_to_state_dict(_np_params(js.params)).items():
        np.testing.assert_allclose(ts.model.state_dict()[k].numpy(), v.numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


# --------------------------------------------------------- batching, kNN

def _stores():
    """The zoo's store (categories, sentiments, abstracts, title entities)
    in both packages, with the port's widths for the A-module."""
    from newsreclib_tpu.data.news_store import NewsStore as JNewsStore
    from newsreclib_tpu_torch.data.news_store import NewsStore

    rng = np.random.default_rng(5)
    n = 90
    title = np.where(np.arange(12)[None] < rng.integers(2, 13, size=(n + 1, 1)),
                     rng.integers(1, VOCAB, size=(n + 1, 12)), 0).astype(np.int32)
    abstract = np.where(np.arange(6)[None] < rng.integers(0, 7, size=(n + 1, 1)),
                        rng.integers(1, VOCAB, size=(n + 1, 6)), 0).astype(np.int32)
    ents = np.where(rng.random((n + 1, 4)) < 0.4, rng.integers(1, ENTITIES, size=(n + 1, 4)),
                    0).astype(np.int32)
    title[0] = abstract[0] = ents[0] = 0
    arrays = dict(nid2row={f"N{i}": i for i in range(1, n + 1)}, title=title, abstract=abstract,
                  category=np.r_[0, rng.integers(0, CATEGORIES, size=n)].astype(np.int32),
                  sentiment=np.r_[0, rng.integers(1, 4, size=n)].astype(np.int32),
                  title_entities=ents)
    return JNewsStore(**arrays), NewsStore(**arrays)


@pytest.mark.parametrize("aspect_name,m", [("category", 3), ("sentiment", 4)])
def test_mper_class_batcher_matches_jax(aspect_name, m):
    """The same batches, row for row, for two epochs (articles of the pad
    class 0 left out, classes with fewer than m articles drawn with
    replacement)."""
    jstore, store = _stores()
    jb = jnews_batching.MPerClassNewsBatcher(jstore, aspect_name, batch_size=12, m_per_class=m,
                                             seed=3)
    tb = news_batching.MPerClassNewsBatcher(store, aspect_name, batch_size=12, m_per_class=m,
                                            seed=3)
    assert len(tb) == len(jb) > 1
    for epoch in range(2):
        batches = list(zip(jb.epoch(epoch), tb.epoch(epoch)))
        assert len(batches) == len(tb)
        for want, got in batches:
            np.testing.assert_array_equal(got.labels, want.labels)
            np.testing.assert_array_equal(got.valid, want.valid)
            for field, value in want.news._asdict().items():
                if value is None:
                    assert getattr(got.news, field) is None
                else:
                    np.testing.assert_array_equal(getattr(got.news, field), value)
            assert (got.labels > 0).all()
            counts = np.unique(got.labels, return_counts=True)[1]
            assert (counts % m == 0).all()


def test_knn_label_purity_matches_jax():
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 4, size=60)
    emb = rng.normal(size=(60, 5)) + 2.0 * np.eye(5)[labels]
    emb[3] = 0.0
    want = jaspect.knn_label_purity(emb, labels, k=5)
    assert aspect.knn_label_purity(emb, labels, k=5) == want
    assert 0.25 < want <= 1.0


# ----------------------------------------------------------------- serving

def _zoo_width_models(name, b):
    """The model at the zoo store's sizes (vocab 300, 40 entities)."""
    jcls, tcls, dims = MODELS[name]
    if "entity_vocab_size" in dims:
        dims = {**dims, "entity_vocab_size": ZOO_ENTITIES}
    jm = jcls(vocab_size=ZOO_VOCAB, **dims)
    params = jm.init(jax.random.key(0), b)["params"]
    return jm, params, _port(tcls(ZOO_VOCAB, device="cpu", **dims), params)


def _zoo_batch():
    cfg = JSyntheticConfig(vocab_size=ZOO_VOCAB, title_len=24, abstract_len=20, entity_len=6,
                           entity_vocab_size=ZOO_ENTITIES, num_categories=ZOO_CATEGORIES)
    return jmake_batch(np.random.default_rng(17), batch_size=4, hist_len=8, num_candidates=5,
                       unique_news=20, cfg=cfg)


@pytest.mark.parametrize("name", ["manner_cr", "senti_debias", "sentirec"])
def test_cached_scorer_matches_jax(zoo_store, name):
    """Cached serving over a store with abstracts and entities (both length
    buckets of the corpus encode).  SentiDebias's generator has no serving
    split in the JAX package, which evaluates it through its eval step: the
    port's served metrics equal those of that loop."""
    (jstore, jimp), (store, imp) = zoo_store
    jm, params, tm = _zoo_width_models(name, _zoo_batch())
    got = CachedScorer(tm, device="cpu", loss_fn=losses.cross_entropy_loss).evaluate(
        store, imp, **EVAL)
    if name != "senti_debias":
        want = JCachedScorer(jm).evaluate(params, jstore, jimp, **EVAL)
        got.pop("loss")
    else:
        js = jstate.create_train_state(jm, _zoo_batch(), jax.random.key(0),
                                       jstate.make_optimizer(1e-4)).replace(params=params)
        step = jsteps.make_eval_step(jlosses.cross_entropy_loss)
        stream = jcollector.StreamingEval()
        for jb in JEvalBatcher(jstore, jimp, max_history_len=8, target_cells=64,
                               u_bucket_min=16, split_title_len=16):
            scores, per_imp, valid, loss = step(js, jb)
            stream.update(scores, per_imp, valid, jb.labels, jb.cand_mask, loss)
        want = stream.finalize()
    assert set(got) == set(want) and "auc" in got
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


def test_evaluate_ensemble_matches_jax(zoo_store):
    (jstore, jimp), (store, imp) = zoo_store
    b = _zoo_batch()
    jcr, cr_params, tcr = _zoo_width_models("manner_cr", b)
    dims = {**A_DIMS, "entity_vocab_size": ZOO_ENTITIES}
    jmods, tmods = {}, {}
    for i, (name, w) in enumerate((("sent", 0.1), ("categ", 0.4))):
        jm = jfair.MANNeRA(vocab_size=ZOO_VOCAB, **dims)
        params = jm.init(jax.random.key(5 + i), b.news)["params"]
        jmods[name] = (jm, params, w)
        tmods[name] = (_port(fair_rec.MANNeRA(ZOO_VOCAB, device="cpu", **dims), params), w)
    kw = dict(max_history_len=EVAL["max_history_len"], target_cells=EVAL["target_cells"])
    want = jfair.evaluate_ensemble(jcr, cr_params, jmods, jstore, jimp,
                                   jcollector.RankingMetrics(), **kw)
    got = fair_rec.evaluate_ensemble(tcr, tmods, store, imp, device="cpu", **kw)
    assert set(got) == set(want) and "auc" in got
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


# ----------------------------------------------------------------- factory

FACTORY_CASES = ["manner_a", "manner_cr", "senti_debias_d", "senti_debias_g", "sentirec"]


@pytest.mark.parametrize("case", FACTORY_CASES)
def test_factory_builds_the_jax_models_parameters(case):
    """The port's route from the model's config file gives the JAX
    factory's model: the same parameter names and shapes at the config's
    widths (``build_model``, ``build_manner_a``, ``build_senti_debias``)."""
    from newsreclib_tpu_torch.config.compose import compose

    name = case.rsplit("_", 1)[0] if case.startswith("senti_debias") else case
    cfg = compose(overrides=[f"model={name}"])["model"]
    kw = dict(vocab_size=ZOO_VOCAB, num_categories=ZOO_CATEGORIES, entity_vocab_size=ZOO_ENTITIES)
    big = JSyntheticConfig(vocab_size=ZOO_VOCAB, title_len=24, abstract_len=8, entity_len=4,
                           entity_vocab_size=ZOO_ENTITIES, num_categories=ZOO_CATEGORIES)
    b = jmake_batch(np.random.default_rng(0), batch_size=2, hist_len=6, num_candidates=3,
                    unique_news=8, cfg=big)
    jinfo, tinfo = jfactory.DataInfo(**kw), factory.DataInfo(**kw)
    if case == "manner_a":
        jm, init = jfactory.build_manner_a(cfg, jinfo), (b.news,)
        tm = factory.build_manner_a(cfg, tinfo, device="cpu")
    elif name == "senti_debias":
        jgen, jdisc = jfactory.build_senti_debias(cfg, jinfo)
        tgen, tdisc = factory.build_senti_debias(cfg, tinfo, device="cpu")
        if case.endswith("_g"):
            jm, tm, init = jgen, tgen, (b,)
        else:
            jm, tm, init = jdisc, tdisc, (jnp.zeros((1, 300)),)
    else:
        jm, init = jfactory.build_model(cfg, jinfo), (b,)
        tm = factory.build_model(cfg, tinfo, device="cpu")
        assert name in factory.PORTED_MODELS
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), *init))["params"]
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want


def test_factory_routes_refuse_what_is_not_theirs():
    """``build_model`` points the models with their own builders at them,
    and every FairRec builder still refuses the PLM tower."""
    info = factory.DataInfo(vocab_size=VOCAB)
    for name, builder in (("senti_debias", "build_senti_debias"),
                          ("manner_a", "build_manner_a"), ("manner", "eval")):
        with pytest.raises(ValueError, match=builder):
            factory.build_model({"name": name}, info, device="cpu")
    with pytest.raises(ValueError, match="unknown model"):
        factory.build_model({"name": "nope"}, info, device="cpu")
    for build in (lambda c: factory.build_model(dict(c, name="sentirec"), info, device="cpu"),
                  lambda c: factory.build_manner_a(c, info, device="cpu"),
                  lambda c: factory.build_senti_debias(c, info, device="cpu")):
        with pytest.raises(NotImplementedError, match='ROADMAP queue 1, "PLM tower"'):
            build({"use_plm": True})
    with pytest.raises(NotImplementedError, match="remat"):
        factory.build_model({"name": "manner_cr", "remat": True}, info, device="cpu")


# ----------------------------------------------------------------- data

def test_statfix_v2_generators_write_identical_files(tmp_path, monkeypatch):
    """At reduced size (monkeypatched constants, as the v1 test): every
    file, the truth sidecar included, byte for byte."""
    for module in (jstatfix, statfix):
        for name, value in SMALL_STATFIX.items():
            monkeypatch.setattr(module, name, value)
    jstatfix.write_mind_small_statfix_v2(str(tmp_path / "jax"), seed=7)
    statfix.write_mind_small_statfix_v2(str(tmp_path / "port"), seed=7)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 8  # 2 x (news, behaviors, entity vectors) + GloVe + truth
    for rel in files:
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel, shallow=False), rel
    with np.load(tmp_path / "port" / "statfix_v2_truth.npz") as truth:
        assert set(truth.files) == {"news_cat", "news_topic", "news_pol", "user_pol"}
        assert len(truth["news_pol"]) == SMALL_STATFIX["TRAIN_NEWS"]


# ----------------------------------------------------------------- CLI

def _cli_args(data, out, *extra):
    return ["platform=cpu", f"data.data_dir={data}",
            f"data.word_embeddings_fpath={data / 'glove_demo.txt'}", f"output_dir={out}",
            *extra]


def test_manner_cli_chain_on_demo_data(tmp_path):
    """``manner_cr_demo`` -> ``manner_a_categ_demo`` -> the port's
    ``eval.py`` ``manner_ensemble_demo`` over those checkpoints, on the CPU;
    then ``eval.py`` with ``ckpt_path`` restores the CR run and gives its
    test metrics again."""
    from newsreclib_tpu_torch import eval as teval
    from newsreclib_tpu_torch import train
    from tests.test_torch_port_cli import demo_copy

    data = demo_copy(tmp_path / "data")
    cr = train.main(["experiment=manner_cr_demo",
                     *_cli_args(data, tmp_path / "cr", "trainer.limit_train_batches=4")])
    assert {"val/auc", "test/auc", "test/loss"} <= set(cr)
    assert all(math.isfinite(v) for v in cr.values())
    a = train.main(["experiment=manner_a_categ_demo",
                    *_cli_args(data, tmp_path / "a", "trainer.limit_train_batches=4")])
    assert {"train/loss", "val/loss", "best_loss", "val/knn_purity"} <= set(a)
    assert all(math.isfinite(v) for v in a.values()) and 0 <= a["val/knn_purity"] <= 1
    for run in ("cr", "a"):
        assert (tmp_path / run / "checkpoints" / "best.pt").exists()
    ens = teval.main(["experiment=manner_ensemble_demo",
                      *_cli_args(data, tmp_path / "ens",
                                 f"model.cr_ckpt={tmp_path / 'cr' / 'checkpoints'}",
                                 f"model.aspects.categ.ckpt={tmp_path / 'a' / 'checkpoints'}")])
    assert {"test/auc", "test/mrr", "test/ndcg@10"} <= set(ens)
    assert all(math.isfinite(v) for v in ens.values())
    assert (tmp_path / "ens" / "metrics.csv").exists()
    again = teval.main(["experiment=manner_cr_demo",
                        *_cli_args(data, tmp_path / "again",
                                   f"ckpt_path={tmp_path / 'cr' / 'checkpoints'}")])
    for k in ("test/auc", "test/mrr", "test/loss"):
        assert again[k] == pytest.approx(cr[k], abs=1e-6), k


def test_senti_debias_cli_with_a_resume(tmp_path):
    """SentiDebias through the CLI (adversarial route) for one epoch, then a
    resume from its checkpoints for a second: the generator's and the
    discriminator's 'last' checkpoints, the G / D losses in
    ``metrics.csv``, finite test metrics."""
    from newsreclib_tpu_torch import train
    from tests.test_torch_port_cli import demo_copy

    data = demo_copy(tmp_path / "data")
    out = tmp_path / "run"
    args = ["data=mind_demo", "model=senti_debias", "model.embed_dim=48", "model.num_heads=4",
            "model.query_dim=16", "model.use_pretrained_embeddings=false",
            "trainer.limit_train_batches=3", "trainer.log_every_n_steps=1"]
    first = train.main([*args, "trainer.max_epochs=1", *_cli_args(data, out)])
    assert {"train/g_loss", "train/d_loss", "val/auc", "test/auc"} <= set(first)
    ckpts = out / "checkpoints"
    assert (ckpts / "last.pt").exists() and (ckpts / "disc" / "last.pt").exists()
    assert json.loads((ckpts / "last.json").read_text())["epoch"] == 0
    disc_before = torch.load(ckpts / "disc" / "last.pt", weights_only=True)["params"]
    second = train.main([*args, "trainer.max_epochs=2", f"ckpt_path={ckpts}",
                         *_cli_args(data, out)])
    assert json.loads((ckpts / "last.json").read_text())["epoch"] == 1
    assert json.loads((ckpts / "last.json").read_text())["step"] == 6
    disc_after = torch.load(ckpts / "disc" / "last.pt", weights_only=True)["params"]
    assert any(not torch.equal(disc_before[k], disc_after[k]) for k in disc_after)
    assert all(math.isfinite(v) for v in second.values())
    rows = (out / "metrics.csv").read_text().splitlines()
    assert "train/g_loss" in rows[0] and "train/d_loss" in rows[0]


def test_cli_generates_the_v2_fixture(tmp_path, monkeypatch):
    """``data.generate_fixture: statfix_v2`` writes the v2 fixture (truth
    sidecar included) into an empty ``data_dir`` before the ETL, at reduced
    size; the JAX package's other fixture generators still raise."""
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.config.compose import compose

    for name, value in SMALL_STATFIX.items():
        monkeypatch.setattr(statfix, name, value)
    cfg = compose(overrides=["experiment=sentirec_statfix2_celoss", "platform=cpu",
                             f"data.data_dir={tmp_path / 'v2'}"])
    mind = train.setup_data(cfg)
    assert (tmp_path / "v2" / "statfix_v2_truth.npz").exists()
    assert mind.news_store("train").num_news == SMALL_STATFIX["TRAIN_NEWS"]
    cfg["data"].update(generate_fixture="statfix_adressa", data_dir=str(tmp_path / "other"))
    with pytest.raises(NotImplementedError, match='ROADMAP queue 1, "Other datasets"'):
        train.setup_data(cfg)
