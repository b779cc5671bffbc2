"""NAML, TANR, LSTUR, NPA, MINER and DKN in the port against the JAX package
on the CPU: each new block (``pairwise_cosine_similarity``, ``CNNAddAtt``,
``PersonalizedAttention``, ``CNNPersAtt``, ``PolyAttention``,
``TargetAwareAttention``, ``KCNN``, ``DNNPredictor``), the NAML, LSTUR, NPA
and DKN user encoders, each model's scores on plain and length-split
batches, late fusion, one Adam step with the aux losses, ``CachedScorer``
for the cacheable five, NPA's eval-step metrics, the factory's routes, the
CLI's DKN title-split check and LSTUR's user masking.

Inputs are made with numpy from a seed and fed to both; the JAX modules'
flax params become the port's state dicts (``convert.flax_to_state_dict``),
with no renaming.  Widths are small.  Tolerances (float32), as
``test_torch_port_zoo.py``: outputs and scores atol/rtol 1e-5, the loss of
one train step rtol 1e-5 and the updated parameters atol 1e-6, epoch
metrics 1e-4.
"""

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.data.batching import EvalBatcher as JEvalBatcher
from newsreclib_tpu.data.synthetic import make_batch as jmake_batch
from newsreclib_tpu.metrics import collector as jcollector
from newsreclib_tpu.models import factory as jfactory
from newsreclib_tpu.models.components import attention as jattention
from newsreclib_tpu.models.components import click as jclick
from newsreclib_tpu.models.components import losses as jlosses
from newsreclib_tpu.models.components import news as jnews
from newsreclib_tpu.models.components import text as jtext
from newsreclib_tpu.models.components import user as juser
from newsreclib_tpu.models.components import utils as jutils
from newsreclib_tpu.models.general_rec import DKN as JDKN
from newsreclib_tpu.models.general_rec import LSTUR as JLSTUR
from newsreclib_tpu.models.general_rec import MINER as JMINER
from newsreclib_tpu.models.general_rec import NAML as JNAML
from newsreclib_tpu.models.general_rec import NPA as JNPA
from newsreclib_tpu.models.general_rec import TANR as JTANR
from newsreclib_tpu.serving import CachedScorer as JCachedScorer
from newsreclib_tpu.training import state as jstate
from newsreclib_tpu.training import steps as jsteps
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data.batching import EvalBatcher
from newsreclib_tpu_torch.metrics import collector as tcollector
from newsreclib_tpu_torch.models import factory
from newsreclib_tpu_torch.models.base import full_title_tokens
from newsreclib_tpu_torch.models.components import attention, click, news, text, user, utils
from newsreclib_tpu_torch.models.components import losses
from newsreclib_tpu_torch.models.general_rec import DKN, LSTUR, MINER, NAML, NPA, TANR
from newsreclib_tpu_torch.serving import CachedScorer
from newsreclib_tpu_torch.training import state as tstate
from newsreclib_tpu_torch.training import steps as tsteps
from tests.test_torch_port_zoo import (  # noqa: F401  (fixtures)
    CATEGORIES,
    DATA,
    ENTITIES,
    EVAL,
    TITLE,
    TOL,
    VOCAB,
    _hist,
    _np_params,
    _port,
    _t,
    few_torch_threads,
    jax_batch,
    port_batch,
    zoo_store,
)

NUM_USERS = 1000  # the synthetic batches' user ids lie in [1, 1000)

# Small widths of each model, with the JAX constructor's names; the port's
# models take the same keywords.  "train": what turns the model's dropout
# and user masking off for the one-step comparison.
MODELS = {
    "naml": (JNAML, NAML, dict(num_categories=CATEGORIES, text_embed_dim=6, categ_embed_dim=4,
                               num_filters=8, query_dim=4), dict(dropout=0.0)),
    "tanr": (JTANR, TANR, dict(num_categories=CATEGORIES, embed_dim=6, num_heads=2,
                               num_filters=8, query_dim=4), dict(dropout=0.0)),
    "lstur": (JLSTUR, LSTUR, dict(num_users=NUM_USERS, num_categories=CATEGORIES,
                                  text_embed_dim=6, categ_embed_dim=4, num_filters=8,
                                  query_dim=4),
              dict(dropout=0.0, user_masking_probability=0.0)),
    "lstur_con": (JLSTUR, LSTUR, dict(num_users=NUM_USERS, num_categories=CATEGORIES,
                                      text_embed_dim=6, categ_embed_dim=4, num_filters=8,
                                      query_dim=4, long_short_term_method="con"),
                  dict(dropout=0.0, user_masking_probability=0.0)),
    "npa": (JNPA, NPA, dict(num_users=NUM_USERS, text_embed_dim=6, user_embed_dim=5,
                            num_filters=8, word_pref_query_dim=7, news_pref_query_dim=4),
            dict(dropout=0.0)),
    "miner": (JMINER, MINER, dict(num_categories=CATEGORIES, text_embed_dim=6, news_embed_dim=8,
                                  num_heads=2, query_dim=4, categ_embed_dim=5,
                                  num_context_codes=3, context_code_dim=4),
              dict(dropout=0.0)),
    "miner_mean": (JMINER, MINER, dict(num_categories=CATEGORIES, text_embed_dim=6,
                                       news_embed_dim=8, num_heads=2, query_dim=4,
                                       categ_embed_dim=5, num_context_codes=3,
                                       context_code_dim=4, score_type="mean"),
                   dict(dropout=0.0)),
    "miner_max": (JMINER, MINER, dict(num_categories=CATEGORIES, text_embed_dim=6,
                                      news_embed_dim=8, num_heads=2, query_dim=4,
                                      categ_embed_dim=5, num_context_codes=3,
                                      context_code_dim=4, score_type="max"),
                  dict(dropout=0.0)),
    "dkn": (JDKN, DKN, dict(entity_vocab_size=ENTITIES, text_embed_dim=6, entity_embed_dim=4,
                            num_filters=5, window_sizes=(1, 2, 3), hidden_dim_dnn=4), {}),
}
CACHEABLE = ["dkn", "lstur", "lstur_con", "miner", "miner_mean", "naml", "tanr"]
LATE_FUSION = ["dkn", "lstur", "miner", "naml", "npa", "tanr"]


def _apply(jm, params, *args, **kw):
    return np.asarray(jm.apply({"params": params}, *args, **kw))


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("zero_diagonal", [False, True])
def test_pairwise_cosine_similarity_matches_jax(zero_diagonal):
    """Values and the gradient of a weighted sum, with zero vectors among
    the rows (padded articles): they normalise to zero, and the gradient
    stays finite (the root never sees 0)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    y = x if zero_diagonal else rng.normal(size=(3, 5, 4)).astype(np.float32)
    x[0, 2] = 0.0
    x[1] = 0.0
    w = rng.normal(size=(3, 5, 5)).astype(np.float32)

    def jf(a, b):
        return jnp.sum(jutils.pairwise_cosine_similarity(a, b, zero_diagonal) * w)

    want = np.asarray(jutils.pairwise_cosine_similarity(jnp.asarray(x), jnp.asarray(y),
                                                        zero_diagonal))
    want_g = np.asarray(jax.grad(jf)(jnp.asarray(x), jnp.asarray(y)))
    tx = _t(x).requires_grad_()
    got = utils.pairwise_cosine_similarity(tx, _t(y), zero_diagonal)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), want_g, **TOL)
    assert np.isfinite(tx.grad.numpy()).all()
    np.testing.assert_array_equal(got[1].detach().numpy(), 0.0)
    if zero_diagonal:
        np.testing.assert_array_equal(np.diagonal(got.detach().numpy(), axis1=1, axis2=2), 0.0)


def test_pairwise_cosine_similarity_zero_diagonal_needs_square_blocks():
    with pytest.raises(ValueError, match="square"):
        utils.pairwise_cosine_similarity(torch.ones(2, 3, 4), torch.ones(2, 5, 4), True)


def _news(seed=6, u=9):
    b = jmake_batch(np.random.default_rng(seed), batch_size=2, hist_len=4, num_candidates=3,
                    unique_news=u, cfg=DATA)
    return b.news


def test_cnn_add_att_matches_jax():
    n = _news()
    jm = jtext.CNNAddAtt(vocab_size=VOCAB, embed_dim=6, num_filters=8, query_dim=3)
    args = (jnp.asarray(n.title), jnp.asarray(n.title_mask))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = _apply(jm, params, *args)
    tm = _port(text.CNNAddAtt(VOCAB, 6, 8, 3, 3), params)
    with torch.no_grad():
        got = tm(_t(n.title), _t(n.title_mask))
    assert got.shape == (9, 8)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_personalized_attention_matches_jax():
    """A full row, an empty row (zeros out) and prefixes."""
    keys, mask = _hist(seed=1, d=6)
    query = np.random.default_rng(2).normal(size=(4, 5)).astype(np.float32)
    jm = jattention.PersonalizedAttention(6)
    args = (jnp.asarray(query), jnp.asarray(keys), jnp.asarray(mask))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = _apply(jm, params, *args)
    tm = _port(attention.PersonalizedAttention(5, 6), params)
    with torch.no_grad():
        got = tm(_t(query), _t(keys), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[1].numpy(), 0.0)


def test_cnn_pers_att_matches_jax():
    """The word-level query is the (U, Du) input itself: ``query_dim`` of
    the JAX module is unused, its Dense takes Du."""
    n = _news()
    q = np.random.default_rng(3).normal(size=(9, 5)).astype(np.float32)
    jm = jtext.CNNPersAtt(vocab_size=VOCAB, query_dim=11, embed_dim=6, num_filters=8)
    args = (jnp.asarray(n.title), jnp.asarray(q), jnp.asarray(n.title_mask))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = _apply(jm, params, *args)
    tm = _port(text.CNNPersAtt(VOCAB, 5, 6, 8, 3), params)
    with torch.no_grad():
        got = tm(_t(n.title), _t(q), _t(n.title_mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("with_bias", [False, True])
def test_poly_attention_matches_jax(with_bias):
    x, mask = _hist(seed=4, d=6)
    bias = np.random.default_rng(5).normal(size=(4, 10, 3)).astype(np.float32)
    jm = jattention.PolyAttention(num_context_codes=3, context_code_dim=5)
    args = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(bias) if with_bias else None)
    params = jm.init(jax.random.key(0), *args)["params"]
    want = _apply(jm, params, *args)
    tm = _port(attention.PolyAttention(6, 3, 5), params)
    with torch.no_grad():
        got = tm(_t(x), _t(mask), _t(bias) if with_bias else None)
    assert got.shape == (4, 3, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tm.proj.bias is None


def test_poly_attention_context_codes_are_xavier_uniform():
    codes = attention.PolyAttention(8, 64, 200, torch.Generator().manual_seed(0)).context_codes
    limit = np.sqrt(6.0 / (64 + 200))
    assert codes.abs().max().item() <= limit
    assert abs(codes.std().item() - limit / np.sqrt(3)) < 0.03 * limit


def test_target_aware_attention_matches_jax():
    """flax's gelu is the tanh approximation; the exact one differs."""
    rng = np.random.default_rng(6)
    query = rng.normal(size=(3, 4, 6)).astype(np.float32) * 3
    key = rng.normal(size=(3, 5, 6)).astype(np.float32)
    value = rng.normal(size=(3, 5, 4)).astype(np.float32)
    jm = jattention.TargetAwareAttention()
    args = tuple(jnp.asarray(a) for a in (query, key, value))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = _apply(jm, params, *args)
    tm = _port(attention.TargetAwareAttention(6), params)
    with torch.no_grad():
        got = tm(_t(query), _t(key), _t(value))
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("entity_len", [4, 12])
@pytest.mark.parametrize("use_context", [False, True])
def test_kcnn_matches_jax(entity_len, use_context):
    """Entity slots shorter (padded) and longer (cut) than the title of 8,
    with and without the context channel; the 4-D conv kernels map by their
    reversed transpose."""
    rng = np.random.default_rng(7)
    tokens = np.where(np.arange(8)[None] < rng.integers(2, 9, size=(5, 1)),
                      rng.integers(1, VOCAB, size=(5, 8)), 0).astype(np.int32)
    ents = np.where(rng.random((5, entity_len)) < 0.5,
                    rng.integers(1, ENTITIES, size=(5, entity_len)), 0).astype(np.int32)
    jm = jnews.KCNN(word_vocab_size=VOCAB, entity_vocab_size=ENTITIES, word_embed_dim=6,
                    entity_embed_dim=4, num_filters=5, window_sizes=(1, 2, 4),
                    use_context=use_context)
    args = (jnp.asarray(tokens), jnp.asarray(ents), jnp.asarray(tokens != 0))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = _apply(jm, params, *args)
    tm = _port(news.KCNN(VOCAB, ENTITIES, 6, 4, 5, (1, 2, 4), use_context), params)
    assert tuple(tm.conv_w4.weight.shape) == (5, 2 + use_context, 6, 4)
    with torch.no_grad():
        got = tm(_t(tokens), _t(ents), _t(tokens != 0))
    assert got.shape == (5, 15)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dnn_predictor_matches_jax():
    rng = np.random.default_rng(8)
    u, c = (rng.normal(size=(3, 5, 6)).astype(np.float32) for _ in range(2))
    jm = jclick.DNNPredictor(4)
    params = jm.init(jax.random.key(0), jnp.asarray(u), jnp.asarray(c))["params"]
    want = _apply(jm, params, jnp.asarray(u), jnp.asarray(c))
    tm = _port(click.DNNPredictor(6, 4), params)
    with torch.no_grad():
        got = tm(_t(u), _t(c))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------ user encoders

def _user_case(name):
    """(JAX module, port module, extra inputs before/after the history)."""
    rng = np.random.default_rng(9)
    if name == "naml":
        return juser.NAMLUserEncoder(query_dim=3), user.NAMLUserEncoder(8, 3), (), ()
    if name in ("lstur_ini", "lstur_con"):
        method = name[-3:]
        ids = np.array([0, 3, 7, 19], dtype=np.int32)  # user 0: zero long-term vector
        return (juser.LSTURUserEncoder(num_users=20, input_dim=8,
                                       long_short_term_method=method),
                user.LSTURUserEncoder(20, 8, 0.5, method), (ids,), ())
    if name == "npa":
        users = rng.normal(size=(4, 5)).astype(np.float32)
        return (juser.NPAUserEncoder(preference_query_dim=3, num_filters=8),
                user.NPAUserEncoder(5, 3, 8), (), (users,))
    cands = rng.normal(size=(4, 3, 8)).astype(np.float32)
    return juser.DKNUserEncoder(hidden_dim=6), user.DKNUserEncoder(8, 6), (), (cands,)


@pytest.mark.parametrize("name", ["dkn", "lstur_con", "lstur_ini", "naml", "npa"])
def test_user_encoder_matches_jax(name):
    """Deterministic (no dropout, no user masking); histories with a full
    row, an empty row and prefixes."""
    jm, tm, before, after = _user_case(name)
    x, mask = _hist(seed=8)
    jargs = (*map(jnp.asarray, before), jnp.asarray(x), *map(jnp.asarray, after),
             jnp.asarray(mask))
    params = jm.init(jax.random.key(0), *jargs)["params"]
    want = _apply(jm, params, *jargs)
    _port(tm, params)
    with torch.no_grad():
        got = tm(*map(_t, before), _t(x), *map(_t, after), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("p", [0.5, 0.3])
def test_lstur_user_masking_in_training(p):
    """Training mode drops each row's whole long-term vector with
    probability p (one Bernoulli a row, from the generator) and scales kept
    ones by 1 / (1 - p); the same seed gives the same mask.  (Its random
    stream is not JAX's, so only the law is compared.)"""
    n = 20000
    enc = user.LSTURUserEncoder(50, 8, p, "con", torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(0).integers(1, 50, size=n)).int()
    hist = torch.zeros(n, 2, 8)
    mask = torch.zeros(n, 2, dtype=torch.bool)
    with torch.no_grad():
        lt = enc(ids, hist, mask, False, torch.Generator().manual_seed(1))[:, 4:]
        again = enc(ids, hist, mask, False, torch.Generator().manual_seed(1))[:, 4:]
        table = enc.long_term_user_embedding[ids]
    dropped = (lt == 0).all(dim=1)
    assert abs(dropped.float().mean().item() - p) < 0.02
    torch.testing.assert_close(lt[~dropped], table[~dropped] / (1 - p), rtol=1e-6, atol=0)
    assert torch.equal(lt, again)
    with pytest.raises(ValueError, match="generator"):
        enc(ids[:2], hist[:2], mask[:2], False, None)


# ------------------------------------------------------------------ models

def both_models(name, batch, **kw):
    jcls, tcls, dims, _ = MODELS[name]
    jm = jcls(vocab_size=VOCAB, **dims, **kw)
    params = jm.init(jax.random.key(0), batch)["params"]
    tm = tcls(VOCAB, device="cpu", **dims, **kw)
    return jm, params, _port(tm, params)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_scores_match_jax(name, split):
    """Scores and aux terms of the forward (NPA through
    ``full_title_tokens`` on the split batch; MINER with its category
    bias, the batch carrying its news table)."""
    b = jax_batch(seed=11, split=split)
    jm, params, tm = both_models(name, b)
    want, want_aux = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, aux = tm(port_batch(b))
    assert got.shape == (6, 5) and set(aux) == set(want_aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k, v in want_aux.items():
        np.testing.assert_allclose(aux[k].item(), float(v), **TOL, err_msg=k)


def test_full_title_tokens_matches_jax():
    from newsreclib_tpu.models.base import full_title_tokens as jfull_title_tokens

    b = jax_batch(seed=11, split=True)
    for got, want in zip(full_title_tokens(port_batch(b)), jfull_title_tokens(b)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", LATE_FUSION)
def test_late_fusion_scores_match_jax(name):
    b = jax_batch(seed=12)
    jm, params, tm = both_models(name, b, late_fusion=True)
    assert getattr(tm, "user_encoder", None) is None
    want, want_aux = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, aux = tm(port_batch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert set(aux) == set(want_aux)


# Adam's first update is lr * g / (|g| + 1e-8): where a gradient is float32
# rounding noise around zero in both packages (the CE gradient sums to zero
# over a slate, so DKN's click-predictor bias gets none; softmax ignores a
# shift, so an attention scorer's last bias gets none), the update follows
# the noise, JAX's as much as the port's: at |g| = 2e-8 a gradient error of
# 1e-8 moves the update by about 1e-5.  Such elements are held through their
# gradient (atol QUIET_GRAD_ATOL) instead of their update.
NOISE_GRAD = 1e-7
QUIET_GRAD_ATOL = 2e-8


def _gradients(js, ts):
    """The gradients of one step from Adam's first moments (0.1 g after one
    update), JAX's and the port's, by parameter name."""
    mu = next(s.mu for s in jax.tree.leaves(js.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
              if hasattr(s, "mu"))
    want = {k: 10.0 * v.numpy() for k, v in flax_to_state_dict(_np_params(mu)).items()}
    got = {n: 10.0 * ts.opt.state[p]["exp_avg"].numpy() for n, p in ts.model.named_parameters()}
    return got, want


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_adam_step_matches_jax(name, monkeypatch):
    """One train step (CE plus the aux terms, Adam at the configs' lr 1e-4,
    dropout and user masking off) on a length-split batch from the same
    parameters: the loss and the aux terms, and every updated parameter
    (atol 1e-6) but the elements whose gradient is under ``NOISE_GRAD`` in
    both packages, which are held through their gradients; at least a third
    of the elements with a gradient are held through their update.  DKN's
    KCNN dropout is fixed at 0.2 in both packages: it is set to 0 here in
    each (flax's ``Dropout`` replaced by a rate-0 one for this test)."""
    _, _, _, train_kw = MODELS[name]
    if name == "dkn":
        make = flax.linen.Dropout
        monkeypatch.setattr(flax.linen, "Dropout", lambda rate, **kw: make(0.0, **kw))
    b = jax_batch(seed=11, split=True)
    jm, params, tm = both_models(name, b, **train_kw)
    if name == "dkn":
        tm.news_encoder.dropout.rate = 0.0
    js = jstate.create_train_state(jm, b, jax.random.key(0), jstate.make_optimizer(1e-4))
    js = js.replace(params=params)
    ts = tstate.create_train_state(tm.train(), tstate.make_optimizer(1e-4), dropout_seed=0)
    js, jout = jsteps.make_train_step(jlosses.cross_entropy_loss, donate=False)(js, b)
    ts, tout = tsteps.make_train_step(losses.cross_entropy_loss)(ts, port_batch(b))
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=1e-5, err_msg=k)
    got_g, want_g = _gradients(js, ts)
    want = flax_to_state_dict(_np_params(js.params))
    got = ts.model.state_dict()
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


# ----------------------------------------------------------------- serving

@pytest.mark.parametrize("name", CACHEABLE)
def test_cached_scorer_matches_jax(zoo_store, name):
    """Cached serving over a store with abstracts, categories and title
    entities, both length buckets of the corpus encode (DKN's with its
    title-split margin) and LSTUR's user ids.  MINER is served without its
    category bias in both packages: the JAX scorer's step calls
    ``score_with_vectors(batch, news_table)`` with no ``categ_vecs`` on
    batches without a news table (``newsreclib_tpu/serving.py:274-279``)."""
    (jstore, jimp), (store, imp) = zoo_store
    jm, params, tm = both_models(name, jax_batch(seed=14))
    want = JCachedScorer(jm).evaluate(params, jstore, jimp, **EVAL)
    got = CachedScorer(tm, device="cpu").evaluate(store, imp, **EVAL)
    assert set(got) == set(want) and "auc" in got
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


def test_miner_scores_with_the_category_bias_only_with_a_news_table():
    """``score_with_vectors`` adds the bias when the batch carries its news
    table or ``categ_vecs`` is passed, and not otherwise (cached serving),
    as the JAX model; the bias moves the scores."""
    b = jax_batch(seed=15)
    jm, params, tm = both_models("miner", b)
    jb = jax.tree.map(jnp.asarray, b)
    pb = port_batch(b)
    with torch.no_grad():
        vecs = tm.encode_news(pb.news)
        categ = tm.encode_categories(pb.news.category)
        with_news = tm.score_with_vectors(pb, vecs)
        without = tm.score_with_vectors(pb._replace(news=None), vecs)
        with_categ = tm.score_with_vectors(pb._replace(news=None), vecs, categ_vecs=categ)
    jvecs = jm.apply({"params": params}, jb.news, method="encode_news")
    want = _apply(jm, params, jb._replace(news=None), jvecs, method="score_with_vectors")
    np.testing.assert_allclose(without.numpy(), want, **TOL)
    np.testing.assert_allclose(with_news.numpy(), with_categ.numpy(), **TOL)
    assert (with_news - without).abs().max().item() > 0.1 * without.abs().max().item()


def test_npa_eval_step_metrics_match_jax(zoo_store):
    """NPA has no cacheable split, so the trainer evaluates it through
    ``EvalBatcher`` batches and the eval step: the epoch metrics of that
    loop match the JAX package's."""
    (jstore, jimp), (store, imp) = zoo_store
    jm, params, tm = both_models("npa", jax_batch(seed=14))
    assert not hasattr(type(tm), "encode_news")
    js = jstate.create_train_state(jm, jax_batch(seed=14), jax.random.key(0),
                                   jstate.make_optimizer(1e-4)).replace(params=params)
    ts = tstate.create_train_state(tm, tstate.make_optimizer(1e-4))
    kw = dict(max_history_len=8, target_cells=64, u_bucket_min=16, split_title_len=16)
    jstream, tstream = jcollector.StreamingEval(), tcollector.StreamingEval()
    jstep = jsteps.make_eval_step(jlosses.cross_entropy_loss)
    tstep = tsteps.make_eval_step(losses.cross_entropy_loss)
    for jb, tb in zip(JEvalBatcher(jstore, jimp, **kw), EvalBatcher(store, imp, **kw)):
        scores, per_imp, valid, loss = jstep(js, jb)
        jstream.update(scores, per_imp, valid, jb.labels, jb.cand_mask, loss)
        tb = port_batch(tb)
        scores, per_imp, valid, loss = tstep(ts, tb)
        tstream.update(scores, per_imp, valid, tb.labels, tb.cand_mask, loss)
    want, got = jstream.finalize(), tstream.finalize()
    assert set(got) == set(want) and {"auc", "loss"} <= set(got)
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


# ----------------------------------------------------------------- factory

FACTORY_CASES = {
    "naml": {}, "tanr": {}, "lstur": {}, "lstur_con": {"long_short_term_method": "con"},
    "npa": {}, "miner": {}, "miner_mean": {"score_type": "mean"},
    "miner_max": {"score_type": "max"}, "dkn": {},
}


@pytest.mark.parametrize("case", sorted(FACTORY_CASES))
def test_factory_builds_the_jax_models_parameters(case):
    """``build_model`` from the model's config file gives the JAX factory's
    model: the same parameter names and shapes, at the config's widths."""
    from newsreclib_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
    from newsreclib_tpu_torch.config.compose import compose

    cfg = dict(compose(overrides=[f"model={case.split('_')[0]}"])["model"],
               **FACTORY_CASES[case])
    kw = dict(vocab_size=VOCAB, num_categories=CATEGORIES, entity_vocab_size=ENTITIES,
              num_users=NUM_USERS)
    jm = jfactory.build_model(cfg, jfactory.DataInfo(**kw))
    big = JSyntheticConfig(vocab_size=VOCAB, title_len=TITLE, abstract_len=8, entity_len=4,
                           entity_vocab_size=ENTITIES, num_categories=CATEGORIES,
                           num_subcategories=CATEGORIES)
    b = jmake_batch(np.random.default_rng(0), batch_size=2, hist_len=6, num_candidates=3,
                    unique_news=8, cfg=big)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), b))["params"]
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    tm = factory.build_model(cfg, factory.DataInfo(**kw), device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert cfg["name"] in factory.PORTED_MODELS


def test_dkn_title_split_check_refuses_a_short_segment_narrower_than_the_entities(tmp_path):
    """The CLI refuses DKN with ``data.split_title_len`` below
    ``data.max_entities``, with the repository ``train.py``'s message, and
    lets every other model and a wide enough split through."""
    from newsreclib_tpu_torch import train
    from tests.test_torch_port_cli import demo_copy

    train.check_dkn_title_split("dkn", {"split_title_len": 10, "max_entities": 10})
    train.check_dkn_title_split("dkn", {"split_title_len": None, "max_entities": 10})
    train.check_dkn_title_split("nrms", {"split_title_len": 8, "max_entities": 10})
    data = demo_copy(tmp_path / "data")
    with pytest.raises(AssertionError, match=r"DKN needs data.split_title_len \(8\) >= "
                                             r"data.max_entities \(10\); KCNN entity ids"):
        train.main(["experiment=nrms_demo", "model=dkn", "platform=cpu",
                    f"data.data_dir={data}",
                    f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
                    f"output_dir={tmp_path / 'run'}", "data.split_title_len=8"])
