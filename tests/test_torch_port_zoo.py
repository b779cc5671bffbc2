"""MINS, CenNewsRec and CAUM in the port against the JAX package on the CPU:
each shared block (``MaskedGRU``, ``LinearEncoder``, ``DenseAttention``,
``EntityAddAtt``, ``NewsEncoder`` with each combine, ``CNNMHSAAddAtt``),
the three user encoders, each model's scores on plain and length-split
batches, one Adam step, ``CachedScorer`` on a store with abstracts,
categories and title entities, and the factory's routes.

Inputs are made with numpy from a seed and fed to both; the JAX modules'
flax params become the port's state dicts (``convert.flax_to_state_dict``),
with no renaming.  Widths are small (2 heads of a few dims), except one
MINS user encoder at its real shape (6 heads of 50, L = 50).  Tolerances
(float32): outputs and scores atol/rtol 1e-5 (the same arithmetic summed in
another order), the loss of one train step rtol 1e-5 and the updated
parameters atol 1e-6, epoch metrics 1e-4 (means of per-impression values
over float32 sums), as in ``test_torch_port_ops.py`` /
``test_torch_port_train.py`` / ``test_torch_port_serving.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.data.batching import Impressions as JImpressions
from newsreclib_tpu.data.batching import split_news_by_length
from newsreclib_tpu.data.news_store import NewsStore as JNewsStore
from newsreclib_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
from newsreclib_tpu.data.synthetic import make_batch as jmake_batch
from newsreclib_tpu.models import factory as jfactory
from newsreclib_tpu.models.components import attention as jattention
from newsreclib_tpu.models.components import category as jcategory
from newsreclib_tpu.models.components import losses as jlosses
from newsreclib_tpu.models.components import news as jnews
from newsreclib_tpu.models.components import rnn as jrnn
from newsreclib_tpu.models.components import text as jtext
from newsreclib_tpu.models.components import user as juser
from newsreclib_tpu.models.general_rec import CAUM as JCAUM
from newsreclib_tpu.models.general_rec import MINS as JMINS
from newsreclib_tpu.models.general_rec import CenNewsRec as JCenNewsRec
from newsreclib_tpu.serving import CachedScorer as JCachedScorer
from newsreclib_tpu.training import state as jstate
from newsreclib_tpu.training import steps as jsteps
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.data.batching import Impressions
from newsreclib_tpu_torch.data.news_store import NewsStore
from newsreclib_tpu_torch.models import factory
from newsreclib_tpu_torch.models.components import attention, category, news, rnn, text, user
from newsreclib_tpu_torch.models.components import losses
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.general_rec import CAUM, MINS, CenNewsRec
from newsreclib_tpu_torch.ops import mhsa
from newsreclib_tpu_torch.serving import CachedScorer
from newsreclib_tpu_torch.training import state as tstate
from newsreclib_tpu_torch.training import steps as tsteps

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB, ENTITIES, CATEGORIES, TITLE = 300, 40, 6, 24
DATA = JSyntheticConfig(vocab_size=VOCAB, title_len=TITLE, abstract_len=20, entity_len=6,
                        entity_vocab_size=ENTITIES, num_categories=CATEGORIES,
                        num_subcategories=CATEGORIES)

# Small widths of each model, with the JAX constructor's names; the port's
# models take the same keywords.
MODELS = {
    "mins": (JMINS, MINS, dict(num_categories=CATEGORIES, text_embed_dim=12, categ_embed_dim=4,
                               num_heads=2, query_dim=4, num_gru_channels=2)),
    "cen_news_rec": (JCenNewsRec, CenNewsRec, dict(embed_dim=6, num_heads=2, num_filters=8,
                                                   query_dim=4, gru_hidden_dim=8,
                                                   num_recent_news=4)),
    "caum": (JCAUM, CAUM, dict(entity_vocab_size=ENTITIES, num_categories=CATEGORIES,
                               text_embed_dim=6, text_num_heads=2, categ_embed_dim=4,
                               news_embed_dim=8, entity_embed_dim=4, query_dim=4,
                               user_vector_dim=8, num_filters=8, dense_att_hidden_dim1=6,
                               dense_att_hidden_dim2=5)),
}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: the suite runs beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_params(params):
    return jax.tree.map(np.asarray, params)


def _port(module, params):
    """``module`` with the JAX params loaded (every key, no renaming)."""
    module.load_state_dict(flax_to_state_dict(_np_params(params)))
    return module.eval()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _hist(seed, b=4, h=10, d=8):
    """(B, H, D) float32 and a left-aligned mask: one row full, one empty."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, d)).astype(np.float32)
    mask = np.arange(h)[None, :] < rng.integers(1, h + 1, size=(b, 1))
    mask[0] = True
    mask[1] = False
    return x, mask


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("case", ["no_mask", "partial", "fully_masked", "init_h"])
def test_masked_gru_matches_jax(case):
    """flax GRUCell arithmetic with the carry frozen at masked steps: rows
    with a prefix of valid steps, a full row and a fully masked row (which
    keeps its initial carry)."""
    x, mask = _hist(seed=3, d=5)
    rng = np.random.default_rng(4)
    h0 = rng.normal(size=(4, 7)).astype(np.float32) if case == "init_h" else None
    if case == "no_mask":
        mask = None
    elif case == "fully_masked":
        mask[:] = False
    jm = jrnn.MaskedGRU(7)
    jargs = (jnp.asarray(x), None if mask is None else jnp.asarray(mask),
             None if h0 is None else jnp.asarray(h0))
    params = jm.init(jax.random.key(0), *jargs)["params"]
    want = np.asarray(jm.apply({"params": params}, *jargs))
    tm = _port(rnn.MaskedGRU(5, 7), params)
    with torch.no_grad():
        got = tm(_t(x), None if mask is None else _t(mask), None if h0 is None else _t(h0))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if case == "fully_masked":
        np.testing.assert_array_equal(got.numpy(), 0.0)
    assert tm.GRUCell_0.hr.bias is None and tm.GRUCell_0.hn.bias is not None


@pytest.mark.parametrize("linear_transform", [False, True])
def test_linear_encoder_matches_jax(linear_transform):
    ids = np.array([0, 1, 5, 3, 3, 2], dtype=np.int32)
    kw = dict(use_dropout=True, linear_transform=linear_transform,
              output_dim=7 if linear_transform else None)
    jm = jcategory.LinearEncoder(num_categories=CATEGORIES, embed_dim=4, **kw)
    params = jm.init(jax.random.key(0), jnp.asarray(ids))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    tm = _port(category.LinearEncoder(CATEGORIES, 4, **kw), params)
    with torch.no_grad():
        got = tm(_t(ids))
    assert got.shape == want.shape == (6, 7 if linear_transform else 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(got[0].numpy(), 0.0 if not linear_transform else got[0])


def test_dense_attention_matches_jax():
    x = np.random.default_rng(5).normal(size=(3, 4, 10, 9)).astype(np.float32)
    jm = jattention.DenseAttention(6, 5)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = _port(attention.DenseAttention(9, 6, 5), params)
    with torch.no_grad():
        got = tm(_t(x))
    assert got.shape == (3, 4, 10, 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _news(seed=6, u=9):
    b = jmake_batch(np.random.default_rng(seed), batch_size=2, hist_len=4, num_candidates=3,
                    unique_news=u, cfg=DATA)
    return b.news


def test_entity_add_att_matches_jax():
    n = _news()
    jm = jnews.EntityAddAtt(vocab_size=ENTITIES, embed_dim=4, query_dim=3)
    args = (jnp.asarray(n.title_entities), jnp.asarray(n.title_entities_mask))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = _port(news.EntityAddAtt(ENTITIES, 4, 3), params)
    with torch.no_grad():
        got = tm(_t(n.title_entities), _t(n.title_entities_mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


NEWS_ENCODERS = {  # combine: (attributes, linear_transform of the category)
    "add_att": (("title", "abstract", "category"), True),
    "linear": (("title", "category", "subcategory", "title_entities", "abstract_entities"),
               False),
    "concat": (("abstract", "title", "title_entities"), False),
    "single": (("abstract",), False),
}


@pytest.mark.parametrize("combine", sorted(NEWS_ENCODERS))
def test_news_encoder_matches_jax(combine):
    """Every combine, attributes in the JAX order whatever order they are
    listed in, one text encoder shared by title and abstract."""
    attrs, transform = NEWS_ENCODERS[combine]
    n = _news()
    jm = jnews.NewsEncoder(
        attributes2encode=attrs,
        text_encoder=jtext.MHSAAddAtt(vocab_size=VOCAB, embed_dim=6, num_heads=2, query_dim=3),
        category_encoder=jcategory.LinearEncoder(num_categories=CATEGORIES, embed_dim=4,
                                                 use_dropout=False, linear_transform=transform,
                                                 output_dim=6 if transform else None),
        entity_encoder=jnews.EntityAddAtt(vocab_size=ENTITIES, embed_dim=5, query_dim=3),
        combine_type=None if combine == "single" else combine, query_dim=3, output_dim=7)
    jn = jax.tree.map(jnp.asarray, n)
    params = jm.init(jax.random.key(0), jn)["params"]
    want = np.asarray(jm.apply({"params": params}, jn))
    tm = news.NewsEncoder(
        attrs, MHSAAddAtt(VOCAB, 6, 2, 3),
        category.LinearEncoder(CATEGORIES, 4, use_dropout=False, linear_transform=transform,
                               output_dim=6 if transform else None),
        news.EntityAddAtt(ENTITIES, 5, 3), combine_type=None if combine == "single" else combine,
        query_dim=3, output_dim=7, text_dim=6, category_dim=6 if transform else 4, entity_dim=5)
    _port(tm, params)
    with torch.no_grad():
        got = tm(to_device(NewsFeatures(*n), "cpu"))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cnn_mhsa_add_att_matches_jax():
    n = _news()
    jm = jtext.CNNMHSAAddAtt(vocab_size=VOCAB, embed_dim=6, num_filters=8, num_heads=2,
                             query_dim=3)
    args = (jnp.asarray(n.title), jnp.asarray(n.title_mask))
    params = jm.init(jax.random.key(0), *args)["params"]
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = _port(text.CNNMHSAAddAtt(VOCAB, 6, 8, 3, 2, 3), params)
    with torch.no_grad():
        got = tm(_t(n.title), _t(n.title_mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_conv_kernel_maps_by_its_reversed_transpose():
    """flax's Conv kernel (W, in, out) is torch's weight (out, in, W): one
    nonzero tap at window offset w, input channel i, filter o puts x[t + w
    - 1, i] into y[t, o] in both frameworks (SAME padding of 1 for W = 3)."""
    import flax.linen as nn

    x = np.random.default_rng(7).normal(size=(2, 5, 4)).astype(np.float32)
    kernel = np.zeros((3, 4, 6), dtype=np.float32)
    kernel[2, 1, 3] = 1.0
    params = {"kernel": kernel, "bias": np.zeros(6, dtype=np.float32)}
    want = np.asarray(nn.Conv(6, (3,), padding="SAME").apply({"params": params},
                                                             jnp.asarray(x)))
    tm = _port(text.Conv1d(4, 6, 3), params)
    assert tuple(tm.weight.shape) == (6, 4, 3) and tm.weight[3, 1, 2] == 1.0
    with torch.no_grad():
        got = tm(_t(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:, :4, 3], x[:, 1:, 1], **TOL)
    np.testing.assert_array_equal(got[:, 4, 3], 0.0)


# ------------------------------------------------------------ user encoders

def _user_encoders(name):
    """(JAX module, port module, needs candidates) at small widths."""
    if name == "mins":
        return (juser.MINSUserEncoder(news_embed_dim=8, query_dim=3, num_filters=6,
                                      num_gru_channels=2),
                user.MINSUserEncoder(8, 3, 6, 2), False)
    if name == "cen_news_rec":
        return (juser.CenNewsRecUserEncoder(num_filters=8, num_heads=2, query_dim=3,
                                            gru_hidden_dim=8, num_recent_news=4),
                user.CenNewsRecUserEncoder(8, 2, 3, 8, 4), False)
    return (juser.CAUMUserEncoder(news_embed_dim=8, num_filters=6, dense_att_hidden_dim1=5,
                                  dense_att_hidden_dim2=4, user_vector_dim=8, num_heads=2),
            user.CAUMUserEncoder(8, 6, 5, 4, 8, 2), True)


@pytest.mark.parametrize("name", ["caum", "cen_news_rec", "mins"])
def test_user_encoder_matches_jax(name):
    """Histories with a full row, an empty row and prefixes (CAUM's
    neighbour window wraps around the padded history, as ``jnp.roll``)."""
    jm, tm, with_cands = _user_encoders(name)
    x, mask = _hist(seed=8)
    cands = np.random.default_rng(9).normal(size=(4, 3, 8)).astype(np.float32)
    jargs = (jnp.asarray(x), jnp.asarray(cands)) if with_cands else (jnp.asarray(x),)
    params = jm.init(jax.random.key(0), *jargs, jnp.asarray(mask))["params"]
    want = np.asarray(jm.apply({"params": params}, *jargs, jnp.asarray(mask)))
    _port(tm, params)
    targs = (_t(x), _t(cands)) if with_cands else (_t(x),)
    with torch.no_grad():
        got = tm(*targs, _t(mask))
    assert got.shape == want.shape == ((4, 3) if with_cands else (4, 6 if name == "mins" else 8))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_mins_user_encoder_at_head_dim_50():
    """MINS's user encoder at the config's shape: 6 heads of 50 over D =
    300, history 50, which the kernel's wide instances take on the card."""
    assert mhsa.kernel_supports(50, 300, 6, torch.float32)
    x, mask = _hist(seed=10, b=3, h=50, d=300)
    jm = juser.MINSUserEncoder(news_embed_dim=300, query_dim=200, num_filters=300,
                               num_gru_channels=6)
    params = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    tm = _port(user.MINSUserEncoder(300, 200, 300, 6), params)
    with torch.no_grad():
        got = tm(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ------------------------------------------------------------------ models

def jax_batch(seed, split=False, b=6):
    batch = jmake_batch(np.random.default_rng(seed), batch_size=b, hist_len=10,
                        num_candidates=5, unique_news=32, cfg=DATA)
    if split:
        n, n2, hist, cand = split_news_by_length(batch.news, batch.hist_idx, batch.cand_idx, 16,
                                                 min_tail=8)
        assert n2 is not None
        batch = batch._replace(news=n, news2=n2, hist_idx=hist, cand_idx=cand)
    return batch


def port_batch(b) -> RecBatch:
    fields = b._asdict()
    for seg in ("news", "news2"):
        if fields[seg] is not None:
            fields[seg] = NewsFeatures(*fields[seg])
    return to_device(RecBatch(**fields), "cpu")


def both_models(name, batch, **kw):
    jcls, tcls, dims = MODELS[name]
    jm = jcls(vocab_size=VOCAB, **dims, **kw)
    params = jm.init(jax.random.key(0), batch)["params"]
    tm = tcls(VOCAB, device="cpu", **dims, **kw)
    return jm, params, _port(tm, params)


@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_scores_match_jax(name, split):
    b = jax_batch(seed=11, split=split)
    jm, params, tm = both_models(name, b)
    want, _ = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, aux = tm(port_batch(b))
    assert aux == {} and got.shape == (6, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_late_fusion_scores_match_jax(name):
    b = jax_batch(seed=12)
    jm, params, tm = both_models(name, b, late_fusion=True)
    assert tm.user_encoder is None
    want, _ = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, _ = tm(port_batch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_adam_step_matches_jax(name):
    """One train step (CE, Adam at the configs' lr 1e-4, dropout 0) on a
    length-split batch from the same parameters: the loss and every updated
    parameter."""
    b = jax_batch(seed=11, split=True)
    jm, params, tm = both_models(name, b, dropout=0.0)
    js = jstate.create_train_state(jm, b, jax.random.key(0), jstate.make_optimizer(1e-4))
    js = js.replace(params=params)
    ts = tstate.create_train_state(tm.train(), tstate.make_optimizer(1e-4), dropout_seed=0)
    js, jout = jsteps.make_train_step(jlosses.cross_entropy_loss, donate=False)(js, b)
    ts, tout = tsteps.make_train_step(losses.cross_entropy_loss)(ts, port_batch(b))
    np.testing.assert_allclose(tout["loss"].item(), float(jout["loss"]), rtol=1e-5)
    want = flax_to_state_dict(_np_params(js.params))
    got = ts.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, rtol=0, err_msg=k)


# ----------------------------------------------------------------- serving

N_NEWS, N_IMP = 120, 40
EVAL = dict(max_history_len=8, target_cells=64, encode_batch=16)


@pytest.fixture(scope="module")
def zoo_store():
    """A store whose titles take both length buckets of the corpus encode,
    with abstracts, categories, sentiments and title entities; impressions
    that fall in several candidate buckets."""
    rng = np.random.default_rng(0)
    title = np.zeros((N_NEWS + 1, TITLE), dtype=np.int32)
    for i, n in enumerate(rng.integers(3, TITLE + 1, size=N_NEWS)):
        title[i + 1, :n] = rng.integers(1, VOCAB, size=n)
    abstract = np.zeros((N_NEWS + 1, 20), dtype=np.int32)
    for i, n in enumerate(rng.integers(0, 21, size=N_NEWS)):
        abstract[i + 1, :n] = rng.integers(1, VOCAB, size=n)
    ents = np.where(rng.random((N_NEWS + 1, 6)) < 0.4,
                    rng.integers(1, ENTITIES, size=(N_NEWS + 1, 6)), 0).astype(np.int32)
    ents[0] = 0
    arrays = dict(
        nid2row={f"N{i}": i for i in range(1, N_NEWS + 1)}, title=title, abstract=abstract,
        category=np.r_[0, rng.integers(1, CATEGORIES, size=N_NEWS)].astype(np.int32),
        sentiment=np.r_[0, rng.integers(1, 4, size=N_NEWS)].astype(np.int32),
        title_entities=ents,
    )
    hists = [rng.integers(1, N_NEWS + 1, size=int(rng.integers(1, 12))) for _ in range(N_IMP)]
    cands = [rng.integers(1, N_NEWS + 1, size=int(rng.integers(2, 20))) for _ in range(N_IMP)]
    labels = [(rng.random(len(c)) < 0.3).astype(np.int8) for c in cands]
    lists = (hists, cands, labels, np.arange(N_IMP))
    return ((JNewsStore(**arrays), JImpressions.from_lists(*lists)),
            (NewsStore(**arrays), Impressions.from_lists(*lists)))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cached_scorer_matches_jax(zoo_store, name):
    """The corpus encode hands the model every field of the store (MINS
    reads abstracts and categories, CAUM categories and title entities)."""
    (jstore, jimp), (store, imp) = zoo_store
    jm, params, tm = both_models(name, jax_batch(seed=14))
    want = JCachedScorer(jm).evaluate(params, jstore, jimp, **EVAL)
    got = CachedScorer(tm, device="cpu").evaluate(store, imp, **EVAL)
    assert set(got) == set(want) and "auc" in got
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


# ----------------------------------------------------------------- factory

@pytest.mark.parametrize("name", sorted(MODELS))
def test_factory_builds_the_jax_models_parameters(name):
    """``build_model`` from the model's config file gives the JAX factory's
    model: the same parameter names and shapes, at the config's widths."""
    from newsreclib_tpu_torch.config.compose import compose

    cfg = compose(overrides=[f"model={name}"])["model"]
    jinfo = jfactory.DataInfo(vocab_size=VOCAB, num_categories=CATEGORIES,
                              entity_vocab_size=ENTITIES)
    jm = jfactory.build_model(cfg, jinfo)
    big = JSyntheticConfig(vocab_size=VOCAB, title_len=TITLE, abstract_len=8, entity_len=4,
                           entity_vocab_size=ENTITIES, num_categories=CATEGORIES,
                        num_subcategories=CATEGORIES)
    b = jmake_batch(np.random.default_rng(0), batch_size=2, hist_len=6, num_candidates=3,
                    unique_news=8, cfg=big)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), b))["params"]
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    tm = factory.build_model(cfg, factory.DataInfo(vocab_size=VOCAB, num_categories=CATEGORIES,
                                                   entity_vocab_size=ENTITIES), device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want


def test_factory_still_refuses_the_models_not_ported():
    """The PLM text tower is ported: ``use_plm`` now builds every model with
    a route (the zoo's and the FairRec models') with the tower registered
    once, at ``text_encoder_module`` (``tests/test_torch_port_plm.py`` holds
    each route against the JAX package); an unknown model still raises, and
    MANNeR's ``remat`` (ported) builds with the tower registered once."""
    tower = dict(use_plm=True, plm_model="__random_init__", plm_vocab_size=VOCAB, embed_dim=24,
                 plm_num_layers=1, plm_num_heads=2, num_heads=2)
    info = factory.DataInfo(vocab_size=VOCAB, entity_vocab_size=ENTITIES,
                            num_categories=CATEGORIES)
    for name in ("mins", "caum", "sentirec", "manner_cr"):
        m = factory.build_model({"name": name, **tower}, info, device="cpu")
        names = [n for n, _ in m.named_parameters()]
        assert "text_encoder_module.encoder.layer_0.q.weight" in names
        assert not any(".encoder.layer_0." in n and not n.startswith("text_encoder_module.")
                       for n in names)
    with pytest.raises(ValueError, match="unknown model"):
        factory.build_model({"name": "nope", **tower}, info, device="cpu")
    remat = factory.build_model({"name": "manner_cr", "remat": True, **tower}, info,
                                device="cpu")
    assert remat.remat
    names = [n for n, _ in remat.named_parameters()]
    assert sum(".encoder.layer_0.q.weight" in n for n in names) == 1
