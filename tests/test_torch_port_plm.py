"""The PLM text tower in the port against the JAX package on the CPU:
checkpoint loading (``load_hf_torch_weights`` on Bert / RoBERTa
directories in both serializations and with a base-model prefix, the
safetensors reader against the ``safetensors`` library, ``save_as_hf_bert``
both ways), ``TransformerEncoder`` and ``PLMTextEncoder`` (head, CLS
pooling, ``reduce_dim``, ragged masks), the random-init draws against
flax's, NRMS with the tower (scores, one Adam step, ``CachedScorer``, layer
freezing through both packages' ``build_optimizer``), and one case per
other ``use_plm`` route of the factories (scores and one step).

The checkpoints are tiny ``BertModel`` / ``RobertaModel`` directories made
here with ``transformers`` from a torch seed; inputs are made with numpy
from a seed.  The JAX towers run unpacked (``pack_to=0``): packing changes
only the all-padding rows, which both packages mask downstream.  JAX params
become the port's state dicts (``convert.flax_to_state_dict``), with no
renaming: a model's tower sits at ``text_encoder_module`` in both.
Tolerances (float32), as the zoo tests': weights exact; outputs and scores
atol/rtol 1e-5; the loss of one step rtol 1e-5 and updated parameters atol
1e-6 (elements whose gradient is float32 noise in both packages held
through the gradient); epoch metrics 1e-4; frozen parameters bit for bit.
"""

import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # the repository's train.py

import train as jtrain  # noqa: E402
from newsreclib_tpu.data.batching import split_news_by_length  # noqa: E402
from newsreclib_tpu.data.synthetic import make_batch as jmake_batch  # noqa: E402
from newsreclib_tpu.models import factory as jfactory  # noqa: E402
from newsreclib_tpu.models import fair_rec as jfair  # noqa: E402
from newsreclib_tpu.models.components import losses as jlosses  # noqa: E402
from newsreclib_tpu.models.components import plm as jplm  # noqa: E402
from newsreclib_tpu.serving import CachedScorer as JCachedScorer  # noqa: E402
from newsreclib_tpu.training import aspect as jaspect  # noqa: E402
from newsreclib_tpu.training import state as jstate  # noqa: E402
from newsreclib_tpu.training import steps as jsteps  # noqa: E402
from newsreclib_tpu_torch import train as ttrain  # noqa: E402
from newsreclib_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from newsreclib_tpu_torch.data.batch import NewsFeatures, to_device  # noqa: E402
from newsreclib_tpu_torch.models import factory, fair_rec  # noqa: E402
from newsreclib_tpu_torch.models.components import losses, plm  # noqa: E402
from newsreclib_tpu_torch.serving import CachedScorer  # noqa: E402
from newsreclib_tpu_torch.training import aspect  # noqa: E402
from newsreclib_tpu_torch.training import state as tstate  # noqa: E402
from newsreclib_tpu_torch.training import steps as tsteps  # noqa: E402
from tests.test_torch_port_zoo2 import NOISE_GRAD, QUIET_GRAD_ATOL  # noqa: E402
from tests.test_torch_port_zoo import (  # noqa: E402, F401  (fixtures)
    CATEGORIES,
    DATA,
    ENTITIES,
    EVAL,
    TITLE,
    TOL,
    VOCAB,
    _np_params,
    _port,
    _t,
    few_torch_threads,
    port_batch,
    zoo_store,
)

HIDDEN, LAYERS, TOWER_HEADS, FFN, MAX_POS = 32, 2, 4, 64, 64
HEAD_HEADS, QUERY = 2, 8


def _hf_model(kind: str, dropout: float = 0.1, vocab: int = VOCAB):
    """A tiny Hugging Face model of ``kind`` (bert, roberta, bert_mlm,
    roberta_mlm) from torch seed 0."""
    import transformers as tf

    torch.manual_seed(0)
    kw = dict(vocab_size=vocab, hidden_size=HIDDEN, num_hidden_layers=LAYERS,
              num_attention_heads=TOWER_HEADS, intermediate_size=FFN,
              max_position_embeddings=MAX_POS, hidden_dropout_prob=dropout,
              attention_probs_dropout_prob=dropout)
    if kind.startswith("roberta"):
        cfg = tf.RobertaConfig(pad_token_id=1, **kw)
        return (tf.RobertaForMaskedLM if kind.endswith("mlm") else tf.RobertaModel)(cfg)
    cfg = tf.BertConfig(**kw)
    return (tf.BertForMaskedLM if kind.endswith("mlm") else tf.BertModel)(cfg)


CHECKPOINTS = ["bert-bin", "bert-safetensors", "roberta-bin", "roberta-safetensors",
               "bert_mlm-safetensors", "roberta_mlm-bin"]


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """Checkpoint directories by ``<kind>-<serialization>``, and ``train``:
    a Bert directory without dropout at the zoo's vocabulary, for the
    models' train steps."""
    root = tmp_path_factory.mktemp("hf")
    dirs = {}
    for case in CHECKPOINTS:
        kind, fmt = case.split("-")
        dirs[case] = str(root / case)
        _hf_model(kind).save_pretrained(dirs[case], safe_serialization=fmt == "safetensors")
    dirs["train"] = str(root / "train")
    _hf_model("bert", dropout=0.0).save_pretrained(dirs["train"], safe_serialization=False)
    return dirs


def _jax_state(jparams) -> dict:
    return flax_to_state_dict(_np_params(jparams))


def _structurally_zero(name: str, shape) -> np.ndarray:
    """Elements whose gradient is 0 but for float32 noise: a key bias adds
    the same q . b to every logit of a query's row, which the softmax
    cancels (the key third of an MHSA's ``qkv`` bias, a tower layer's
    ``k.bias``)."""
    zero = np.zeros(shape, dtype=bool)
    if name.endswith("qkv.bias"):
        n = shape[0] // 3
        zero[n:2 * n] = True
    elif name.endswith(".k.bias"):
        zero[:] = True
    return zero


def assert_same_update(jparams, jopt_state, model, opt, frozen=()):
    """Every updated parameter but ``frozen`` within atol 1e-6 of JAX's,
    as ``test_torch_port_fair.assert_same_update``; the elements whose
    gradient is float32 noise in both packages (under ``NOISE_GRAD``, or
    structurally 0: ``_structurally_zero``) are held through their gradient
    instead, which Adam's first moment gives (0.1 g after one update): the
    noise at ``QUIET_GRAD_ATOL``, the structural zeros under 1e-7 of the
    largest gradient (SupCon's 1 / temperature scales the noise up)."""
    mu = next(s.mu for s in jax.tree.leaves(jopt_state, is_leaf=lambda x: hasattr(x, "mu"))
              if hasattr(s, "mu"))
    params = dict(model.named_parameters())
    trained = [k for k in params if k not in frozen]
    want_g = {k: 10.0 * v.numpy() for k, v in flax_to_state_dict(_np_params(mu)).items()
              if k in trained}
    got_g = {k: 10.0 * opt.state[params[k]]["exp_avg"].numpy() for k in trained}
    want, got = _jax_state(jparams), model.state_dict()
    assert set(got_g) == set(want_g) == set(trained)
    top = max(np.abs(g).max() for g in want_g.values())
    held = total = 0
    for k in trained:
        g, w = got_g[k], want_g[k]
        zero = _structurally_zero(k, g.shape)
        quiet = ((np.abs(g) < NOISE_GRAD) & (np.abs(w) < NOISE_GRAD)) | zero
        np.testing.assert_allclose(got[k].numpy()[~quiet], want[k].numpy()[~quiet], atol=1e-6,
                                   rtol=0, err_msg=k)
        noise = quiet & ~zero
        np.testing.assert_allclose(g[noise], w[noise], atol=QUIET_GRAD_ATOL, rtol=0, err_msg=k)
        assert np.abs(g[zero]).max(initial=0) < 1e-7 * top, k
        assert np.abs(w[zero]).max(initial=0) < 1e-7 * top, k
        held += int((~quiet).sum())
        total += int(((g != 0) | (w != 0)).sum())
    assert held >= total / 3, (held, total)


def assert_same_tensors(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


# ------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("case", CHECKPOINTS)
def test_load_hf_weights_matches_jax(hf_dirs, case):
    """The port's loader gives the JAX loader's weights exactly (JAX reads
    through ``AutoModel``, which strips ``bert.`` / ``roberta.`` and drops the
    heads) and the same encoder keywords (RoBERTa's positions from 2)."""
    jparams, jkw = jplm.load_hf_torch_weights(hf_dirs[case])
    state, kw = plm.load_hf_torch_weights(hf_dirs[case])
    assert kw == jkw
    assert kw["position_offset"] == (2 if case.startswith("roberta") else 0)
    assert_same_tensors(state, _jax_state(jparams))


@pytest.mark.parametrize("case", ["bert", "roberta_mlm", "dtypes"])
def test_safetensors_reader_matches_the_library(hf_dirs, tmp_path, case):
    """``read_safetensors`` against ``safetensors.torch.load_file``: names,
    dtypes and values, on saved models and on a file of every common dtype
    (and an empty tensor)."""
    from safetensors.torch import load_file, save_file

    if case == "dtypes":
        g = torch.Generator().manual_seed(0)
        tensors = {"f32": torch.randn(3, 5, generator=g), "f16": torch.randn(7, generator=g).half(),
                   "bf16": torch.randn(2, 2, 3, generator=g).bfloat16(),
                   "f64": torch.randn(4, generator=g).double(),
                   "i64": torch.arange(5), "i32": torch.arange(3, dtype=torch.int32),
                   "u8": torch.arange(9, dtype=torch.uint8), "b": torch.tensor([True, False]),
                   "empty": torch.zeros(0, 4)}
        path = str(tmp_path / "t.safetensors")
        save_file(tensors, path, metadata={"format": "pt"})
    else:
        kind = "bert-safetensors" if case == "bert" else "roberta_mlm-bin"
        d = tmp_path / case
        _hf_model(kind.split("-")[0]).save_pretrained(str(d), safe_serialization=True)
        path = str(d / "model.safetensors")
    assert_same_tensors(plm.read_safetensors(path), load_file(path))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_save_as_hf_bert_round_trips(hf_dirs, tmp_path, direction):
    """What one package's ``save_as_hf_bert`` writes, the other package's
    ``load_hf_torch_weights`` reads back exactly, with the same keywords."""
    jparams, kw = jplm.load_hf_torch_weights(hf_dirs["roberta-safetensors"])
    state = _jax_state(jparams)
    out = str(tmp_path / direction)
    if direction == "port_to_jax":
        plm.save_as_hf_bert(state, kw, out)
        back, back_kw = jplm.load_hf_torch_weights(out)
        back = _jax_state(back)
    else:
        jplm.save_as_hf_bert(jparams, kw, out)
        back, back_kw = plm.load_hf_torch_weights(out)
    assert_same_tensors(back, state)
    # a BertModel layout: positions from 0 whatever the source's offset
    assert back_kw == dict(kw, position_offset=0, pad_token_id=kw["pad_token_id"])


def test_loader_reads_old_layer_norm_names(hf_dirs, tmp_path):
    """A checkpoint whose LayerNorms use the old ``gamma`` / ``beta`` names
    (as older BERT releases do; ``AutoModel`` renames them) loads as the
    same weights."""
    want, kw = plm.load_hf_torch_weights(hf_dirs["bert-bin"])
    sd = torch.load(os.path.join(hf_dirs["bert-bin"], "pytorch_model.bin"), weights_only=True)
    torch.save({k.replace("LayerNorm.weight", "LayerNorm.gamma").replace("LayerNorm.bias",
                                                                        "LayerNorm.beta"): v
                for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(
        (Path(hf_dirs["bert-bin"]) / "config.json").read_text())
    got, got_kw = plm.load_hf_torch_weights(str(tmp_path))
    assert got_kw == kw
    assert_same_tensors(got, want)


# ------------------------------------------------------------------ towers

def _tokens(seed, u=5, l=12, pad=0, vocab=VOCAB):
    """Ragged token rows: one full, one all padding, the rest of random
    lengths; ids avoid the pad id."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(2, vocab, size=(u, l)).astype(np.int32)
    lengths = rng.integers(1, l + 1, size=u)
    lengths[0], lengths[1] = l, 0
    mask = np.arange(l)[None, :] < lengths[:, None]
    return np.where(mask, tokens, pad).astype(np.int32), mask


@pytest.mark.parametrize("case", ["bert-bin", "roberta-safetensors"])
def test_transformer_encoder_matches_jax(hf_dirs, case):
    jparams, kw = jplm.load_hf_torch_weights(hf_dirs[case])
    tokens, mask = _tokens(1, pad=kw["pad_token_id"])
    want = np.asarray(jplm.TransformerEncoder(**kw).apply(
        {"params": jparams}, jnp.asarray(tokens), jnp.asarray(mask)))
    state, _ = plm.load_hf_torch_weights(hf_dirs[case])
    enc = plm.TransformerEncoder(**kw)
    enc.load_state_dict(state)
    with torch.no_grad():
        got = enc.eval()(_t(tokens), _t(mask))
    assert got.shape == (5, 12, HIDDEN) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("use_mhsa", [True, False], ids=["head", "cls"])
@pytest.mark.parametrize("reduce", [False, True], ids=["", "reduce_dim"])
def test_plm_text_encoder_matches_jax(hf_dirs, use_mhsa, reduce):
    """The PLM-NR head (MHSA of 2 heads of 16, additive attention) or CLS
    pooling, with and without ``reduce_dim`` to 24, over ragged rows (one
    of them all padding)."""
    jparams, kw = jplm.load_hf_torch_weights(hf_dirs["roberta-bin"])
    tokens, mask = _tokens(2, u=6, pad=kw["pad_token_id"])
    head = dict(use_mhsa=use_mhsa, num_heads=HEAD_HEADS, query_dim=QUERY,
                apply_reduce_dim=reduce, reduced_embed_dim=24 if reduce else None)
    jm = jplm.PLMTextEncoder(encoder=jplm.TransformerEncoder(**kw), pack_to=0, **head)
    args = (jnp.asarray(tokens), jnp.asarray(mask))
    params = jm.init(jax.random.key(0), *args)["params"]
    params["encoder"] = jparams
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = _port(plm.PLMTextEncoder(plm.TransformerEncoder(**kw), **head), params)
    with torch.no_grad():
        got = tm(_t(tokens), _t(mask))
    assert got.shape == (6, 24 if reduce else HIDDEN) and tm.out_dim == got.shape[1]
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_random_init_draws_like_flax():
    """At D = 256: the embedding tables N(0, 1/D) untruncated (flax
    ``nn.Embed``; torch's ``nn.Embedding`` is N(0, 1)), Dense kernels
    lecun-normal (truncated at 2 sd), zero biases, LayerNorm scale 1 and
    bias 0, each table's std within 3% of the JAX tower's draw."""
    kw = dict(vocab_size=600, hidden_dim=256, num_layers=1, num_heads=4, intermediate_dim=512,
              max_position=128)
    jp = _jax_state(jplm.TransformerEncoder(**kw).init(
        jax.random.key(0), jnp.ones((2, 8), jnp.int32))["params"])
    tp = plm.TransformerEncoder(**kw, generator=torch.Generator().manual_seed(0)).state_dict()
    assert set(tp) == set(jp)
    for k, v in tp.items():
        assert v.shape == jp[k].shape, k
        leaf = k.rsplit(".", 1)[1]
        if leaf == "bias":
            assert not v.any() and not jp[k].any(), k
        elif leaf == "scale":
            assert bool((v == 1).all()) and bool((jp[k] == 1).all()), k
        elif v.numel() >= 1000:
            np.testing.assert_allclose(v.std().item(), jp[k].std().item(), rtol=0.03, err_msg=k)
    emb = tp["word_embeddings.weight"]
    assert abs(emb.std().item() - 1 / 16) < 0.002
    assert emb.abs().max().item() > 4.0 / 16  # untruncated: beyond 4 sd
    q = tp["layer_0.q.weight"]
    assert abs(q.std().item() - 1 / 16) < 0.003 and q.abs().max().item() <= 2.0 / 16 / 0.8796


def test_freeze_labels_match_jax():
    """``plm_freeze_labels`` over the port's names labels what the JAX one
    labels over the flax tree, with and without the embeddings."""
    cfg = dict(use_plm=True, plm_model="__random_init__", plm_vocab_size=VOCAB,
               embed_dim=HIDDEN, plm_num_layers=3, plm_num_heads=TOWER_HEADS,
               plm_max_position=MAX_POS, num_heads=HEAD_HEADS, query_dim=QUERY, name="nrms")
    b = jax_batch(1)
    jm = jfactory.build_model(cfg, jfactory.DataInfo(vocab_size=VOCAB))
    params = jm.init(jax.random.key(0), b)["params"]
    tm = factory.build_model(cfg, factory.DataInfo(vocab_size=VOCAB), device="cpu")
    for layers, emb in (([0, 2], True), ([1], False), ([], True)):
        want = {k: float(v.item() == 1) for k, v in _jax_state(jax.tree.map(
            lambda lab: np.float32(lab == "freeze"),
            jplm.plm_freeze_labels(params, layers, emb))).items()}
        got = plm.plm_freeze_labels(tm.state_dict(), layers, emb)
        assert {k: float(v == "freeze") for k, v in got.items()} == want
        assert sum(v == "freeze" for v in got.values()) == (
            16 * len(layers) + 5 * emb)


# ------------------------------------------------------------------ models

def jax_batch(seed, split=False, b=4):
    batch = jmake_batch(np.random.default_rng(seed), batch_size=b, hist_len=8,
                        num_candidates=4, unique_news=20, cfg=DATA)
    if split:
        n, n2, hist, cand = split_news_by_length(batch.news, batch.hist_idx, batch.cand_idx, 16,
                                                 min_tail=4)
        assert n2 is not None
        batch = batch._replace(news=n, news2=n2, hist_idx=hist, cand_idx=cand)
    return batch


# each route at small widths; every model takes the tower from ``plm_model``
ROUTES = {
    "nrms": {},
    "naml": dict(categ_embed_dim=5),
    "lstur": dict(categ_embed_dim=5, user_masking_probability=0.0),
    "tanr": {},
    "caum": dict(categ_embed_dim=5, news_embed_dim=12, entity_embed_dim=6,
                 user_vector_dim=12, num_filters=12, dense_att_hidden_dim1=10,
                 dense_att_hidden_dim2=7, text_num_heads=HEAD_HEADS),
    "mins": dict(categ_embed_dim=5, num_gru_channels=2),
    "cen_news_rec": dict(num_recent_news=4),
    "miner": dict(news_embed_dim=12, categ_embed_dim=5, num_context_codes=3,
                  context_code_dim=6),
    "sentirec": {},
    "manner_cr": dict(text_embed_dim=14, entity_embed_dim=6),
    "manner_a": dict(text_embed_dim=14, entity_embed_dim=6),
    "senti_debias": dict(sent_embed_dim=5, discriminator_hidden_dim=7),
}
LOSSES = {"manner_cr": "sup_con_loss"}


def route_cfg(name, hf_dir, **extra):
    return dict(name=name, use_plm=True, plm_model=hf_dir, num_heads=HEAD_HEADS,
                query_dim=QUERY, dropout_probability=0.0, **ROUTES[name], **extra)


def _infos():
    kw = dict(vocab_size=VOCAB, num_users=1000, num_categories=CATEGORIES,
              entity_vocab_size=ENTITIES)
    return jfactory.DataInfo(**kw), factory.DataInfo(**kw)


def both_routes(name, b, hf_dir, **extra):
    """``(JAX model, its params with the ported weights spliced in, the
    port's model with them loaded)`` of ``name``'s factory route; for
    SentiDebias the generators, and the two discriminators as a fourth
    item.  The port's factory must already have loaded the same tower
    weights."""
    cfg = route_cfg(name, hf_dir, **extra)
    jinfo, tinfo = _infos()
    disc = None
    if name == "senti_debias":
        jm, jdisc = jfactory.build_senti_debias(cfg, jinfo)
        tm, tdisc = factory.build_senti_debias(cfg, tinfo, device="cpu")
        params = jm.init(jax.random.key(0), b, method=jfair.SentiDebiasGenerator.full_output)
        disc = (jdisc, jdisc.init(jax.random.key(1), jnp.zeros((1, HIDDEN)))["params"], tdisc)
    elif name == "manner_a":
        jm = jfactory.build_manner_a(cfg, jinfo)
        tm = factory.build_manner_a(cfg, tinfo, device="cpu")
        params = jm.init(jax.random.key(0), b.news)
    else:
        jm = jfactory.build_model(cfg, jinfo)
        tm = factory.build_model(cfg, tinfo, device="cpu")
        params = jm.init(jax.random.key(0), b)
    params = params["params"]
    assert jfactory.splice_plm_params(params, jfactory.take_pending_plm_params()) == 1
    state = _jax_state(params)
    tower = {k: v for k, v in tm.state_dict().items() if ".encoder." in k}
    assert tower and all(k.startswith("text_encoder_module.encoder.") for k in tower)
    assert_same_tensors(tower, {k: state[k] for k in tower})
    tm.load_state_dict(state)
    if disc is not None:
        disc[2].load_state_dict(_jax_state(disc[1]))
        return jm, params, tm.eval(), disc
    return jm, params, tm.eval()


@pytest.mark.parametrize("split", [False, True])
def test_nrms_plm_scores_match_jax(hf_dirs, split):
    b = jax_batch(3, split=split)
    jm, params, tm = both_routes("nrms", b, hf_dirs["train"])
    assert isinstance(tm.news_encoder, plm.PLMTextEncoder)
    assert tm.news_encoder is tm.text_encoder_module
    want, _ = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, _ = tm(port_batch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _one_step(jm, params, tm, b, loss="cross_entropy_loss", jtx=None, ttx=None):
    """One train step of both packages from the same parameters; returns
    the JAX state after it and the port's."""
    jtx = jtx or jstate.make_optimizer(1e-4)
    js = jstate.create_train_state(jm, b, jax.random.key(0), jtx).replace(params=params)
    js = js.replace(opt_state=jtx.init(params))
    ts = tstate.create_train_state(tm.train(), ttx or tstate.make_optimizer(1e-4),
                                   dropout_seed=0)
    jloss = jlosses.get_loss_fn(loss, temperature=0.1)
    tloss = losses.get_loss_fn(loss, temperature=0.1)
    js, jout = jsteps.make_train_step(jloss, donate=False)(js, b)
    ts, tout = tsteps.make_train_step(tloss)(ts, port_batch(b))
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=1e-5, err_msg=k)
    return js, ts


def test_nrms_plm_one_adam_step_matches_jax(hf_dirs):
    """CE, Adam lr 1e-4, dropout off, on a length-split batch: the loss and
    every updated parameter, the tower's included."""
    b = jax_batch(4, split=True)
    jm, params, tm = both_routes("nrms", b, hf_dirs["train"])
    js, ts = _one_step(jm, params, tm, b)
    assert_same_update(js.params, js.opt_state, ts.model, ts.opt)


def test_frozen_layers_step_matches_jax(hf_dirs):
    """``model.frozen_layers: [0]`` with the embeddings frozen (the default),
    through the root ``train.py``'s ``build_optimizer`` and the port's: the
    frozen tensors unchanged bit for bit, the rest JAX's update, and the
    port's frozen parameters out of autograd."""
    b = jax_batch(5, split=True)
    jm, params, tm = both_routes("nrms", b, hf_dirs["train"])
    cfg = {"model": {"use_plm": True, "frozen_layers": [0], "optimizer": {"lr": 1e-4}},
           "trainer": {"max_epochs": 1}}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    js, ts = _one_step(jm, params, tm, b, jtx=jtrain.build_optimizer(cfg)(params),
                       ttx=ttrain.build_optimizer(cfg, 1, tm))
    labels = ts.tx.freeze_labels
    frozen = [k for k, v in labels.items() if v == "freeze"]
    assert len(frozen) == 16 + 5 and all(".layer_0." in k or "_embeddings" in k or "emb_ln" in k
                                         for k in frozen)
    after = ts.model.state_dict()
    want = _jax_state(js.params)
    for k in frozen:
        assert torch.equal(after[k], before[k]) and torch.equal(want[k], before[k]), k
        assert not dict(ts.model.named_parameters())[k].requires_grad
    moved = [k for k in labels if labels[k] == "train" and not torch.equal(after[k], before[k])]
    assert any(".layer_1." in k for k in moved) and any("mhsa" in k for k in moved)
    assert_same_update(js.params, js.opt_state, ts.model, ts.opt, frozen=frozen)


def test_nrms_plm_cached_scorer_matches_jax(hf_dirs, zoo_store):
    """The corpus encode runs the tower over the length-split corpus."""
    (jstore, jimp), (store, imp) = zoo_store
    jm, params, tm = both_routes("nrms", jax_batch(6), hf_dirs["train"])
    want = JCachedScorer(jm).evaluate(params, jstore, jimp, **EVAL)
    got = CachedScorer(tm, device="cpu").evaluate(store, imp, **EVAL)
    assert set(got) == set(want) and "auc" in got
    for k in want:
        assert abs(got[k] - want[k]) < 1e-4, (k, got[k], want[k])


OTHER_ROUTES = sorted(set(ROUTES) - {"nrms"})


@pytest.mark.parametrize("name", OTHER_ROUTES)
def test_plm_route_matches_jax(hf_dirs, name):
    """Each other ``use_plm`` route of the factories at the tiny tower
    (2 layers, 32 wide, loaded from a checkpoint directory): the forward
    (scores; the A-module's embeddings; SentiDebias's ``full_output``)
    and one step (the config loss and Adam lr 1e-4; the A-module's SupCon
    step; SentiDebias's alternating step), dropout and LSTUR's user masking
    off."""
    b = jax_batch(7, split=True)
    if name == "senti_debias":
        jm, params, tm, (jdisc, dparams, tdisc) = both_routes(name, b, hf_dirs["train"])
        out = jm.apply({"params": params}, b, method=jfair.SentiDebiasGenerator.full_output)
        with torch.no_grad():
            got = tm.full_output(port_batch(b))
        assert set(got) == set(out)
        for k, v in out.items():
            np.testing.assert_allclose(np.asarray(got[k], dtype=np.float64),
                                       np.asarray(v, dtype=np.float64), **TOL, err_msg=k)
        js = jfair.create_sentidebias_state(jm, jdisc, b, jax.random.key(0), g_lr=1e-4,
                                            d_lr=2e-4)
        js = js._replace(g=js.g.replace(params=params), d=js.d.replace(params=dparams))
        ts = fair_rec.create_sentidebias_state(tm.train(), tdisc.train(), g_lr=1e-4, d_lr=2e-4)
        js, jout = jfair.make_sentidebias_train_step(0.15, 10.0)(js, b)
        ts, tout = fair_rec.make_sentidebias_train_step(0.15, 10.0)(ts, port_batch(b))
        for k in jout:
            np.testing.assert_allclose(tout[k].item(), float(jout[k]), rtol=1e-5, err_msg=k)
        assert_same_update(js.g.params, js.g.opt_state, ts.g.model, ts.g.opt)
        assert_same_update(js.d.params, js.d.opt_state, ts.d.model, ts.d.opt)
        return
    if name == "manner_a":
        jm, params, tm = both_routes(name, b, hf_dirs["train"])
        want = np.asarray(jm.apply({"params": params}, b.news))
        with torch.no_grad():
            got = tm(to_device(NewsFeatures(*b.news), "cpu"))
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        nb = _news_batch(b)
        jtx = jstate.make_optimizer(1e-4)
        js = jstate.TrainState.create(apply_fn=jm.apply, params=params, tx=jtx,
                                      dropout_rng=jax.random.key(1))
        js, jout = jaspect.make_aspect_train_step(0.1)(js, nb[0])
        ts = tstate.create_train_state(tm.train(), tstate.make_optimizer(1e-4))
        ts, tout = aspect.make_aspect_train_step(0.1)(ts, nb[1])
        np.testing.assert_allclose(tout["loss"].item(), float(jout["loss"]), rtol=1e-5)
        assert_same_update(js.params, js.opt_state, ts.model, ts.opt)
        return
    jm, params, tm = both_routes(name, b, hf_dirs["train"])
    want, _ = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    with torch.no_grad():
        got, _ = tm(port_batch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    js, ts = _one_step(jm, params, tm, b, loss=LOSSES.get(name, "cross_entropy_loss"))
    assert_same_update(js.params, js.opt_state, ts.model, ts.opt)


def _news_batch(b):
    """An A-module batch (JAX, port) of the batch's first news segment, its
    category as the aspect label."""
    from newsreclib_tpu.data.batch import NewsBatch as JNewsBatch
    from newsreclib_tpu_torch.data.batch import NewsBatch

    news = b.news
    labels = np.asarray(news.category)
    valid = np.arange(len(labels)) > 0
    jb = JNewsBatch(news=news, labels=labels, valid=valid)
    return jb, to_device(NewsBatch(news=NewsFeatures(*news), labels=labels, valid=valid), "cpu")


def test_factory_random_init_builds_the_jax_parameters():
    """Without a checkpoint directory (``__random_init__``, a hub name) the
    tower is drawn at random at the config's widths, with the JAX factory's
    defaults (FFN 4 x width): the parameter names and shapes of the JAX
    factory's model, for the roberta-base-width NRMS of
    ``nrms_statfix_plm_supconloss`` at two layers."""
    from newsreclib_tpu_torch.config.compose import compose

    cfg = compose(overrides=["experiment=nrms_statfix_plm_supconloss",
                             "model.plm_num_layers=2"])["model"]
    assert cfg["plm_model"] == "roberta-base" and cfg["embed_dim"] == 768
    jinfo, tinfo = _infos()
    jm = jfactory.build_model(cfg, jinfo)
    assert jfactory.take_pending_plm_params() is None
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jax_batch(8)))["params"]
    want = {k: tuple(v.shape) for k, v in flax_to_state_dict(
        jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)).items()}
    tm = factory.build_model(cfg, tinfo, device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want
    assert got["text_encoder_module.encoder.layer_1.ff1.weight"] == (3072, 768)
    assert tm.user_encoder.mhsa.num_heads == 16


def test_cli_trains_nrms_with_the_plm_tower_on_the_cpu(tmp_path):
    """``python -m newsreclib_tpu_torch.train`` with ``model.use_plm=true``
    on a copy of the demo data: a random one-layer tower (16 wide), layer 0
    and the embeddings frozen; metrics finite, the frozen tensors of the
    best checkpoint equal to the initial tower's (same seed), a moved head;
    then ``python -m newsreclib_tpu_torch.eval ckpt_path=...`` gives the
    run's ``test/auc``."""
    from tests.test_torch_port_cli import demo_copy

    data = demo_copy(tmp_path / "data")
    out = tmp_path / "run"
    args = ["experiment=nrms_demo", "platform=cpu", f"data.data_dir={data}",
            f"data.word_embeddings_fpath={data / 'glove_demo.txt'}", f"output_dir={out}",
            "trainer.max_epochs=1", "trainer.limit_train_batches=3", "model.use_plm=true",
            "model.plm_model=__random_init__", "model.plm_vocab_size=60000",
            "model.embed_dim=16", "model.plm_num_layers=1", "model.plm_num_heads=2",
            "model.num_heads=2", "model.frozen_layers=[0]"]
    metrics = ttrain.main(args)
    assert {"val/auc", "test/auc", "test/loss"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    cfg = ttrain.compose(ttrain.CONFIG_DIR, "train", [*ttrain.DEFAULT_OVERRIDES, *args])
    fresh = factory.build_model(cfg["model"], factory.DataInfo(vocab_size=60000), device="cpu",
                                seed=cfg.get("seed", 0))
    saved = torch.load(out / "checkpoints" / "best.pt", weights_only=True)["params"]
    init = fresh.state_dict()
    frozen = [k for k in init if ".layer_0." in k or "_embeddings" in k or "emb_ln" in k]
    assert len(frozen) == 16 + 5
    for k in frozen:
        assert torch.equal(saved[k], init[k]), k
    assert not torch.equal(saved["text_encoder_module.add_att.query"],
                           init["text_encoder_module.add_att.query"])
    # the port's eval.py restores the PLM model from the run's checkpoints
    from newsreclib_tpu_torch import eval as teval

    again = teval.main([a for a in args if not a.startswith(("output_dir", "trainer."))]
                       + [f"ckpt_path={out / 'checkpoints'}", f"output_dir={tmp_path / 'eval'}"])
    assert abs(again["test/auc"] - metrics["test/auc"]) < 1e-6
