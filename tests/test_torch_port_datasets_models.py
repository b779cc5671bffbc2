"""The models on Adressa data and ``CachedScorer.export_recommendations``,
the port against the JAX package on the CPU.

* ``export_recommendations`` for NRMS from ``convert.flax_to_state_dict``
  weights on an Adressa store and its test impressions: the same users and
  candidates as the JAX scorer's export, scores within 1e-5 (float32); in
  bf16 compute within 5e-2 of the JAX scorer's bf16 export and away from
  the float32 scores (the compute type is honoured), both relative to the
  largest score.
* Each GloVe model with an Adressa experiment config (NRMS, NAML, TANR,
  LSTUR, NPA, MINS, CenNewsRec, CAUM, SentiRec, SentiDebias), built by both
  factories from its experiment's model node and the Adressa data info:
  scores and the CE loss on one ``TrainBatcher`` batch of the Adressa store
  within 1e-5 of JAX's from the same parameters, and the port's batcher
  gives the same batch.  An Adressa store has no abstracts and no entities:
  NAML, LSTUR and MINS (``attributes2encode: [title, abstract, category]``)
  and CAUM (``[title, category, title_entities]``) fail on it in both
  packages as their experiment nodes stand, and are held with
  ``attributes2encode`` cut to ``[title, category]``; the port's CLI refuses
  the uncut node with a message (``train.check_store_attributes``).
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.data import adressa as jadressa
from newsreclib_tpu.data.batching import TrainBatcher as JTrainBatcher
from newsreclib_tpu.data.synthetic import SyntheticConfig, make_batch
from newsreclib_tpu.models import factory as jfactory
from newsreclib_tpu.models.components import losses as jlosses
from newsreclib_tpu.models.general_rec import NRMS as JNRMS
from newsreclib_tpu.serving import CachedScorer as JCachedScorer
from newsreclib_tpu_torch.config.compose import compose
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data import adressa, statfix, testing
from newsreclib_tpu_torch.data.batching import TrainBatcher
from newsreclib_tpu_torch.models import factory
from newsreclib_tpu_torch.models.components import losses
from newsreclib_tpu_torch.models.general_rec import NRMS
from newsreclib_tpu_torch.serving import CachedScorer
from newsreclib_tpu_torch.train import check_store_attributes
from tests.test_torch_port_zoo import few_torch_threads, port_batch  # noqa: F401 (fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
DIMS = dict(embed_dim=60, num_heads=6, query_dim=16)
# model name -> the Adressa experiment whose model node builds it
EXPERIMENTS = {
    "nrms": "nrms_adressaoneweek_pretrainedemb_celoss_bertsent",
    "naml": "naml_adressaoneweek_pretrainedemb_celoss_bertsent",
    "tanr": "tanr_adressaoneweek_pretrainedemb_celoss_bertsent",
    "lstur": "lsturini_adressaoneweek_pretrainedemb_celoss_bertsent",
    "npa": "npa_adressaoneweek_pretrainedemb_celoss_bertsent",
    "mins": "mins_adressaoneweek_pretrainedemb_celoss_bertsent",
    "cen_news_rec": "cennewsrec_adressaoneweek_pretrainedemb_celoss_bertsent",
    "caum": "caum_adressaoneweek_pretrainedemb_celoss_bertsent",
    "sentirec": "sentirec_adressaoneweek_pretrainedemb_celoss_bertsent",
    "senti_debias": "sentidebias_adressaoneweek_pretrainedemb_celoss_bertsent",
}
STORE_ATTRIBUTES = ("title", "category", "subcategory")  # what an Adressa store holds
CUT = ("caum", "lstur", "mins", "naml")  # their nodes name fields it lacks


@pytest.fixture(scope="module")
def adressa_data(tmp_path_factory):
    """The JAX and port ``AdressaData`` on copies of a reduced
    ``write_adressa_statfix`` tar, with the MIND fixture's GloVe file."""
    src = tmp_path_factory.mktemp("adressa_src")
    statfix.write_adressa_statfix(str(src), num_news=300, events_per_day=1000)
    testing.write_mind_fixture(str(src / "glove"))
    out = []
    for side, module in (("jax", jadressa), ("port", adressa)):
        d = tmp_path_factory.mktemp(f"adressa_{side}")
        shutil.copy(src / "one_week.tar.gz", d)
        out.append(module.AdressaData(module.AdressaConfig(
            data_dir=str(d), word_embeddings_fpath=str(src / "glove" / "glove_demo.txt"))))
    return out


def _nrms_pair(vocab: int):
    jm = JNRMS(vocab_size=vocab, **DIMS)
    b = make_batch(np.random.default_rng(0), batch_size=2, hist_len=4, num_candidates=3,
                   unique_news=8, cfg=SyntheticConfig(vocab_size=vocab, title_len=30))
    params = jm.init(jax.random.key(0), b)["params"]
    tm = NRMS(vocab, device="cpu", **DIMS).eval()
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _flatten(recs):
    return {(u, n): s for u, scores in recs.items() for n, s in scores.items()}


def test_export_recommendations_matches_jax(adressa_data, tmp_path):
    jdata, tdata = adressa_data
    jm, params, tm = _nrms_pair(tdata.vocab_size())
    jstore, jimp = jdata.news_store(), jdata.impressions("test")
    store, imp = tdata.news_store(), tdata.impressions("test")
    kw = dict(max_history_len=20)
    want = JCachedScorer(jm).export_recommendations(params, jstore, jimp,
                                                    str(tmp_path / "jax.json"), **kw)
    got = CachedScorer(tm, device="cpu").export_recommendations(
        store, imp, str(tmp_path / "port.json"), **kw)
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert set(got) == set(want) and all(set(got[u]) == set(want[u]) for u in want)
    # every test impression's candidates are there
    row2nid = {r: n for n, r in store.nid2row.items()}
    for i in range(len(imp)):
        rows, _ = imp.cands(i)
        assert all(row2nid[r] in got[f"U{imp.user_ids[i]}"] for r in rows)
    g, w = _flatten(got), _flatten(want)
    np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], **TOL)

    want16 = _flatten(JCachedScorer(jm, compute_dtype="bfloat16").export_recommendations(
        params, jstore, jimp, str(tmp_path / "jax16.json"), **kw))
    got16 = _flatten(CachedScorer(tm, device="cpu", compute_dtype="bfloat16")
                     .export_recommendations(store, imp, str(tmp_path / "port16.json"), **kw))
    # the random model's scores are small (|s| < 0.01): tolerances relative to them
    scale = max(abs(v) for v in g.values())
    assert set(got16) == set(w)
    np.testing.assert_allclose([got16[k] for k in w], [want16[k] for k in w], rtol=0,
                               atol=5e-2 * scale)
    assert max(abs(got16[k] - g[k]) for k in w) > 1e-3 * scale
    assert next(tm.parameters()).dtype == torch.float32  # the model is not cast in place


@pytest.mark.parametrize("name", sorted(EXPERIMENTS))
def test_models_score_an_adressa_batch_as_jax(adressa_data, name):
    jdata, tdata = adressa_data
    mc = compose(overrides=[f"experiment={EXPERIMENTS[name]}"])["model"]
    assert mc["name"] == name
    absent = [a for a in mc.get("attributes2encode", ()) if a not in STORE_ATTRIBUTES]
    assert bool(absent) == (name in CUT)
    uncut = mc
    if absent:
        with pytest.raises(ValueError, match="attributes2encode"):
            check_store_attributes(mc, tdata.news_store(), "adressa")
        mc = dict(mc, attributes2encode=["title", "category"])
    check_store_attributes(mc, tdata.news_store(), "adressa")
    jinfo, info = jfactory.load_data_info(jdata, mc), factory.load_data_info(tdata, mc)
    kw = dict(batch_size=4, max_history_len=50, neg_sampling_ratio=4, seed=42,
              u_bucket_min=64, split_title_len=16)
    b = next(iter(JTrainBatcher(jdata.news_store(), jdata.impressions("train"), **kw).epoch(0)))
    tb = next(iter(TrainBatcher(tdata.news_store(), tdata.impressions("train"), **kw).epoch(0)))
    for f, v in b._asdict().items():
        if f not in ("news", "news2"):
            np.testing.assert_array_equal(getattr(tb, f), v, err_msg=f)
    assert b.news.abstract is None and b.news.title_entities is None
    if absent:  # the JAX model fails on the store as its node stands
        with pytest.raises(TypeError):
            jfactory.build_model(uncut, jinfo).init(jax.random.key(0), b)
    if name == "senti_debias":
        jm, tm = jfactory.build_senti_debias(mc, jinfo)[0], factory.build_senti_debias(
            mc, info, device="cpu")[0]
    else:
        jm, tm = jfactory.build_model(mc, jinfo), factory.build_model(mc, info, device="cpu")
    params = jm.init(jax.random.key(0), b)["params"]
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    tm.eval()
    want, _ = jm.apply({"params": params}, jax.tree.map(jnp.asarray, b))
    batch = port_batch(b)
    with torch.no_grad():
        got, _ = tm(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_loss = float(jlosses.cross_entropy_loss(want, b.labels, b.cand_mask,
                                                 b.impression_valid))
    got_loss = losses.cross_entropy_loss(got, batch.labels, batch.cand_mask,
                                         batch.impression_valid).item()
    np.testing.assert_allclose(got_loss, want_loss, **TOL)
