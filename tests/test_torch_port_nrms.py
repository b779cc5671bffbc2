"""The port's NRMS forward against JAX ``NRMS.apply`` on ``make_batch``
batches: unsplit and length-split news tables, late fusion on and off, and
against the JAX model's packed titles (``pack_titles``), which is exact.

Tolerance: float32 atol/rtol 1e-5 on scores — the same arithmetic summed in
another order.
"""

import jax
import numpy as np
import pytest
import torch

from newsreclib_tpu.data.batching import split_news_by_length
from newsreclib_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
from newsreclib_tpu.data.synthetic import make_batch as jmake_batch
from newsreclib_tpu.models.general_rec import NRMS as JNRMS
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data import synthetic
from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.models.general_rec import NRMS

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB, TITLE = 300, 24
DIMS = dict(embed_dim=60, num_heads=6, query_dim=16)


def jax_batch(seed, split=False, unique_news=32):
    cfg = JSyntheticConfig(vocab_size=VOCAB, title_len=TITLE)
    b = jmake_batch(np.random.default_rng(seed), batch_size=6, hist_len=10,
                    num_candidates=5, unique_news=unique_news, cfg=cfg)
    if split:
        news, news2, hist, cand = split_news_by_length(b.news, b.hist_idx, b.cand_idx, 16,
                                                       min_tail=8)
        assert news2 is not None
        b = b._replace(news=news, news2=news2, hist_idx=hist, cand_idx=cand)
    return b


def port_batch(b) -> RecBatch:
    """The JAX package's numpy RecBatch as the port's, on the CPU."""
    fields = b._asdict()
    for seg in ("news", "news2"):
        if fields[seg] is not None:
            fields[seg] = NewsFeatures(*fields[seg])
    return to_device(RecBatch(**fields), "cpu")


def both_models(batch, late_fusion=False, pack_titles=0):
    jm = JNRMS(vocab_size=VOCAB, late_fusion=late_fusion, pack_titles=pack_titles, **DIMS)
    params = jm.init(jax.random.key(0), batch)["params"]
    tm = NRMS(VOCAB, late_fusion=late_fusion, device="cpu", **DIMS).eval()
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


@pytest.mark.parametrize("late_fusion", [False, True])
@pytest.mark.parametrize("split", [False, True])
def test_nrms_forward_matches_jax(split, late_fusion):
    b = jax_batch(seed=3, split=split)
    jm, params, tm = both_models(b, late_fusion)
    want, _ = jm.apply({"params": params}, b, deterministic=True)
    with torch.no_grad():
        got, aux = tm(port_batch(b))
    assert aux == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_nrms_split_equals_unsplit():
    b, sp = jax_batch(seed=4), jax_batch(seed=4, split=True)
    _, _, tm = both_models(b)
    with torch.no_grad():
        np.testing.assert_allclose(tm(port_batch(b))[0].numpy(), tm(port_batch(sp))[0].numpy(),
                                   **TOL)


def test_nrms_matches_jax_packed_titles():
    """The JAX model packs 48 // 24 = 2 titles per attention sequence; the
    port encodes each title alone.  Packing is exact, so they agree."""
    b = jax_batch(seed=5)
    jm, params, tm = both_models(b)
    packed = JNRMS(vocab_size=VOCAB, pack_titles=48, **DIMS)
    want, _ = packed.apply({"params": params}, b, deterministic=True)
    with torch.no_grad():
        got, _ = tm(port_batch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encode_news_and_score_with_vectors_split_the_forward():
    b = jax_batch(seed=6)
    jm, params, tm = both_models(b)
    pb = port_batch(b)
    with torch.no_grad():
        vecs = tm.encode_news(pb.news)
        want = np.asarray(jm.apply({"params": params}, b.news, method="encode_news"))
        np.testing.assert_allclose(vecs.numpy(), want, **TOL)
        np.testing.assert_allclose(tm.score_with_vectors(pb, vecs).numpy(), tm(pb)[0].numpy(),
                                   **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_make_batch_draws_the_same_numbers(seed):
    cfg = dict(vocab_size=VOCAB, title_len=TITLE)
    kw = dict(batch_size=5, hist_len=7, num_candidates=4, unique_news=20, planted_signal=True)
    want = jmake_batch(np.random.default_rng(seed), cfg=JSyntheticConfig(**cfg), **kw)
    got = synthetic.make_batch(np.random.default_rng(seed), cfg=synthetic.SyntheticConfig(**cfg),
                               **kw)
    for name, value in want._asdict().items():
        if name == "news":
            for f, v in value._asdict().items():
                np.testing.assert_array_equal(getattr(got.news, f), v, err_msg=f)
        elif value is not None:
            np.testing.assert_array_equal(getattr(got, name), value, err_msg=name)


def test_nrms_refuses_to_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NRMS(VOCAB, **DIMS)
