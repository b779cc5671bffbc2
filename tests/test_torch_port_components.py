"""Components of the port's NRMS against their JAX counterparts on the CPU:
the JAX module is initialised, its parameters go through ``convert.py`` into
the torch module, and both see the same numpy inputs.

Tolerance: float32 atol/rtol 1e-5 — the same arithmetic in a different
summation order (XLA CPU vs ATen matmuls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.models.components import attention as jatt
from newsreclib_tpu.models.components.embedding import TokenEmbedding as JTokenEmbedding
from newsreclib_tpu.models.components.text import MHSAAddAtt as JMHSAAddAtt
from newsreclib_tpu.models.components.user import NRMSUserEncoder as JNRMSUserEncoder
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.models.components import attention as tatt
from newsreclib_tpu_torch.models.components.click import dot_product_scores
from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding
from newsreclib_tpu_torch.models.components.text import MHSAAddAtt
from newsreclib_tpu_torch.models.components.user import NRMSUserEncoder

TOL = dict(atol=1e-5, rtol=1e-5)


def init_and_load(jax_module, torch_module, *args, seed=0):
    """Init the flax module on ``args``, load its params into the torch
    module; returns (params, torch_module in eval mode)."""
    params = jax_module.init(jax.random.key(seed), *[jnp.asarray(a) for a in args])["params"]
    torch_module.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return params, torch_module.eval()


def run_both(jax_module, params, torch_module, *args):
    want = np.asarray(jax_module.apply({"params": params}, *[jnp.asarray(a) for a in args]))
    with torch.no_grad():
        got = torch_module(*[torch.from_numpy(np.asarray(a)) for a in args]).numpy()
    return got, want


def masked_rows(rng, b, l, fully_masked_row=True):
    lens = rng.integers(1, l + 1, size=b)
    mask = np.arange(l)[None, :] < lens[:, None]
    if fully_masked_row:
        mask[0] = False
    return mask


def tokens(rng, u, l, vocab):
    mask = masked_rows(rng, u, l)
    return np.where(mask, rng.integers(1, vocab, size=(u, l)), 0).astype(np.int32), mask


@pytest.mark.parametrize("pretrained", [False, True])
def test_token_embedding_zeroes_padding(pretrained):
    rng = np.random.default_rng(0)
    table = rng.normal(size=(50, 12)).astype(np.float32) if pretrained else None
    ids, _ = tokens(rng, 6, 9, 50)
    params, tm = init_and_load(JTokenEmbedding(50, 12, table), TokenEmbedding(50, 12, table), ids)
    assert np.any(np.asarray(params["embedding"])[0] != 0)  # row 0 is not zero ...
    got, want = run_both(JTokenEmbedding(50, 12, table), params, tm, ids)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[ids == 0] == 0)  # ... but pad tokens embed to zero


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_softmax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(5, 7)).astype(np.float32)
    mask = masked_rows(rng, 5, 7)
    want = np.asarray(jatt.masked_softmax(jnp.asarray(logits), jnp.asarray(mask)))
    got = tatt.masked_softmax(torch.from_numpy(logits), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0] == 0)


@pytest.mark.parametrize("shape", [(5, 7, 24), (3, 4, 6, 24)])
def test_additive_attention(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape).astype(np.float32)
    mask = masked_rows(rng, int(np.prod(shape[:-2])), shape[-2]).reshape(shape[:-1])
    jm = jatt.AdditiveAttention(query_dim=8)
    params, tm = init_and_load(jm, tatt.AdditiveAttention(24, 8), x, mask)
    got, want = run_both(jm, params, tm, x, mask)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("b,l,d,h", [(4, 9, 32, 4), (6, 16, 300, 15), (3, 50, 60, 3)])
def test_multi_head_self_attention(b, l, d, h):
    rng = np.random.default_rng(b + l)
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    mask = masked_rows(rng, b, l)
    jm = jatt.MultiHeadSelfAttention(num_heads=h)
    params, tm = init_and_load(jm, tatt.MultiHeadSelfAttention(d, h), x, mask)
    got, want = run_both(jm, params, tm, x, mask)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[~mask] == 0)


def test_multi_head_self_attention_leading_dims_and_no_mask():
    """Leading dims are flattened into the kernel's sequence axis; no mask
    means every key is valid."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 3, 5, 24)).astype(np.float32)
    jm = jatt.MultiHeadSelfAttention(num_heads=4)
    params, tm = init_and_load(jm, tatt.MultiHeadSelfAttention(24, 4), x)
    got, want = run_both(jm, params, tm, x)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("u,l", [(12, 16), (7, 30)])
def test_mhsa_addatt_text_encoder(u, l):
    rng = np.random.default_rng(u)
    ids, mask = tokens(rng, u, l, 100)
    jm = JMHSAAddAtt(vocab_size=100, embed_dim=60, num_heads=6, query_dim=16)
    params, tm = init_and_load(jm, MHSAAddAtt(100, 60, 6, 16), ids, mask)
    got, want = run_both(jm, params, tm, ids, mask)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[0] == 0)  # the padding article encodes to zero


@pytest.mark.parametrize("b,hist", [(4, 8), (3, 50)])
def test_nrms_user_encoder(b, hist):
    rng = np.random.default_rng(hist)
    x = rng.normal(size=(b, hist, 60)).astype(np.float32)
    mask = masked_rows(rng, b, hist, fully_masked_row=False)
    jm = JNRMSUserEncoder(num_heads=6, query_dim=16)
    params, tm = init_and_load(jm, NRMSUserEncoder(60, 6, 16), x, mask)
    got, want = run_both(jm, params, tm, x, mask)
    np.testing.assert_allclose(got, want, **TOL)


def test_dot_product_scores():
    from newsreclib_tpu.models.components.click import dot_product_scores as jscores

    rng = np.random.default_rng(0)
    user = rng.normal(size=(4, 24)).astype(np.float32)
    cand = rng.normal(size=(4, 6, 24)).astype(np.float32)
    want = np.asarray(jscores(jnp.asarray(user), jnp.asarray(cand)))
    got = dot_product_scores(torch.from_numpy(user), torch.from_numpy(cand)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_init_is_seeded_and_flax_shaped():
    """Weights come from the explicit generator, lecun-normal kernels
    truncated at 2 std, zero biases, query in [-0.1, 0.1]."""
    def build(seed):
        return NRMSUserEncoder(300, 15, 200, torch.Generator().manual_seed(seed))

    a, b, c = build(0), build(0), build(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb), name
        if "bias" not in name:
            assert not torch.equal(pa, pc), name
    w = a.mhsa.qkv.weight
    std = (1 / 300) ** 0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std + 1e-6
    assert abs(w.std().item() - (1 / 300) ** 0.5) < 0.05 * (1 / 300) ** 0.5
    assert torch.all(a.mhsa.qkv.bias == 0)
    assert a.add_att.query.abs().max() <= 0.1
