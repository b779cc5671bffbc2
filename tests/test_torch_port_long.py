"""The attention beyond the kernel's earlier box, on the CPU against the JAX
package: sequences longer than 128 and head dims above 128, which the long
instances of ``csrc/mhsa.cu`` take on the card (``mhsa.long_instance``).

* The port's ``fused_small_mhsa`` against the TPU kernel itself (Pallas,
  interpret mode, ``precision=HIGHEST``) at L = 200 and 257 (and head dim
  150), with a fully masked sequence, and ``FusedSmallMHSA``'s gradient
  against ``jax.grad`` of ``mhsa_reference``;
* NRMS at a small width (D = 60, 3 heads) with histories of up to 200
  clicks (``data.max_history_len=200``): scores, the cross-entropy loss and
  one Adam step against the JAX NRMS;
* the routing: which shapes run in the long instances.

The long kernels themselves run on the CPU in ``test_torch_port_emulated.py``
(held against ``mhsa_plain`` / ``mhsa_backward``) and on the card in
``test_torch_port_gpu.py`` and ``chip_smoke.py``.

Tolerances, float32: attention outputs and gradients atol/rtol 1e-5 (the
same sums in another order); NRMS scores atol/rtol 1e-5, loss rtol 1e-5,
updated parameters atol 1e-6, as ``test_torch_port_nrms.py`` and
``test_torch_port_train.py`` hold them at history 10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.lax import Precision

from newsreclib_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
from newsreclib_tpu.data.synthetic import make_batch as jmake_batch
from newsreclib_tpu.models.components import losses as jlosses
from newsreclib_tpu.models.general_rec import NRMS as JNRMS
from newsreclib_tpu.ops.mhsa import fused_small_mhsa as pallas_mhsa
from newsreclib_tpu.ops.mhsa import mhsa_reference
from newsreclib_tpu.training import state as jstate
from newsreclib_tpu.training import steps as jsteps
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.models.components import losses
from newsreclib_tpu_torch.models.general_rec import NRMS
from newsreclib_tpu_torch.ops import mhsa
from newsreclib_tpu_torch.training import state as tstate
from newsreclib_tpu_torch.training import steps as tsteps

TOL = dict(atol=1e-5, rtol=1e-5)
# (U, L, D, heads): NRMS's head dim 20 at L = 200, the PLM head's 48 at
# L = 257 (the last key tile of the kernel partial), head dim 150 at L = 129
LONG_SHAPES = [(4, 200, 60, 3), (3, 257, 96, 2), (3, 129, 300, 2)]
VOCAB, TITLE, HISTORY = 300, 24, 200
DIMS = dict(embed_dim=60, num_heads=3, query_dim=16, dropout=0.0)


def _inputs(u, l, d, seed):
    """qkv ~ N(0, 1); sequence 1 fully masked, sequence 0 with its first key
    alone valid, the others random masks with the first key valid; an
    output gradient ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(u, l, 3 * d)).astype(np.float32)
    mask = rng.random((u, l)) < 0.7
    mask[:, 0] = True
    mask[0, 1:] = False
    mask[1] = False
    w = rng.normal(size=(u, l, d)).astype(np.float32)
    return qkv, mask, w


@pytest.mark.parametrize("u,l,d,h", LONG_SHAPES)
def test_forward_matches_pallas_interpret_beyond_the_box(u, l, d, h):
    """The port's forward (on the CPU, ``mhsa_plain``) against the TPU
    kernel in interpret mode at valid query rows (it leaves masked query
    rows unspecified) and against ``mhsa_reference`` everywhere; the fully
    masked sequence gets the uniform mean of v over all L keys."""
    qkv, mask, _ = _inputs(u, l, d, seed=u * l + d)
    assert mhsa.long_instance(l, d, h)
    assert mhsa.kernel_supports(l, d, h, torch.float32)
    assert mhsa.kernel_supports(l, d, h, torch.bfloat16)
    got = mhsa.fused_small_mhsa(torch.from_numpy(qkv), torch.from_numpy(mask), h).numpy()
    assert np.all(np.isfinite(got))
    want = np.asarray(pallas_mhsa(jnp.asarray(qkv), jnp.asarray(mask), num_heads=h, block_u=8,
                                  interpret=True, precision=Precision.HIGHEST))
    m = mask[..., None]
    np.testing.assert_allclose(got * m, want * m, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(mhsa_reference(jnp.asarray(qkv), jnp.asarray(mask), h)), **TOL)
    np.testing.assert_allclose(got[1], np.broadcast_to(qkv[1, :, 2 * d:].mean(axis=0), (l, d)),
                               **TOL)


@pytest.mark.parametrize("u,l,d,h", LONG_SHAPES)
def test_gradient_matches_jax_grad_beyond_the_box(u, l, d, h):
    """``FusedSmallMHSA``'s backward (on the CPU, ``mhsa_backward``) against
    ``jax.grad`` of ``mhsa_reference``: the fully masked sequence gets no
    gradient on q and k and the mean of dO on v."""
    qkv, mask, w = _inputs(u, l, d, seed=3 * u * l + d)
    want = np.asarray(jax.grad(
        lambda x: (mhsa_reference(x, jnp.asarray(mask), h) * jnp.asarray(w)).sum()
    )(jnp.asarray(qkv)))
    x = torch.from_numpy(qkv).requires_grad_(True)
    (mhsa.FusedSmallMHSA.apply(x, torch.from_numpy(mask), h) * torch.from_numpy(w)).sum().backward()
    got = x.grad.numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[1, :, :2 * d], 0.0)
    np.testing.assert_allclose(got[1, :, 2 * d:], np.broadcast_to(w[1].mean(axis=0), (l, d)),
                               **TOL)


@pytest.mark.parametrize("l,d,h,dtype,long", [
    (200, 300, 15, torch.float32, True), (200, 300, 15, torch.bfloat16, True),
    (256, 768, 16, torch.bfloat16, True), (100, 400, 4, torch.float32, True),
    (200, 300, 2, torch.float32, True), (129, 1024, 1, torch.bfloat16, True),
    (1, 600, 1, torch.float32, True), (128, 64, 1, torch.float32, False),
    (64, 128, 1, torch.bfloat16, False), (50, 300, 15, torch.float32, False),
    (96, 768, 16, torch.bfloat16, False), (50, 400, 4, torch.float32, False)])
def test_routing_to_the_long_instances(l, d, h, dtype, long):
    """Every shape outside the box (L above 128, head dims above 64 at L
    above 64, head dims above 128) runs in the long instances, in either
    type; every shape inside keeps its narrow or wide instance."""
    assert mhsa.long_instance(l, d, h) == long
    assert mhsa.kernel_supports(l, d, h, dtype)
    if long:
        assert not mhsa.wide_instance(l, d, h, dtype)


def jax_batch(seed):
    """A make_batch batch with histories of 1 to 200 clicks, one candidate
    slot and the last impression invalid (as test_torch_port_train.py)."""
    cfg = JSyntheticConfig(vocab_size=VOCAB, title_len=TITLE)
    batch = jmake_batch(np.random.default_rng(seed), batch_size=6, hist_len=HISTORY,
                        num_candidates=5, unique_news=64, cfg=cfg)
    assert batch.hist_mask.sum(axis=1).max() > 128
    cand_mask = batch.cand_mask.copy()
    cand_mask[0, -1] = False
    valid = batch.impression_valid.copy()
    valid[-1] = False
    return batch._replace(cand_mask=cand_mask, impression_valid=valid)


def port_batch(b) -> RecBatch:
    fields = b._asdict()
    fields["news"] = NewsFeatures(*fields["news"])
    return to_device(RecBatch(**fields), "cpu")


def test_nrms_at_history_200_matches_jax():
    """NRMS's scores over histories of up to 200 clicks (the user encoder's
    attention at L = 200), then one Adam step of the cross-entropy loss:
    loss and updated parameters against the JAX NRMS from the same
    parameters and batch, without dropout (the packages draw different
    masks)."""
    b = jax_batch(seed=19)
    jm = JNRMS(vocab_size=VOCAB, **DIMS)
    js = jstate.create_train_state(jm, b, jax.random.key(0), jstate.make_optimizer(1e-4))
    tm = NRMS(VOCAB, device="cpu", **DIMS)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, js.params)))
    ts = tstate.create_train_state(tm, tstate.make_optimizer(1e-4), dropout_seed=0)
    want, _ = jm.apply({"params": js.params}, b, deterministic=True)
    with torch.no_grad():
        got, _ = tm.eval()(port_batch(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    tm.train()
    loss_fn = "cross_entropy_loss"
    js, jmetrics = jsteps.make_train_step(jlosses.get_loss_fn(loss_fn), donate=False)(js, b)
    ts, tmetrics = tsteps.make_train_step(losses.get_loss_fn(loss_fn))(ts, port_batch(b))
    np.testing.assert_allclose(tmetrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    want_params = flax_to_state_dict(jax.tree.map(np.asarray, js.params))
    got_params = ts.model.state_dict()
    assert set(got_params) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got_params[k].numpy(), v.numpy(), atol=1e-6, rtol=0, err_msg=k)
