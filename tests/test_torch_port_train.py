"""The port's training pieces against the JAX package's on the CPU: the
losses, ``make_optimizer`` (schedules, clip, AdamW, freezing), the train and
eval steps, dropout and the planted-signal check.

Inputs are made with numpy from a seed and fed to both.  Models are NRMS at
a small width (D = 60, 6 heads, history 10); the JAX model's flax params
become the port's state dict (``convert.flax_to_state_dict``).  Tolerances
(float32 unless stated): losses atol 1e-6; learning rates rtol 1e-6; one
train step: loss rtol 1e-5, updated params atol 1e-6; three steps in bf16
compute: loss within 2e-2 (bf16 rounds at other places in the two
frameworks); eval scores and metrics atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from newsreclib_tpu.data.batching import split_news_by_length
from newsreclib_tpu.data.synthetic import SyntheticConfig as JSyntheticConfig
from newsreclib_tpu.data.synthetic import make_batch as jmake_batch
from newsreclib_tpu.models import base as jbase
from newsreclib_tpu.models.components import losses as jlosses
from newsreclib_tpu.models.general_rec import NRMS as JNRMS
from newsreclib_tpu.training import state as jstate
from newsreclib_tpu.training import steps as jsteps
from newsreclib_tpu_torch.convert import flax_to_state_dict
from newsreclib_tpu_torch.data.batch import NewsFeatures, RecBatch, to_device
from newsreclib_tpu_torch.models import base
from newsreclib_tpu_torch.models.components import losses
from newsreclib_tpu_torch.models.components.dropout import Dropout, dropout
from newsreclib_tpu_torch.models.components.embedding import TokenEmbedding
from newsreclib_tpu_torch.models.general_rec import NRMS
from newsreclib_tpu_torch.training import state as tstate
from newsreclib_tpu_torch.training import steps as tsteps

VOCAB, TITLE = 300, 24
DIMS = dict(embed_dim=60, num_heads=6, query_dim=16)


# ---------------------------------------------------------------- losses

def _slates(seed, b=7, c=6):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(b, c)).astype(np.float32) * 3
    labels = (rng.random((b, c)) < 0.3).astype(np.float32)
    labels[0] = 0.0  # no positive
    labels[1] = 1.0  # no negative
    mask = rng.random((b, c)) < 0.8
    mask[:, 0] = True
    valid = rng.random(b) < 0.7
    valid[2] = True
    return scores, labels, mask, valid


LOSSES = {
    "cross_entropy_loss": {},
    "sup_con_loss": dict(temperature=0.2),
    "dual_loss": dict(temperature=0.1, dual_loss_coef=0.3),
}


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name, with_mask, with_valid):
    scores, labels, mask, valid = _slates(seed=len(name))
    m = mask if with_mask else None
    v = valid if with_valid else None
    jfn, tfn = jlosses.get_loss_fn(name, **LOSSES[name]), losses.get_loss_fn(name, **LOSSES[name])
    want = jfn(jnp.asarray(scores), jnp.asarray(labels),
               None if m is None else jnp.asarray(m), None if v is None else jnp.asarray(v))
    s = torch.from_numpy(scores).requires_grad_(True)
    got = tfn(s, torch.from_numpy(labels), None if m is None else torch.from_numpy(m),
              None if v is None else torch.from_numpy(v))
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6)
    want_grad = jax.grad(lambda x: jfn(x, jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m),
                                       None if v is None else jnp.asarray(v)))(jnp.asarray(scores))
    got.backward()
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_grad), atol=1e-6)


def test_get_loss_fn_refuses_unknown_names():
    with pytest.raises(ValueError):
        losses.get_loss_fn("hinge")


# ------------------------------------------------------------- optimizer

SCHEDULES = [
    dict(scheduler="cosine", warmup_steps=3, total_steps=10),
    dict(scheduler="cosine", warmup_steps=0, total_steps=6),
    dict(scheduler="cosine", warmup_steps=5, total_steps=2),
    dict(scheduler="linear_warmup", warmup_steps=4),
    dict(scheduler="linear_warmup", warmup_steps=0),
    dict(scheduler=None),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(map(str, kw.values())))
def test_learning_rates_match_optax_schedules(kw):
    lr = 2e-3
    opt = tstate.make_optimizer(lr, **kw)
    if kw["scheduler"] == "cosine":
        sched = optax.warmup_cosine_decay_schedule(
            0.0, lr, kw["warmup_steps"], max(kw["total_steps"], kw["warmup_steps"] + 1))
    elif kw["scheduler"] == "linear_warmup":
        sched = optax.linear_schedule(0.0, lr, max(kw["warmup_steps"], 1))
    else:
        sched = lambda t: lr  # noqa: E731
    for t in range(15):
        np.testing.assert_allclose(opt.lr(t), float(sched(t)), rtol=1e-6, atol=0)
    if kw.get("warmup_steps"):
        assert opt.lr(0) == 0.0


class _Two(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.tensor(a))
        self.b = nn.Parameter(torch.tensor(b))


def _run_both(kw, n_steps=6, grad_scale=1.0, seed=0):
    """n_steps updates of optax's chain and of the port's optimizer on the
    same parameters and gradients; returns both parameter histories."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * grad_scale).astype(np.float32)
              for k, v in params.items()} for _ in range(n_steps)]
    tx = jstate.make_optimizer(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jp)
    model = _Two(params["a"], params["b"])
    spec = tstate.make_optimizer(**kw)
    opt = spec.build(model)
    got, want = [], []
    for step, g in enumerate(grads):
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        want.append({k: np.asarray(v) for k, v in jp.items()})
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(g[name].copy())
        spec.update(opt, step)
        opt.zero_grad(set_to_none=True)
        got.append({k: v.detach().numpy().copy() for k, v in model.named_parameters()})
    return got, want


OPTIMIZERS = {
    "adam": dict(learning_rate=1e-2),
    "cosine_warmup": dict(learning_rate=1e-2, scheduler="cosine", warmup_steps=2, total_steps=5),
    "linear_warmup": dict(learning_rate=1e-2, scheduler="linear_warmup", warmup_steps=3),
    "adamw": dict(learning_rate=1e-2, weight_decay=0.1),
    "adamw_cosine": dict(learning_rate=3e-2, weight_decay=0.5, scheduler="cosine",
                         warmup_steps=1, total_steps=4),
    "clip": dict(learning_rate=1e-2, grad_clip_norm=0.5),
    "freeze": dict(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=0.5,
                   freeze_labels={"a": "freeze", "b": "train"}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    got, want = _run_both(OPTIMIZERS[name])
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=1e-6,
                                       err_msg=f"{name} step {step} {k}")


def test_first_warmup_update_leaves_params_unchanged():
    got, want = _run_both(OPTIMIZERS["cosine_warmup"], n_steps=1)
    _, start = _run_both(dict(learning_rate=0.0), n_steps=1)
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[0][k], start[0][k])


def test_frozen_params_get_no_update_even_with_decay():
    got, _ = _run_both(OPTIMIZERS["freeze"], n_steps=3)
    before, _ = _run_both(dict(learning_rate=0.0), n_steps=1)
    np.testing.assert_array_equal(got[-1]["a"], before[0]["a"])
    assert not np.array_equal(got[-1]["b"], before[0]["b"])


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_clip_matches_optax_clip_by_global_norm(grad_scale):
    rng = np.random.default_rng(5)
    grads = {"a": (rng.normal(size=(3, 4)) * grad_scale).astype(np.float32),
             "b": (rng.normal(size=(5,)) * grad_scale).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(1.0).update(jax.tree.map(jnp.asarray, grads), None)
    model = _Two(np.zeros((3, 4), np.float32), np.zeros(5, np.float32))
    spec = tstate.make_optimizer(learning_rate=0.0, grad_clip_norm=1.0)
    opt = spec.build(model)
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[name].copy())
    spec.update(opt, 0)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]), rtol=1e-6, atol=0)


def test_freeze_labels_must_name_train_or_freeze():
    model = _Two(np.zeros(2, np.float32), np.zeros(2, np.float32))
    with pytest.raises(ValueError):
        tstate.make_optimizer(freeze_labels={"a": "train", "b": "skip"}).build(model)


# ----------------------------------------------------------- train steps

def jax_batch(seed, split=False, planted=False, b=6):
    cfg = JSyntheticConfig(vocab_size=VOCAB, title_len=TITLE)
    batch = jmake_batch(np.random.default_rng(seed), batch_size=b, hist_len=10,
                        num_candidates=5, unique_news=32, cfg=cfg, planted_signal=planted)
    if split:
        news, news2, hist, cand = split_news_by_length(batch.news, batch.hist_idx,
                                                       batch.cand_idx, 16, min_tail=8)
        batch = batch._replace(news=news, news2=news2, hist_idx=hist, cand_idx=cand)
    cand_mask = batch.cand_mask.copy()
    cand_mask[0, -1] = False
    valid = batch.impression_valid.copy()
    valid[-1] = False
    return batch._replace(cand_mask=cand_mask, impression_valid=valid)


def port_batch(b) -> RecBatch:
    fields = b._asdict()
    for seg in ("news", "news2"):
        if fields[seg] is not None:
            fields[seg] = NewsFeatures(*fields[seg])
    return to_device(RecBatch(**fields), "cpu")


def both_states(batch, lr=1e-4, dropout_rate=0.0, **opt_kw):
    jm = JNRMS(vocab_size=VOCAB, dropout=dropout_rate, **DIMS)
    js = jstate.create_train_state(jm, batch, jax.random.key(0),
                                   jstate.make_optimizer(lr, **opt_kw))
    tm = NRMS(VOCAB, dropout=dropout_rate, device="cpu", **DIMS)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, js.params)))
    return js, tstate.create_train_state(tm, tstate.make_optimizer(lr, **opt_kw), dropout_seed=0)


def _params_close(js, ts, atol):
    want = flax_to_state_dict(jax.tree.map(np.asarray, js.params))
    got = ts.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("split", [False, True])
def test_one_train_step_matches_jax_f32(split):
    b = jax_batch(seed=11, split=split)
    js, ts = both_states(b)
    loss_fn = "cross_entropy_loss"
    js, jm = jsteps.make_train_step(jlosses.get_loss_fn(loss_fn), donate=False)(js, b)
    ts, tm = tsteps.make_train_step(losses.get_loss_fn(loss_fn))(ts, port_batch(b))
    assert tm["loss"].dtype == torch.float32 and not tm["loss"].requires_grad
    np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
    assert ts.step == 1
    _params_close(js, ts, atol=1e-6)


def _three_steps(compute_dtype):
    """Three steps of both frameworks from the same params (AdamW with the
    clip, lr 1e-3): ``(per-step losses JAX, port), updates JAX, port)``,
    the updates as ``{name: params after - params before}``."""
    batches = [jax_batch(seed=20 + i, split=i == 1) for i in range(3)]
    js, ts = both_states(batches[0], lr=1e-3, weight_decay=0.01, grad_clip_norm=1.0)
    j0 = flax_to_state_dict(jax.tree.map(np.asarray, js.params))
    t0 = {k: v.clone() for k, v in ts.model.state_dict().items()}
    jstep = jsteps.make_train_step(jlosses.cross_entropy_loss, donate=False,
                                   compute_dtype=compute_dtype)
    tstep = tsteps.make_train_step(losses.cross_entropy_loss, compute_dtype=compute_dtype)
    jl, tl = [], []
    for b in batches:
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, port_batch(b))
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    assert all(p.dtype == torch.float32 for p in ts.model.parameters())
    j1 = flax_to_state_dict(jax.tree.map(np.asarray, js.params))
    t1 = ts.model.state_dict()
    return ((jl, tl), {k: (j1[k] - v).numpy() for k, v in j0.items()},
            {k: (t1[k] - v).numpy() for k, v in t0.items()}, js, ts)


# bf16 compute: the update of each leaf that bf16 leaves determined (JAX's
# bf16 update within half of its f32 update) must lie within UPDATE_RTOL of
# JAX's bf16 update, and the whole update within UPDATE_RTOL_GLOBAL (relative
# norms; seeds 20-22, 40-42 and 7-9 gave at most 0.138 per leaf and 0.060
# overall).  The additive attentions' leaves get gradients that cancel in
# float32 at this init, so bf16 rounding sets their update in both frameworks:
# they are only required to move.
UPDATE_RTOL, UPDATE_RTOL_GLOBAL = 0.3, 0.15


@pytest.mark.parametrize("compute_dtype,loss_tol,param_tol", [
    (None, 1e-5, 1e-6), ("bfloat16", 2e-2, None)])
def test_three_train_steps_match_jax(compute_dtype, loss_tol, param_tol):
    """Per-step losses and updated params against the JAX step; in bf16
    compute (``param_tol`` None) the updates are compared by relative norm,
    against JAX's float32 update as the yardstick of bf16 rounding."""
    (jl, tl), jd, td, js, ts = _three_steps(compute_dtype)
    if compute_dtype is None:
        np.testing.assert_allclose(tl, jl, rtol=loss_tol)
        _params_close(js, ts, atol=param_tol)
        return
    assert max(abs(a - b) for a, b in zip(tl, jl)) <= loss_tol
    _, jd32, _, _, _ = _three_steps(None)
    norm = np.linalg.norm
    flat = [np.concatenate([d[k].ravel() for k in sorted(jd)]) for d in (td, jd)]
    assert norm(flat[0] - flat[1]) <= UPDATE_RTOL_GLOBAL * norm(flat[1])
    determined = 0
    for k in jd:
        assert np.all(np.isfinite(td[k])) and norm(td[k]) > 0, k  # every master moved
        if norm(jd[k] - jd32[k]) <= 0.5 * norm(jd[k]):
            determined += 1
            assert norm(td[k] - jd[k]) <= UPDATE_RTOL * norm(jd[k]), (
                k, norm(td[k] - jd[k]) / norm(jd[k]))
    assert determined >= len(jd) - 6  # all but the two additive attentions' leaves


@pytest.mark.parametrize("split", [False, True])
def test_eval_step_matches_jax(split):
    b = jax_batch(seed=31, split=split)
    js, ts = both_states(b)
    want = jsteps.make_eval_step(jlosses.cross_entropy_loss)(js, b)
    got = tsteps.make_eval_step(losses.cross_entropy_loss)(ts, port_batch(b))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=1e-5)
    assert set(got[1]) == set(want[1]) and "categ_pers@5" in got[1]
    for k, v in want[1].items():
        np.testing.assert_allclose(got[1][k].numpy(), np.asarray(v), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[3].item(), float(want[3]), atol=1e-5)


def test_eval_step_without_aspects_or_loss():
    b = jax_batch(seed=32)
    _, ts = both_states(b)
    scores, per_imp, valid, loss = tsteps.make_eval_step(with_aspects=False)(ts, port_batch(b))
    assert loss is None and set(per_imp) == {"mrr", "ndcg@5", "ndcg@10"}
    assert scores[0, -1].item() == np.float32(-1e30)


@pytest.mark.parametrize("split", [False, True])
def test_news_field_and_valid_match_jax(split):
    b = jax_batch(seed=33, split=split)
    pb = port_batch(b)
    np.testing.assert_array_equal(base.news_field(pb, "category").numpy(),
                                  np.asarray(jbase.news_field(b, "category")))
    np.testing.assert_array_equal(base.news_valid(pb).numpy(), np.asarray(jbase.news_valid(b)))


def test_train_step_is_reproducible_from_seed_and_step():
    b = port_batch(jax_batch(seed=40))
    runs = []
    for seed in (0, 0, 1):
        model = NRMS(VOCAB, device="cpu", generator=torch.Generator().manual_seed(0), **DIMS)
        ts = tstate.create_train_state(model, tstate.make_optimizer(1e-3), dropout_seed=seed)
        step = tsteps.make_train_step(losses.cross_entropy_loss)
        runs.append([step(ts, b)[1]["loss"].item() for _ in range(2)])
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert runs[0][0] != runs[0][1]


def test_planted_signal_loss_halves_in_jax_and_port():
    """One fixed planted-signal batch, 50 steps at lr 1e-3 with dropout 0.2:
    the loss at least halves in the JAX step and in the port's, as the
    card's smoke run asks of the full-width model."""
    b = jax_batch(seed=50, planted=True, b=16)._replace(
        cand_mask=np.ones((16, 5), bool), impression_valid=np.ones(16, bool))
    js, ts = both_states(b, lr=1e-3, dropout_rate=0.2)
    jstep = jsteps.make_train_step(jlosses.cross_entropy_loss, donate=False)
    tstep = tsteps.make_train_step(losses.cross_entropy_loss)
    pb = port_batch(b)
    jl, tl = [], []
    for _ in range(50):
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, pb)
        jl.append(float(jm["loss"]))
        tl.append(tm["loss"].item())
    assert jl[-1] <= jl[0] / 2, jl
    assert tl[-1] <= tl[0] / 2, tl


# --------------------------------------------------------------- dropout

def test_dropout_is_drawn_from_the_given_generator():
    x = torch.ones(64, 32)
    g = torch.Generator()
    a = dropout(x, 0.25, False, g.manual_seed(7))
    torch.manual_seed(123)  # the global generator plays no part
    b = dropout(x, 0.25, False, g.manual_seed(7))
    c = dropout(x, 0.25, False, g.manual_seed(8))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
    assert set(a.unique().tolist()) == {0.0, torch.tensor(1 / 0.75).item()}
    assert abs((a != 0).float().mean().item() - 0.75) < 0.03


def test_dropout_deterministic_is_the_identity():
    x = torch.randn(5, 7)
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    for out in (Dropout(0.3)(x), Dropout(0.3)(x, deterministic=True, generator=g),
                Dropout(0.0)(x, deterministic=False, generator=g)):
        assert out is x
    assert torch.equal(g.get_state(), state)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.3, deterministic=False)


def test_train_state_reseeds_dropout_per_step():
    model = _Two(np.zeros(2, np.float32), np.zeros(2, np.float32))
    ts = tstate.create_train_state(model, tstate.make_optimizer(), dropout_seed=3)
    first = torch.rand(4, generator=ts.dropout_generator())
    again = torch.rand(4, generator=ts.dropout_generator())
    ts.step += 1
    second = torch.rand(4, generator=ts.dropout_generator())
    assert torch.equal(first, again) and not torch.equal(first, second)
    assert tstate.param_count(model) == 4


def test_frozen_embedding_gets_no_gradient():
    ids = torch.tensor([[1, 2, 0]])
    for frozen in (False, True):
        emb = TokenEmbedding(10, 4, generator=torch.Generator().manual_seed(0), frozen=frozen)
        out = (emb(ids) * torch.ones(4, requires_grad=True)).sum()
        out.backward()
        assert (emb.weight.grad is None) == frozen
