"""The port's MLM pretraining (``newsreclib_tpu_torch/mlm_pretrain.py``)
against the composition of ``benchmarks/mlm_pretrain.py:82-111``, built
here from the JAX package's ``TransformerEncoder`` at a small size (hidden
32, 2 layers, 4 heads, FFN 64, a vocabulary of 100 ids, ``SEQ_LEN`` 12) and
converted with ``convert.flax_to_state_dict``; and the frozen-layer check
(``plm_frozen_check.py``) on a CPU fine-tune of the demo fixture.

Tolerances (float32): the logits within 1e-5 and the masked loss within
1e-6 of JAX's; after three AdamW steps under the warmup-cosine schedule
against ``optax.adamw``, every parameter within 1e-5 relative (atol 1e-7)
but the attention key biases, whose gradient is structurally zero (float32
noise that Adam turns into updates): their gradient is held within 1e-7
instead; the masks bit-equal to the script's draw lines, run as the
script's own source; the export's encoder outputs through the JAX loader
within 1e-5 of the port's encoder.
"""

import inspect
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from newsreclib_tpu_torch import mlm_pretrain as mlm
from newsreclib_tpu_torch.convert import flax_to_state_dict

VOCAB, SEQ, BATCH = 98, 12, 6  # model vocabulary VOCAB + 2 = 100
SIZES = dict(hidden=32, layers=2, heads=4, inter=64)
LR, STEPS_TOTAL = 1e-2, 30  # warmup 3: the three steps take lr 0, lr / 3, 2 lr / 3


def _flax_mlm(model_vocab):
    """The JAX script's ``MLMModel`` (``benchmarks/mlm_pretrain.py:82-94``)
    at the test's sizes."""
    import flax.linen as nn

    from newsreclib_tpu.models.components.plm import TransformerEncoder

    class MLMModel(nn.Module):
        @nn.compact
        def __call__(self, tokens, deterministic=True):
            enc = TransformerEncoder(
                vocab_size=model_vocab, hidden_dim=SIZES["hidden"], num_layers=SIZES["layers"],
                num_heads=SIZES["heads"], intermediate_dim=SIZES["inter"], max_position=64,
                name="encoder",
            )
            h = enc(tokens, tokens != 0, deterministic)
            h = nn.Dense(SIZES["hidden"], name="mlm_dense")(h)
            h = nn.gelu(h, approximate=False)
            h = nn.LayerNorm(epsilon=1e-12, name="mlm_ln")(h)
            return nn.Dense(model_vocab, name="mlm_out")(h)

    return MLMModel()


def _jax_loss(model, params, tokens, targets, mlm_mask):
    """The script's loss and accuracy (``:100-111``'s step, no dropout)."""
    logits = model.apply({"params": params}, tokens)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    m = mlm_mask.astype(jnp.float32)
    acc = (jnp.argmax(logits, -1) == targets) * m
    return (nll * m).sum() / jnp.maximum(m.sum(), 1.0), acc.sum() / jnp.maximum(m.sum(), 1.0)


def _corpus(seed=3, n=40):
    rng = np.random.default_rng(seed)
    seqs = np.zeros((n, SEQ), np.int32)
    for i, length in enumerate(rng.integers(3, SEQ + 1, size=n)):
        seqs[i, :length] = rng.integers(1, VOCAB + 1, size=length)
    return seqs


@pytest.fixture(scope="module")
def models():
    """The JAX module and its parameters, and the port's module holding
    them."""
    jm = _flax_mlm(VOCAB + 2)
    params = jm.init(jax.random.key(0), jnp.asarray(_corpus()[:2]))["params"]
    tm = mlm.MLMModel(VOCAB + 2, **SIZES)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    return jm, params, tm


def _batch(step=0):
    rng = np.random.default_rng(step)
    return mlm.mask_batch(rng, _corpus(), BATCH, VOCAB)


def _positions(mlm_mask):
    return torch.from_numpy(np.flatnonzero(mlm_mask))


def test_mask_draws_equal_the_scripts_lines():
    """Five steps of ``mask_batch`` against the draw lines of
    ``benchmarks/mlm_pretrain.py`` (cut from its ``main`` and run as they
    stand) from the same ``default_rng``: every array bit-equal; the mask
    id, random tokens and kept tokens all occur."""
    import benchmarks.mlm_pretrain as script

    src = textwrap.dedent(inspect.getsource(script.main)).splitlines()
    first = next(i for i, line in enumerate(src) if "idx = rng.integers" in line)
    last = next(i for i, line in enumerate(src) if "(r >= 0.8) & (r < 0.9)" in line)
    lines = textwrap.dedent("\n".join(src[first:last + 1]))
    seqs = _corpus()
    ours, theirs = np.random.default_rng(7), np.random.default_rng(7)
    mask_id = VOCAB + 1
    seen = set()
    for _ in range(5):
        tok, targets, mlm_mask = mlm.mask_batch(ours, seqs, BATCH, VOCAB)
        env = {"np": np, "rng": theirs, "seqs": seqs, "args": type("A", (), {"batch": BATCH}),
               "mask_id": mask_id, "vocab": VOCAB}
        exec(lines, env)
        np.testing.assert_array_equal(tok, env["tok"])
        np.testing.assert_array_equal(targets, env["targets"])
        np.testing.assert_array_equal(mlm_mask, env["mlm_mask"])
        changed = mlm_mask & (tok != targets)
        seen |= {"mask" if t == mask_id else "random" for t in tok[changed]}
        seen |= {"kept"} if (mlm_mask & (tok == targets)).any() else set()
    assert seen == {"mask", "random", "kept"}


def test_logits_and_masked_loss_match_jax(models):
    jm, params, tm = models
    tok, targets, mlm_mask = _batch()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(tok)))
    with torch.no_grad():
        got = tm(torch.from_numpy(tok)).numpy()
        loss, acc = mlm.masked_loss(tm, torch.from_numpy(tok), torch.from_numpy(targets),
                                    _positions(mlm_mask))
    assert got.shape == (BATCH, SEQ, VOCAB + 2)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    jloss, jacc = _jax_loss(jm, params, jnp.asarray(tok), jnp.asarray(targets),
                            jnp.asarray(mlm_mask))
    assert abs(float(loss) - float(jloss)) < 1e-6
    assert float(acc) == float(jacc)


def _key_bias(name):
    return name.endswith(".k.bias")


def test_three_adamw_steps_match_optax(models):
    """Three updates from the same parameters on the same masked batches:
    ``optax.adamw`` (weight decay 1e-4) under
    ``warmup_cosine_decay_schedule(0, lr, min(500, total // 10), total)``
    against the port's ``make_optimizer_for``."""
    jm, params, tm = models
    tm = mlm.MLMModel(VOCAB + 2, **SIZES)
    tm.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray, params)))
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, LR, min(500, STEPS_TOTAL // 10), STEPS_TOTAL))
    jp, opt_state = params, tx.init(params)
    optimizer = mlm.make_optimizer_for(STEPS_TOTAL, LR)
    opt = optimizer.build(tm)
    grads = {}
    for it in range(3):
        tok, targets, mlm_mask = _batch(it)
        jt, jg, jmask = (jnp.asarray(a) for a in (tok, targets, mlm_mask))
        jgrads = jax.grad(lambda p: _jax_loss(jm, p, jt, jg, jmask)[0])(jp)
        updates, opt_state = tx.update(jgrads, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        loss, _ = mlm.masked_loss(tm, torch.from_numpy(tok), torch.from_numpy(targets),
                                  _positions(mlm_mask))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = {n: p.grad.clone() for n, p in tm.named_parameters()}
        want_grads = flax_to_state_dict(jax.tree.map(np.asarray, jgrads))
        optimizer.update(opt, it)
    want = flax_to_state_dict(jax.tree.map(np.asarray, jp))
    got = tm.state_dict()
    assert set(got) == set(want)
    start = flax_to_state_dict(jax.tree.map(np.asarray, params))
    for k in want:
        if _key_bias(k):
            np.testing.assert_allclose(grads[k].numpy(), want_grads[k].numpy(), atol=1e-7,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert not np.allclose(got["mlm_out.weight"].numpy(), start["mlm_out.weight"].numpy())


def test_export_is_read_by_both_loaders(tmp_path, models):
    """``export`` writes a ``BertModel`` directory: the port's loader reads
    it back tensor for tensor, and the JAX package's loader gives an encoder
    whose outputs equal the port's (1e-5)."""
    from newsreclib_tpu.models.components.plm import TransformerEncoder as JEncoder
    from newsreclib_tpu.models.components.plm import load_hf_torch_weights as jload
    from newsreclib_tpu_torch.models.components.plm import load_hf_torch_weights

    _, _, tm = models
    out = mlm.export(tm, str(tmp_path / "plm"))
    state, kwargs = load_hf_torch_weights(out)
    assert kwargs["vocab_size"] == VOCAB + 2 and kwargs["num_layers"] == SIZES["layers"]
    assert kwargs["max_position"] == mlm.MAX_POSITION
    for k, v in tm.encoder.state_dict().items():
        assert torch.equal(state[k], v), k
    jparams, jkwargs = jload(out)
    tok = _batch()[0]
    want = JEncoder(**jkwargs).apply({"params": jparams}, jnp.asarray(tok),
                                     jnp.asarray(tok != 0))
    with torch.no_grad():
        got = tm.encoder(torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_pretrain_loss_falls_on_the_cpu():
    """``pretrain`` on a planted corpus (each article one repeated token):
    the loss at the last step is below the first's."""
    rng = np.random.default_rng(0)
    seqs = np.repeat(rng.integers(1, VOCAB + 1, size=(64, 1)), SEQ, axis=1).astype(np.int32)
    _, record = mlm.pretrain(seqs, VOCAB, steps=40, batch=16, lr=1e-2, device="cpu",
                             log=lambda m: None, **SIZES)
    first, last = record["history"][0], record["history"][-1]
    assert last["step"] == 39 and last["mlm_loss"] < 0.5 * first["mlm_loss"]


def test_frozen_check_after_a_demo_fine_tune(tmp_path):
    """The pipeline on a copy of the demo data: ``mlm_pretrain`` at the
    script's sizes for 20 steps at batch 16 (its ETL, the directory's
    first, names no GloVe file, as the script), the training CLI's
    ``nrms_statfix_plm4_pre`` over that export (``frozen_layers=[0, 1]``)
    for 3 steps, then ``plm_frozen_check``: layers 0-1 bit-identical,
    layers 2-3 moved (exit 0); with only layer 0 declared frozen it fails
    (layer 1 did not move)."""
    from newsreclib_tpu_torch import plm_frozen_check
    from newsreclib_tpu_torch import train as ttrain
    from tests.test_torch_port_cli import demo_copy

    data = demo_copy(tmp_path / "data")
    out = tmp_path / "plm4"
    record = mlm.main(["--data-dir", str(data), "--dataset-size", "demo", "--out", str(out),
                       "--steps", "20", "--batch", "16", "--device", "cpu"])
    assert record["history"][-1]["step"] == 19
    assert not (data / "MINDsmall_train").exists()  # no fixture for a demo corpus
    assert not (data / "MINDdemo_train" / "transformed_word_embeddings.npy").exists()
    run = tmp_path / "run"
    metrics = ttrain.main([
        "experiment=nrms_statfix_plm4_pre", "data=mind_demo", "platform=cpu",
        f"data.data_dir={data}", f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
        f"model.plm_model={out}", "model.num_heads=4", "trainer.max_epochs=1",
        "trainer.limit_train_batches=3", f"output_dir={run}"])
    assert np.isfinite(metrics["test/auc"])
    lines = []
    assert plm_frozen_check.check(str(run), str(out), [0, 1], log=lines.append)
    assert lines[-1] == "frozen-layer check: PASS" and "layer_2 [train]" in lines[2]
    assert plm_frozen_check.main([str(run), "--hf", str(out), "--frozen", "0"]) == 1
