"""Masked-language-model pretraining of a small PLM tower on a MIND corpus
(counterpart of ``benchmarks/mlm_pretrain.py``), exported as a Hugging
Face ``BertModel`` checkpoint for the PLM configs to fine-tune:

    python -m newsreclib_tpu_torch.mlm_pretrain [--data-dir data/statfix]
        [--out data/statfix/plm4_pretrained] [--steps 4000] [--batch 512]
        [--lr 3e-4] [--seed 0] [--device cpu] [--dataset-size demo]
    python -m newsreclib_tpu_torch.train experiment=nrms_statfix_plm4_pre
    python -m newsreclib_tpu_torch.plm_frozen_check <run_dir>

It runs on the card unless ``--device cpu`` is given.  Where the numbers
depend on it, it follows the JAX script line by line:

* the corpus (``build_corpus``, ``:37-58``): each article of the train
  store, its title tokens then its abstract tokens, cut to ``SEQ_LEN``; the
  padding row dropped; the vocabulary ``vocab + 2`` with the mask id
  ``vocab + 1``.  The statfix fixture is written first, through the
  training CLI's fixture writer, when ``--data-dir`` lacks it.  The ETL's
  caches are the training CLI's; as the script, it names no GloVe file
  (a later GloVe run builds its matrix from the cached id maps);
* the model (``MLMModel``, ``:82-94``): the port's ``TransformerEncoder``
  (256 wide, 4 layers, 8 heads, FFN 1,024, 64 positions, dropout 0.1),
  then ``mlm_dense``, exact GELU, ``mlm_ln`` (eps 1e-12) and ``mlm_out``
  over the vocabulary, flax's initialisation, drawn from ``--seed``;
* the masking (``mask_batch``, ``:100-111``): the same numpy draws in the
  same order from ``default_rng(seed)``, so the masks equal the script's;
* the update (``:97-99``): AdamW as ``optax.adamw`` (b1 0.9, b2 0.999, eps
  1e-8, weight decay 1e-4) under ``warmup_cosine_decay_schedule(0, lr,
  min(500, steps // 10), steps)`` (``training/state.py::make_optimizer``);
* the loss: the float32 log-softmax NLL of the masked tokens, mean over
  them, and the masked-token accuracy, both printed every 200 steps and at
  the last.  Only the masked positions reach ``mlm_out`` (the script
  computes the logits of every position and weights them by the mask: the
  same loss and gradient), so the logits take ``masked x vocab`` floats,
  not ``batch x SEQ_LEN x vocab`` (2.8 GB at the defaults);
* the export: the encoder through ``save_as_hf_bert`` with the script's
  keywords, read back by either package's ``load_hf_torch_weights``.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from newsreclib_tpu_torch.models.components.linear import Dense
from newsreclib_tpu_torch.models.components.plm import (
    LayerNorm,
    TransformerEncoder,
    save_as_hf_bert,
)

HIDDEN, LAYERS, HEADS, INTER = 256, 4, 8, 1024
SEQ_LEN = 48  # title (<= 30) + abstract head
MAX_POSITION = 64
MASK_PROB = 0.15
LOG_EVERY = 200


def build_corpus(data_dir: str, dataset_size: str = "small") -> Tuple[np.ndarray, int]:
    """``(seqs, vocab)``: ``(N, SEQ_LEN)`` int32 token rows, one per article
    of the train store (the padding row dropped), and the word vocabulary's
    size.  A ``small`` corpus missing from ``data_dir`` is written first as
    the statfix fixture (seed 42, ``train.ensure_mind_fixture``)."""
    from newsreclib_tpu_torch.data.mind import MINDConfig, MINDData
    from newsreclib_tpu_torch.train import ensure_mind_fixture

    if dataset_size == "small":
        ensure_mind_fixture({"data_dir": data_dir, "dataset_size": "small",
                             "generate_fixture": "statfix", "seed": 42})
    mind = MINDData(MINDConfig(
        data_dir=data_dir, dataset_size=dataset_size,
        valid_time_split="2019-11-14 00:00:00",
        sentiment_annotator="lexicon", seed=42,
    ))
    store = mind.news_store("train")
    title = np.asarray(store.title)
    if store.abstract is not None:
        abstract = np.asarray(store.abstract)[:, :SEQ_LEN]
    else:
        abstract = np.zeros((title.shape[0], 0), np.int32)
    seqs = np.zeros((title.shape[0], SEQ_LEN), np.int32)
    for i in range(title.shape[0]):
        toks = np.concatenate([title[i][title[i] != 0], abstract[i][abstract[i] != 0]])
        seqs[i, :min(len(toks), SEQ_LEN)] = toks[:SEQ_LEN]
    return seqs[1:], mind.vocab_size()


def mask_batch(rng: np.random.Generator, seqs: np.ndarray, batch: int, vocab: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(tokens, targets, mlm_mask)`` of one step: ``batch`` rows drawn with
    replacement, 15% of their tokens selected; of those 80% become the mask
    id, 10% a random token and 10% stay (the JAX script's draws, in its
    order)."""
    mask_id = vocab + 1
    idx = rng.integers(0, seqs.shape[0], size=batch)
    tok = seqs[idx].copy()
    valid = tok != 0
    prob = rng.random(tok.shape)
    mlm_mask = (prob < MASK_PROB) & valid
    targets = seqs[idx]
    r = rng.random(tok.shape)
    tok = np.where(mlm_mask & (r < 0.8), mask_id, tok)
    rand_tok = rng.integers(1, vocab + 1, size=tok.shape)
    tok = np.where(mlm_mask & (r >= 0.8) & (r < 0.9), rand_tok, tok)
    return tok, targets, mlm_mask


def encoder_kwargs(model_vocab: int, hidden: int = HIDDEN, layers: int = LAYERS,
                   heads: int = HEADS, inter: int = INTER,
                   max_position: int = MAX_POSITION) -> Dict[str, int]:
    """The tower's keywords, as the script exports them."""
    return dict(vocab_size=model_vocab, hidden_dim=hidden, num_layers=layers, num_heads=heads,
                intermediate_dim=inter, max_position=max_position)


class MLMModel(nn.Module):
    """The tower and its MLM head, under the JAX script's names: ``encoder``,
    ``mlm_dense``, ``mlm_ln``, ``mlm_out``."""

    def __init__(self, model_vocab: int, generator: Optional[torch.Generator] = None, **sizes):
        super().__init__()
        kw = encoder_kwargs(model_vocab, **sizes)
        self.encoder = TransformerEncoder(**kw, generator=generator)
        self.mlm_dense = Dense(kw["hidden_dim"], kw["hidden_dim"], generator)
        self.mlm_ln = LayerNorm(kw["hidden_dim"], 1e-12)
        self.mlm_out = Dense(kw["hidden_dim"], model_vocab, generator)

    def features(self, tokens: torch.Tensor, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(..., SEQ_LEN, hidden)``: the head's input to ``mlm_out``."""
        h = self.encoder(tokens, tokens != 0, deterministic, generator)
        return self.mlm_ln(F.gelu(self.mlm_dense(h), approximate="none"))

    def forward(self, tokens: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The logits of every position, ``(..., SEQ_LEN, model_vocab)``."""
        return self.mlm_out(self.features(tokens, deterministic, generator))


def masked_loss(model: MLMModel, tokens: torch.Tensor, targets: torch.Tensor,
                positions: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(loss, accuracy)`` over the masked tokens: ``positions`` are their
    flat indices into ``tokens`` (the script's ``mlm_mask``); the loss is
    the mean float32 NLL of the log-softmax, the accuracy the share whose
    argmax is the target (0 each when nothing is masked)."""
    h = model.features(tokens, deterministic, generator)
    logits = model.mlm_out(h.reshape(-1, h.shape[-1])[positions]).float()
    want = targets.reshape(-1)[positions].long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, want[:, None])[:, 0]
    n = max(positions.numel(), 1)
    return nll.sum() / n, (logits.argmax(-1) == want).float().sum() / n


def make_optimizer_for(steps: int, lr: float):
    """AdamW as ``optax.adamw`` (weight decay 1e-4) under the script's
    warmup-cosine schedule."""
    from newsreclib_tpu_torch.training.state import make_optimizer

    return make_optimizer(lr, weight_decay=1e-4, scheduler="cosine",
                          warmup_steps=min(500, steps // 10), total_steps=steps)


def pretrain(seqs: np.ndarray, vocab: int, steps: int = 4000, batch: int = 512,
             lr: float = 3e-4, seed: int = 0, device: str = "cuda",
             log=print, **sizes) -> Tuple[MLMModel, Dict]:
    """Train ``MLMModel`` on ``seqs`` for ``steps`` steps; the model and a
    record: every logged step's loss and accuracy, seconds, steps a second
    and (on the card) the peak memory."""
    dev = torch.device(device)
    model_vocab = vocab + 2
    model = MLMModel(model_vocab, torch.Generator().manual_seed(seed), **sizes).to(dev)
    model.train()
    optimizer = make_optimizer_for(steps, lr)
    opt = optimizer.build(model)
    rng = np.random.default_rng(seed)
    dropout = torch.Generator(device=dev).manual_seed(seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    history = []
    t0 = time.perf_counter()
    for it in range(steps):
        tok, targets, mlm_mask = mask_batch(rng, seqs, batch, vocab)
        positions = torch.from_numpy(np.flatnonzero(mlm_mask)).to(dev, non_blocking=True)
        loss, acc = masked_loss(model, torch.from_numpy(tok).to(dev),
                                torch.from_numpy(targets).to(dev), positions,
                                deterministic=False, generator=dropout)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.update(opt, it)
        if it % LOG_EVERY == 0 or it == steps - 1:
            rec = {"step": it, "mlm_loss": float(loss.detach()), "masked_acc": float(acc),
                   "s": time.perf_counter() - t0}
            history.append(rec)
            log(f"step {it}: mlm_loss={rec['mlm_loss']:.4f} masked_acc={rec['masked_acc']:.4f} "
                f"({rec['s']:.0f}s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    record = {"steps": steps, "batch": batch, "lr": lr, "seed": seed, "history": history,
              "seconds": seconds, "steps_per_s": steps / max(seconds, 1e-9),
              "device": str(dev)}
    if dev.type == "cuda":
        record["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
        record["card"] = torch.cuda.get_device_name(dev)
    return model, record


def export(model: MLMModel, out: str) -> str:
    """The encoder as a ``BertModel`` checkpoint directory under ``out``."""
    enc = model.encoder
    kw = encoder_kwargs(enc.word_embeddings.weight.shape[0], enc.hidden_dim, enc.num_layers,
                        enc.layer_0.num_heads, enc.layer_0.ff1.weight.shape[0],
                        enc.position_embeddings.weight.shape[0])
    return save_as_hf_bert(enc.state_dict(), kw, out)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default="data/statfix")
    ap.add_argument("--dataset-size", default="small")
    ap.add_argument("--out", default="data/statfix/plm4_pretrained")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")

    seqs, vocab = build_corpus(args.data_dir, args.dataset_size)
    print(f"corpus: {seqs.shape[0]} articles, vocab {vocab} (+mask id {vocab + 1})", flush=True)
    model, record = pretrain(seqs, vocab, args.steps, args.batch, args.lr, args.seed,
                             args.device, log=lambda m: print(m, flush=True))
    out = export(model, args.out)
    last = record["history"][-1]
    record.update(out=out, articles=int(seqs.shape[0]), vocab=vocab)
    print(f"exported HF-format checkpoint to {out} (final mlm_loss {last['mlm_loss']:.4f}, "
          f"masked_acc {last['masked_acc']:.4f}; {record['seconds']:.1f} s"
          + (f", peak memory {record['peak_memory_bytes'] / 2**20:.1f} MiB"
             if "peak_memory_bytes" in record else "") + ")", flush=True)
    return record


if __name__ == "__main__":
    main()
