"""PLM text tower: a BERT / RoBERTa encoder with the PLM-NR head or CLS
pooling, layer freezing labels and Hugging Face checkpoint I/O without
``transformers`` (counterpart of ``newsreclib_tpu/models/components/plm.py``).

* ``TransformerEncoder`` (``:77-135``): word, position and token-type
  embeddings, ``emb_ln``, dropout, then ``layer_{i}`` post-LN layers
  (``TransformerLayer``, ``:32-74``): separate ``q``, ``k``, ``v`` Denses,
  logits over sqrt(head dim), masked keys at the finite -1e30, softmax,
  dropout on the probabilities, ``attn_out``, ``attn_ln``, ``ff1``, exact
  GELU, ``ff2``, ``ff_ln``.  The tower's own attention is plain torch
  (``self_attention``), as the JAX tower's is einsum and softmax outside any
  Pallas kernel; the PLM-NR head's ``MultiHeadSelfAttention`` runs the
  ``fused_small_mhsa`` kernel on the card.
* ``PLMTextEncoder`` (``:162-226``): the tower, then ``mhsa`` + ``add_att``
  or the CLS vector, then an optional ``reduce_dim``.  ``pack_to`` (segment-ID
  packing of several titles into one sequence) is accepted and ignored:
  packed and unpacked titles give the same vectors for every article with a
  token (``tests/test_plm.py::test_plm_packing_exact``).
* ``plm_freeze_labels`` (``:138-159``) over the port's parameter names.
* ``encoder_config_from_hf``, ``load_hf_torch_weights`` and
  ``save_as_hf_bert`` (``:229-363``) read and write a local checkpoint
  directory (``config.json`` with ``json``, ``pytorch_model.bin`` with
  ``torch.load(weights_only=True)``, ``model.safetensors`` with
  ``read_safetensors``); nothing is fetched.
* ``SequenceClassifier``, ``load_hf_classifier`` and
  ``save_as_hf_classifier``: a BERT / RoBERTa sequence-classification
  checkpoint (the tower and its head) for the BERT sentiment annotator
  (``data/sentiment.py``).

Parameter names are the JAX package's (``convert.py``): LayerNorms hold
``scale`` and ``bias``, embedding tables ``weight``.  Initialisation is
flax's: Dense lecun-normal with zero bias, ``nn.Embed`` N(0, 1 / D)
untruncated (torch's ``nn.Embedding`` draws N(0, 1)), LayerNorm scale 1 and
bias 0.  No ``remat``.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from newsreclib_tpu_torch.models.components.attention import (
    AdditiveAttention,
    MultiHeadSelfAttention,
)
from newsreclib_tpu_torch.models.components.dropout import Dropout, dropout
from newsreclib_tpu_torch.models.components.linear import Dense, normal

_MASK_MIN = -1e30
EMBEDDING_NAMES = ("word_embeddings", "position_embeddings", "token_type_embeddings", "emb_ln")


def share(owner: nn.Module, name: str, module: nn.Module) -> None:
    """Make ``module`` reachable as ``owner.<name>`` without registering it
    there.  A model registers its PLM tower once, as ``text_encoder_module``
    (flax names a module passed in as a field by the field), and the blocks
    that call it reach it through this, so the state dict holds the tower's
    parameters once, under the JAX package's names."""
    object.__setattr__(owner, name, module)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis: parameters ``scale`` and
    ``bias``.  flax's E[x^2] - E[x]^2 variance agrees with torch's within
    float32 rounding."""

    def __init__(self, dim: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.scale, self.bias, self.eps)


class Embed(nn.Module):
    """flax ``nn.Embed``: a ``weight`` table drawn N(0, 1 / dim), untruncated;
    no padding row is zeroed (the tower masks pad tokens as keys)."""

    def __init__(self, num: int, dim: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(normal((num, dim), 1.0 / math.sqrt(dim), generator))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: Optional[torch.Tensor], num_heads: int, rate: float,
                   deterministic: bool = True,
                   generator: Optional[torch.Generator] = None,
                   head_part: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The tower's attention, plain torch as in the JAX layer: ``(..., L, H)``
    projections and a ``(..., L)`` key mask -> ``(..., L, H)``.  Masked keys
    take the finite -1e30 (a fully masked row stays finite), and dropout
    acts on the probabilities.  ``head_part=(size, index)``: the heads are
    block ``index`` of ``size`` of the layer's, and the dropout draws over
    all of them and keeps the block (``dropout.keep_mask``)."""
    *lead, l, h = q.shape
    hd = h // num_heads

    def split(t):
        return t.reshape(*lead, l, num_heads, hd).transpose(-2, -3)

    logits = split(q) @ split(k).transpose(-1, -2) / math.sqrt(hd)
    if mask is not None:
        logits = torch.where(mask[..., None, None, :], logits, _MASK_MIN)
    att = dropout(torch.softmax(logits, dim=-1), rate, deterministic, generator,
                  None if head_part is None else (-3, *head_part))
    return (att @ split(v)).transpose(-2, -3).reshape(*lead, l, h)


class TransformerLayer(nn.Module):
    """Post-LN BERT encoder layer (``newsreclib_tpu/models/components/plm.py:32-74``).
    ``tp`` (set by ``parallel/mesh.py::place_state`` under
    ``tp_transformer``): the layer holds its tensor-parallel shards."""

    tp = None

    def __init__(self, hidden_dim: int, num_heads: int, intermediate_dim: int,
                 dropout: float = 0.1, layer_norm_eps: float = 1e-12,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden_dim {hidden_dim} is not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.rate = dropout
        self.q = Dense(hidden_dim, hidden_dim, generator)
        self.k = Dense(hidden_dim, hidden_dim, generator)
        self.v = Dense(hidden_dim, hidden_dim, generator)
        self.attn_out = Dense(hidden_dim, hidden_dim, generator)
        self.attn_ln = LayerNorm(hidden_dim, layer_norm_eps)
        self.ff1 = Dense(hidden_dim, intermediate_dim, generator)
        self.ff2 = Dense(intermediate_dim, hidden_dim, generator)
        self.ff_ln = LayerNorm(hidden_dim, layer_norm_eps)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.tp is not None:
            return self._forward_tp(x, mask, deterministic, generator)
        ctx = self_attention(self.q(x), self.k(x), self.v(x), mask, self.num_heads, self.rate,
                             deterministic, generator)
        ctx = self.dropout(self.attn_out(ctx), deterministic, generator)
        x = self.attn_ln(x + ctx)
        ff = self.ff2(F.gelu(self.ff1(x), approximate="none"))
        ff = self.dropout(ff, deterministic, generator)
        return self.ff_ln(x + ff)

    def _forward_tp(self, x, mask, deterministic, generator):
        """Megatron tensor parallelism over ``self.tp.group``: this rank holds
        a contiguous block of the heads (q, k, v column-parallel) and of the
        MLP's hidden units (ff1 column-parallel); attn_out and ff2 are
        row-parallel, their partial outputs summed over the group before the
        bias.  ``copy_to_group`` / ``reduce_from_group`` are the conjugate
        pair (identity forward, all-reduce backward, and the reverse).  The
        dropout on the attention probabilities draws over every head and
        keeps this rank's, so the ranks apply one device's masks."""
        from newsreclib_tpu_torch.parallel.collectives import copy_to_group, reduce_from_group

        group = self.tp.group
        xin = copy_to_group(x, group)
        ctx = self_attention(self.q(xin), self.k(xin), self.v(xin), mask,
                             self.num_heads // self.tp.size, self.rate, deterministic, generator,
                             (self.tp.size, self.tp.index))
        ctx = reduce_from_group(F.linear(ctx, self.attn_out.weight), group) + self.attn_out.bias
        ctx = self.dropout(ctx, deterministic, generator)
        x = self.attn_ln(x + ctx)
        h = F.gelu(self.ff1(copy_to_group(x, group)), approximate="none")
        ff = reduce_from_group(F.linear(h, self.ff2.weight), group) + self.ff2.bias
        ff = self.dropout(ff, deterministic, generator)
        return self.ff_ln(x + ff)


class TransformerEncoder(nn.Module):
    """BERT / RoBERTa encoder: ``(U, L)`` token ids -> ``(U, L, hidden_dim)``.
    Positions are ``arange(L) + position_offset`` (RoBERTa: pad id + 1 = 2),
    token types all 0.  Keyword names and defaults as the JAX module's."""

    def __init__(self, vocab_size: int, hidden_dim: int = 768, num_layers: int = 12,
                 num_heads: int = 12, intermediate_dim: int = 3072, max_position: int = 512,
                 type_vocab_size: int = 2, dropout: float = 0.1, layer_norm_eps: float = 1e-12,
                 pad_token_id: int = 0, position_offset: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.pad_token_id = pad_token_id
        self.position_offset = position_offset
        self.word_embeddings = Embed(vocab_size, hidden_dim, generator)
        self.position_embeddings = Embed(max_position, hidden_dim, generator)
        self.token_type_embeddings = Embed(type_vocab_size, hidden_dim, generator)
        self.emb_ln = LayerNorm(hidden_dim, layer_norm_eps)
        self.dropout = Dropout(dropout)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", TransformerLayer(
                hidden_dim, num_heads, intermediate_dim, dropout, layer_norm_eps, generator))

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mask is None:
            mask = tokens != self.pad_token_id
        l = tokens.shape[-1]
        first, table = self.position_offset, self.position_embeddings.weight
        if first + l > table.shape[0]:
            raise ValueError(f"{l} positions from {first} exceed the {table.shape[0]} position "
                             "embeddings")
        x = (self.word_embeddings(tokens) + table[first:first + l]
             + self.token_type_embeddings.weight[0])
        x = self.dropout(self.emb_ln(x), deterministic, generator)
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, mask, deterministic, generator)
        return x


def plm_freeze_labels(names: Iterable[str], frozen_layers: Sequence[int],
                      freeze_embeddings: bool = False) -> Dict[str, str]:
    """``{parameter name: "freeze" | "train"}`` for ``make_optimizer``'s
    ``freeze_labels`` (the reference's ``requires_grad=False`` per layer
    index, ``text.py:70-73``): a parameter whose dotted name holds
    ``layer_<i>`` for i in ``frozen_layers``, or with ``freeze_embeddings``
    an embedding table or ``emb_ln``, is frozen."""
    frozen = {f"layer_{i}" for i in frozen_layers}
    if freeze_embeddings:
        frozen |= set(EMBEDDING_NAMES)
    return {n: "freeze" if frozen & set(n.split(".")) else "train" for n in names}


class PLMTextEncoder(nn.Module):
    """The reference's ``PLM`` wrapper: ``encoder``, then the PLM-NR head
    (dropout, ``mhsa``, dropout, ``add_att``) or the CLS vector, then an
    optional ``reduce_dim`` with dropout.  ``(U, L)`` ids -> ``(U, out_dim)``."""

    def __init__(self, encoder: TransformerEncoder, use_mhsa: bool = True, num_heads: int = 16,
                 query_dim: int = 200, apply_reduce_dim: bool = False,
                 reduced_embed_dim: Optional[int] = None, dropout: float = 0.2,
                 pack_to: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        del pack_to  # packing is exact and has no use on the card (module doc)
        d = encoder.hidden_dim
        self.encoder = encoder
        self.use_mhsa = use_mhsa
        self.dropout = Dropout(dropout)
        if use_mhsa:
            self.mhsa = MultiHeadSelfAttention(d, num_heads, generator)
            self.add_att = AdditiveAttention(d, query_dim, generator)
        self.reduce_dim = Dense(d, reduced_embed_dim, generator) if apply_reduce_dim else None
        self.out_dim = reduced_embed_dim if apply_reduce_dim else d

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if mask is None:
            mask = tokens != self.encoder.pad_token_id
        hidden = self.encoder(tokens, mask, deterministic, generator)
        if self.use_mhsa:
            x = self.dropout(hidden, deterministic, generator)
            x = self.dropout(self.mhsa(x, mask), deterministic, generator)
            out = self.add_att(x, mask)
        else:
            out = hidden[:, 0]
        if self.reduce_dim is not None:
            out = self.dropout(self.reduce_dim(out), deterministic, generator)
        return out


# ---------------- Hugging Face checkpoint I/O ----------------

# the port's TransformerEncoder names -> a BertModel / RobertaModel state dict's
_HF_EMBEDDINGS = {
    "word_embeddings.weight": "embeddings.word_embeddings.weight",
    "position_embeddings.weight": "embeddings.position_embeddings.weight",
    "token_type_embeddings.weight": "embeddings.token_type_embeddings.weight",
    "emb_ln.scale": "embeddings.LayerNorm.weight",
    "emb_ln.bias": "embeddings.LayerNorm.bias",
}
_HF_LAYER = {"q": "attention.self.query", "k": "attention.self.key",
             "v": "attention.self.value", "attn_out": "attention.output.dense",
             "attn_ln": "attention.output.LayerNorm", "ff1": "intermediate.dense",
             "ff2": "output.dense", "ff_ln": "output.LayerNorm"}
# the base-model prefixes AutoModel strips, and the heads it leaves out
_HF_PREFIXES = ("bert.", "roberta.")
_HF_IGNORED = ("pooler.", "lm_head.", "cls.")
_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
                       "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
                       "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
                       "BOOL": torch.bool}


def hf_names(num_layers: int) -> Dict[str, str]:
    """``{port name: Hugging Face name}`` of a ``num_layers`` encoder (Dense
    weights share torch's (out, in) layout: no transpose)."""
    out = dict(_HF_EMBEDDINGS)
    for i in range(num_layers):
        for ours, theirs in _HF_LAYER.items():
            for ours_leaf, theirs_leaf in ((("scale", "weight"), ("bias", "bias"))
                                           if ours.endswith("_ln")
                                           else (("weight", "weight"), ("bias", "bias"))):
                out[f"layer_{i}.{ours}.{ours_leaf}"] = (f"encoder.layer.{i}.{theirs}."
                                                        f"{theirs_leaf}")
    return out


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file, by its documented layout: an
    8-byte little-endian header length, a JSON header of each tensor's
    dtype, shape and byte offsets into the buffer after it (and an optional
    ``__metadata__``), then the little-endian buffer."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(f.read())
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        flat = (torch.frombuffer(buf, dtype=dtype, offset=begin,
                                 count=(end - begin) // dtype.itemsize)
                if end > begin else torch.empty(0, dtype=dtype))
        out[name] = flat.reshape(info["shape"]).clone()
    return out


def _read_weights(directory: str) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint directory: ``model.safetensors``, else
    ``pytorch_model.bin``."""
    path = os.path.join(directory, "model.safetensors")
    if os.path.exists(path):
        return read_safetensors(path)
    path = os.path.join(directory, "pytorch_model.bin")
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    raise FileNotFoundError(f"no model.safetensors or pytorch_model.bin in {directory}")


def encoder_config_from_hf(config: Mapping[str, Any]) -> Dict[str, Any]:
    """A Bert / Roberta ``config.json`` (as a dict) -> ``TransformerEncoder``
    keywords, with ``BertConfig``'s defaults for absent keys; RoBERTa's
    positions start at pad id + 1."""
    is_roberta = config.get("model_type", "bert") == "roberta"
    pad = config.get("pad_token_id", 1 if is_roberta else 0)
    return dict(
        vocab_size=config.get("vocab_size", 30522),
        hidden_dim=config.get("hidden_size", 768),
        num_layers=config.get("num_hidden_layers", 12),
        num_heads=config.get("num_attention_heads", 12),
        intermediate_dim=config.get("intermediate_size", 3072),
        max_position=config.get("max_position_embeddings", 512),
        type_vocab_size=config.get("type_vocab_size", 2),
        dropout=config.get("hidden_dropout_prob", 0.1),
        layer_norm_eps=config.get("layer_norm_eps", 1e-12),
        pad_token_id=pad or 0,
        position_offset=pad + 1 if is_roberta else 0,
    )


def load_hf_torch_weights(directory: str, weights: Optional[Mapping[str, torch.Tensor]] = None
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(state dict of a TransformerEncoder, its keywords)`` from a local
    Hugging Face checkpoint directory of a BertModel / RobertaModel (or a
    model with one as its base: the ``bert.`` / ``roberta.`` prefix is
    stripped and the pooler and the LM / classification heads are left out,
    as ``AutoModel`` does; old ``LayerNorm.gamma`` / ``beta`` names are
    read as ``weight`` / ``bias``).  ``weights``: the directory's state
    dict when it is already read.  Tensors come back float32 on the CPU."""
    with open(os.path.join(directory, "config.json")) as f:
        kwargs = encoder_config_from_hf(json.load(f))
    sd = {}
    for name, t in (_read_weights(directory) if weights is None else weights).items():
        for prefix in _HF_PREFIXES:
            if name.startswith(prefix):
                name = name[len(prefix):]
        if name.startswith(_HF_IGNORED):
            continue
        if ".LayerNorm." in name:
            name = name.replace(".gamma", ".weight").replace(".beta", ".bias")
        sd[name] = t
    state = {ours: sd[theirs].to(torch.float32).contiguous()
             for ours, theirs in hf_names(kwargs["num_layers"]).items()}
    return state, kwargs


def _hf_config(encoder_kwargs: Mapping[str, Any], architecture: str,
               model_type: str) -> Dict[str, Any]:
    return {
        "architectures": [architecture],
        "model_type": model_type,
        "vocab_size": encoder_kwargs["vocab_size"],
        "hidden_size": encoder_kwargs.get("hidden_dim", 768),
        "num_hidden_layers": encoder_kwargs.get("num_layers", 12),
        "num_attention_heads": encoder_kwargs.get("num_heads", 12),
        "intermediate_size": encoder_kwargs.get("intermediate_dim", 3072),
        "hidden_act": "gelu",
        "max_position_embeddings": encoder_kwargs.get("max_position", 512),
        "type_vocab_size": encoder_kwargs.get("type_vocab_size", 2),
        "hidden_dropout_prob": encoder_kwargs.get("dropout", 0.1),
        "attention_probs_dropout_prob": encoder_kwargs.get("dropout", 0.1),
        "layer_norm_eps": encoder_kwargs.get("layer_norm_eps", 1e-12),
        "pad_token_id": encoder_kwargs.get("pad_token_id", 0),
        "position_embedding_type": "absolute",
        "initializer_range": 0.02,
    }


def _hf_state(state: Mapping[str, torch.Tensor], num_layers: int,
              prefix: str = "") -> Dict[str, torch.Tensor]:
    return {prefix + theirs: state[ours].detach().to("cpu", torch.float32).contiguous().clone()
            for ours, theirs in hf_names(num_layers).items()}


def _write_hf(config: Mapping[str, Any], sd: Mapping[str, torch.Tensor], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    torch.save(dict(sd), os.path.join(out_dir, "pytorch_model.bin"))
    return out_dir


def save_as_hf_bert(state: Mapping[str, torch.Tensor], encoder_kwargs: Mapping[str, Any],
                    out_dir: str) -> str:
    """Write a ``TransformerEncoder``'s state dict as a ``BertModel``-layout
    checkpoint directory (``config.json`` and ``pytorch_model.bin``, no
    pooler) that ``load_hf_torch_weights`` of either package reads back;
    the inverse of ``load_hf_torch_weights``."""
    return _write_hf(_hf_config(encoder_kwargs, "BertModel", "bert"),
                     _hf_state(state, encoder_kwargs.get("num_layers", 12)), out_dir)


# ---------------- sequence classification ----------------

# the head of a BertForSequenceClassification / RobertaForSequenceClassification
# checkpoint, by the port's names: ``pre`` (the pooler's dense, RoBERTa's
# classifier.dense) then tanh, then ``out``
HF_CLASSIFIER_HEADS = {
    "bert": {"pre": "bert.pooler.dense", "out": "classifier"},
    "roberta": {"pre": "classifier.dense", "out": "classifier.out_proj"},
}


class SequenceClassifier(nn.Module):
    """A BERT / RoBERTa sequence classifier: the tower, then on the first
    token's vector ``pre`` (dense), tanh and ``out`` (dense to the labels)
    -> ``(U, num_labels)`` logits; BERT's pooler and classifier and
    RoBERTa's classification head are the same function without
    dropout."""

    def __init__(self, encoder_kwargs: Mapping[str, Any], num_labels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = TransformerEncoder(**encoder_kwargs, generator=generator)
        d = self.encoder.hidden_dim
        self.pre = Dense(d, d, generator)
        self.out = Dense(d, num_labels, generator)

    def forward(self, tokens: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        hidden = self.encoder(tokens, mask)
        return self.out(torch.tanh(self.pre(hidden[:, 0])))


def load_hf_classifier(directory: str) -> Tuple[SequenceClassifier, Dict[str, Any]]:
    """``(SequenceClassifier on the CPU, config.json)`` from a local
    ``BertForSequenceClassification`` / ``RobertaForSequenceClassification``
    checkpoint directory (``config.json`` and ``model.safetensors`` or
    ``pytorch_model.bin``); nothing is fetched."""
    with open(os.path.join(directory, "config.json")) as f:
        config = json.load(f)
    model_type = config.get("model_type", "bert")
    if model_type not in HF_CLASSIFIER_HEADS:
        raise ValueError(f"{directory}: model_type {model_type!r} is not a BERT or RoBERTa "
                         "sequence classifier")
    weights = _read_weights(directory)
    state, kwargs = load_hf_torch_weights(directory, weights)
    num_labels = len(config.get("id2label") or {}) or config.get("num_labels", 2)
    model = SequenceClassifier(kwargs, num_labels)
    model.encoder.load_state_dict(state)
    for ours, theirs in HF_CLASSIFIER_HEADS[model_type].items():
        for leaf in ("weight", "bias"):
            name = f"{theirs}.{leaf}"
            if name not in weights:
                raise KeyError(f"{directory} holds no {name}: not a sequence classifier")
            getattr(getattr(model, ours), leaf).data.copy_(weights[name].float())
    return model.eval(), config


def save_as_hf_classifier(model: SequenceClassifier, encoder_kwargs: Mapping[str, Any],
                          id2label: Mapping[int, str], out_dir: str,
                          model_type: str = "bert") -> str:
    """Write ``model`` as a ``BertForSequenceClassification`` (``model_type``
    "bert") or ``RobertaForSequenceClassification`` ("roberta") checkpoint
    directory with the labels ``id2label`` (the inverse of
    ``load_hf_classifier``; ``transformers`` loads it too)."""
    architecture = {"bert": "BertForSequenceClassification",
                    "roberta": "RobertaForSequenceClassification"}[model_type]
    config = _hf_config(encoder_kwargs, architecture, model_type)
    config.update(id2label={str(i): l for i, l in id2label.items()},
                  label2id={l: int(i) for i, l in id2label.items()})
    if model_type == "roberta":
        config.update(bos_token_id=0, eos_token_id=2)
    sd = _hf_state(model.encoder.state_dict(), encoder_kwargs.get("num_layers", 12),
                   f"{model_type}.")
    for ours, theirs in HF_CLASSIFIER_HEADS[model_type].items():
        for leaf in ("weight", "bias"):
            sd[f"{theirs}.{leaf}"] = getattr(getattr(model, ours), leaf).detach().to(
                "cpu", torch.float32).contiguous().clone()
    return _write_hf(config, sd, out_dir)
