"""The port's small entry points and utilities against the JAX package's on
the CPU:

* ``utils/timing.py::timeit_pipelined`` and ``utils/profiling.py::
  StepTimer`` under a monkeypatched clock give the JAX helpers' numbers for
  the same sequence of times;
* ``utils/profiling.py::trace`` writes a Chrome trace on the CPU that holds
  an ``annotate`` range;
* ``cli.py``'s console scripts dispatch to the port's ``train``, ``eval``
  and ``sweep`` modules, named as the JAX package's, and ``pyproject.toml``
  declares them;
* ``data/sentiment.py::BERTSentimentAnnotator`` (the port's tokenizer
  reader and tower, no ``transformers``) against the JAX package's
  ``transformers`` pipeline on local RoBERTa and BERT classifiers, built by
  ``transformers`` and by the port's ``write_fixture_classifier``: the same
  labels, scores within 1e-5, on texts that include empty, missing and
  over-long ones.
"""

import json
import re
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.data import sentiment as jsentiment
from newsreclib_tpu.utils import profiling as jprofiling
from newsreclib_tpu.utils import timing as jtiming
from newsreclib_tpu_torch import cli
from newsreclib_tpu_torch.data import sentiment, testing
from newsreclib_tpu_torch.utils import profiling, timing

ROOT = Path(__file__).resolve().parents[1]


def clock(times):
    """A clock that reads ``times`` in turn."""
    it = iter(times)
    return lambda: next(it)


# ------------------------------------------------------------------ timing

@pytest.mark.parametrize("steps,warmup", [(20, 2), (5, 0), (2, 1)])
def test_timeit_pipelined_matches_jax_under_a_fixed_clock(monkeypatch, steps, warmup):
    """The same readings of the clock give the same seconds per call: the
    best of 3 one-call runs, the best of 2 ``steps``-call runs, their
    difference over ``steps - 1``; ``fn`` runs as often in both."""
    readings = list(np.cumsum(np.random.default_rng(steps).uniform(0.001, 0.5, size=10)))
    calls = {"jax": 0, "port": 0}

    def jfn(x):
        calls["jax"] += 1
        return {"out": jnp.asarray(x) * 2}

    def tfn(x):
        calls["port"] += 1
        return {"out": torch.as_tensor(x) * 2}

    jtiming._fetch(jfn(np.ones(3, np.float32)))  # compiled before the clock is fixed
    calls["jax"] = 0
    monkeypatch.setattr(jtiming.time, "time", clock(readings))
    want = jtiming.timeit_pipelined(jfn, np.ones(3, np.float32), steps=steps, warmup=warmup)
    monkeypatch.setattr(timing.time, "perf_counter", clock(readings))
    got = timing.timeit_pipelined(tfn, np.ones(3, np.float32), steps=steps, warmup=warmup)
    assert got == want
    assert calls["port"] == calls["jax"] == warmup + 3 + 2 * steps


def test_timeit_pipelined_on_the_cpu_is_wall_time():
    """Without a monkeypatched clock: a call that sleeps 2 ms takes about
    that, and outputs without a tensor are accepted."""
    assert 0.0015 < timing.timeit_pipelined(lambda: time.sleep(0.002), steps=6) < 0.05
    assert timing._first_tensor(([None, {"a": torch.zeros(1)}],)) is not None
    assert timing._first_tensor((1, "x")) is None


def test_step_timer_matches_jax_under_a_fixed_clock(monkeypatch, caplog):
    readings = list(np.cumsum(np.random.default_rng(3).uniform(1e-4, 0.2, size=14)))
    summaries = []
    for timer in (jprofiling.StepTimer(), profiling.StepTimer()):
        monkeypatch.setattr(time, "perf_counter", clock(readings))
        for name in ("batch", "step", "batch", "log", "step", "step", "batch"):
            with timer.phase(name):
                pass
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert list(summaries[1]) == ["batch", "log", "step"]
    assert summaries[1]["step"]["count"] == 3
    lines = []
    for timer, logger in ((jprofiling, "newsreclib_tpu"), (profiling, "newsreclib_tpu_torch")):
        caplog.clear()
        with caplog.at_level("INFO", logger=logger):
            t = timer.StepTimer()
            t._totals.update({k: v["total_s"] for k, v in summaries[0].items()})
            t._counts.update({k: v["count"] for k, v in summaries[0].items()})
            t.log_summary()
        lines.append([r.getMessage() for r in caplog.records if r.name == logger])
    assert lines[0] == lines[1] and len(lines[1]) == 3


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path, caplog):
    with caplog.at_level("INFO", logger="newsreclib_tpu_torch"):
        with profiling.trace(str(tmp_path / "trace")) as prof:
            with profiling.annotate("port_annotated_range"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "port_annotated_range" for e in events)
    assert any("mm" in e.get("name", "") for e in events)
    assert any(str(files[0]) in r.getMessage() for r in caplog.records)
    assert any(e.key == "port_annotated_range" for e in prof.key_averages())


# --------------------------------------------------------------------- cli

def test_cli_commands_dispatch_to_the_port_modules(monkeypatch):
    from newsreclib_tpu import cli as jcli
    from newsreclib_tpu_torch import eval as teval
    from newsreclib_tpu_torch import sweep as tsweep
    from newsreclib_tpu_torch import train as ttrain

    called = []
    for module in (ttrain, teval, tsweep):
        monkeypatch.setattr(module, "main", lambda m=module: called.append(m.__name__))
    names = [n for n in dir(jcli) if n.endswith("_command")]
    assert sorted(names) == sorted(cli.COMMANDS) == ["eval_command", "sweep_command",
                                                      "train_command"]
    for name in names:
        getattr(cli, name)()
    assert called == [cli.COMMANDS[n] for n in names]
    assert called == [f"newsreclib_tpu_torch.{n.split('_')[0]}" for n in names]


def test_pyproject_declares_the_port_scripts_beside_the_jax_ones():
    text = (ROOT / "pyproject.toml").read_text()
    scripts = dict(re.findall(r'^(newsreclib-[\w-]+) = "([\w.:]+)"$', text, re.M))
    for command in ("train", "eval", "sweep"):
        assert scripts[f"newsreclib-{command}"] == f"newsreclib_tpu.cli:{command}_command"
        assert scripts[f"newsreclib-torch-{command}"] == \
            f"newsreclib_tpu_torch.cli:{command}_command"
    assert len(scripts) == 6


# --------------------------------------------------------------- annotator

def demo_texts():
    texts = []
    for split in ("MINDdemo_train", "MINDdemo_dev"):
        with open(ROOT / "data" / "demo" / split / "news.tsv", encoding="utf-8") as f:
            for line in f:
                texts += line.rstrip("\n").split("\t")[3:5]
    return texts


MAX_LEN = 32


def queries():
    texts = demo_texts()
    rng = np.random.default_rng(0)
    picked = [texts[i] for i in rng.choice(len(texts), 40, replace=False)]
    return picked + ["", None, " ".join(texts[:40]), "Great WIN for the team!!! " * 20]


def hf_classifier(out_dir: Path, kind: str, num_labels: int) -> Path:
    """A tiny random ``RobertaForSequenceClassification`` (bpe) or
    ``BertForSequenceClassification`` (wordpiece) saved by ``transformers``
    beside the fixture tokenizer of ``kind``."""
    import transformers

    from newsreclib_tpu_torch.data.plm_tokenizer import load_tokenizer

    testing.write_fixture_tokenizer(str(out_dir), demo_texts(), kind, 400)
    config_path = out_dir / "tokenizer_config.json"
    config = json.loads(config_path.read_text())
    config["model_max_length"] = MAX_LEN
    config_path.write_text(json.dumps(config))
    vocab = load_tokenizer(str(out_dir)).max_id() + 1
    labels = testing.FIXTURE_LABELS[num_labels]
    common = dict(vocab_size=vocab, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                  intermediate_size=64, num_labels=num_labels,
                  id2label=dict(enumerate(labels)), label2id={l: i for i, l in enumerate(labels)},
                  initializer_range=0.3)
    torch.manual_seed(num_labels)
    if kind == "bpe":
        cfg = transformers.RobertaConfig(max_position_embeddings=MAX_LEN + 2, pad_token_id=1,
                                         bos_token_id=0, eos_token_id=2, type_vocab_size=1,
                                         layer_norm_eps=1e-5, **common)
        model = transformers.RobertaForSequenceClassification(cfg)
    else:
        cfg = transformers.BertConfig(max_position_embeddings=MAX_LEN, pad_token_id=0, **common)
        model = transformers.BertForSequenceClassification(cfg)
    model.save_pretrained(str(out_dir))
    return out_dir


def assert_same_annotations(directory: Path):
    texts = queries()
    want = jsentiment.BERTSentimentAnnotator(model_name=str(directory), device="cpu",
                                             batch_size=8).annotate_many(texts)
    port = sentiment.BERTSentimentAnnotator(model_name=str(directory), device="cpu",
                                            batch_size=8)
    got = port.annotate_many(texts)
    probs = torch.cat([port._probabilities([t if isinstance(t, str) else ""])
                       for t in texts])
    top2 = probs.topk(min(2, probs.shape[1]), dim=1).values
    margin = (top2[:, 0] - top2[:, 1]) if probs.shape[1] > 1 else torch.ones(len(texts))
    clear = margin > 1e-5
    assert clear.sum() >= len(texts) - 2
    assert len(got) == len(want) == len(texts)
    for i, ((gl, gs), (wl, ws)) in enumerate(zip(got, want)):
        if clear[i]:
            assert gl == wl, (i, texts[i])
            assert gs == pytest.approx(ws, abs=1e-5), (i, texts[i])
    assert {l for l, _ in got} <= {"negative", "neutral", "positive"}
    # truncation at model_max_length: the over-long texts keep MAX_LEN ids
    assert len(port._tokenizer.encode(texts[-2], port._max_len)) == MAX_LEN
    return got


@pytest.mark.parametrize("kind,num_labels", [("bpe", 3), ("wordpiece", 2), ("wordpiece", 1),
                                             ("bpe", 2)])
def test_bert_annotator_matches_the_transformers_pipeline(tmp_path, kind, num_labels):
    got = assert_same_annotations(hf_classifier(tmp_path / "clf", kind, num_labels))
    if num_labels == 1:  # sigmoid of one logit: the label's class, a score in (0, 1)
        assert all(l == "neutral" and 0 < s < 1 for l, s in got)


@pytest.mark.parametrize("kind", ["bpe", "wordpiece"])
def test_port_written_classifier_matches_the_transformers_pipeline(tmp_path, kind):
    """``write_fixture_classifier`` (the smoke's writer) gives a directory
    that ``transformers`` loads and that both annotators read alike."""
    d = testing.write_fixture_classifier(str(tmp_path / "clf"), demo_texts(), kind,
                                         num_labels=3, hidden_dim=32, num_heads=4,
                                         intermediate_dim=64, max_len=MAX_LEN, vocab_size=400)
    got = assert_same_annotations(Path(d))
    assert len({l for l, _ in got}) >= 1


def test_bert_annotator_fetches_nothing_and_defaults_to_the_card(tmp_path):
    import inspect

    missing = tmp_path / "no_such_model"
    with pytest.raises(FileNotFoundError, match=re.escape(str(missing))):
        sentiment.BERTSentimentAnnotator(model_name=str(missing), device="cpu")
    with pytest.raises(FileNotFoundError, match="cardiffnlp"):
        sentiment.get_annotator("bert", device="cpu")
    default = inspect.signature(sentiment.BERTSentimentAnnotator).parameters["device"].default
    assert default == "cuda"
    if not torch.cuda.is_available():
        d = testing.write_fixture_classifier(str(tmp_path / "clf"), demo_texts()[:50], "bpe",
                                             hidden_dim=16, num_heads=2, intermediate_dim=32)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sentiment.BERTSentimentAnnotator(model_name=d)


def test_cli_passes_the_platform_to_the_bert_annotator():
    from newsreclib_tpu_torch import train
    from newsreclib_tpu_torch.config.compose import compose

    cfg = compose(overrides=["experiment=nrms_demo", "data.sentiment_annotator=bert",
                             "platform=cpu"])
    assert train.annotator_kwargs(cfg) == {"device": "cpu"}
    cfg["data"]["sentiment_annotator_kwargs"] = {"model_name": "/m", "batch_size": 4}
    assert train.annotator_kwargs(cfg) == {"model_name": "/m", "batch_size": 4,
                                           "device": "cpu"}
    cfg["data"]["sentiment_annotator"] = "lexicon"
    assert train.annotator_kwargs(cfg) == {"model_name": "/m", "batch_size": 4}
    assert train.annotator_kwargs(compose(overrides=["experiment=nrms_demo"])) == {}
