"""PLM-mode tokenisation through the port's ETL and CLI against the JAX
package on the CPU, and Adressa's three_month data.

* MIND (``write_mind_fixture``) and Adressa (``data/adressa_demo``'s tar) in
  PLM mode with the same tokenizer directory (both kinds of
  ``write_fixture_tokenizer``): ``news_store_plm.npz`` and every other file
  the ETL writes byte for byte, the stores array for array (titles and, for
  MIND, abstracts at ``tokenizer_max_len``), the word-level store beside it.
* Adressa three_month from a tar written here, with events over five ISO
  weeks and the date splits set as week numbers: every file byte for byte,
  the store and the impressions of every split array for array.
* The slice as a whole: a tiny BERT (``pytorch_model.bin``) beside a
  WordPiece fixture tokenizer, as ``tests/test_plm_data.py`` builds it; the
  first train batch of both packages' ETL and batcher equal, its scores
  and CE loss within float32 1e-5; the port's CLI in PLM mode ends with a
  finite ``train/loss`` and a ``test/mrr``.
* The refusals: a tokenizer that is not a local directory, an unsupported
  tokenizer model, xMIND in PLM mode and a token id at or above the tower's
  vocabulary, each named.

Nothing is written under ``data/``; nothing is downloaded.
"""

import filecmp
import io
import json
import shutil
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from newsreclib_tpu.data import adressa as jadressa
from newsreclib_tpu.data import batching as jbatching
from newsreclib_tpu.data import mind as jmind
from newsreclib_tpu.models.components import losses as jlosses
from newsreclib_tpu_torch import train as ttrain
from newsreclib_tpu_torch.data import adressa, batching, testing
from newsreclib_tpu_torch.data import mind as tmind
from newsreclib_tpu_torch.data.batch import to_device
from newsreclib_tpu_torch.models.components import losses
from tests.test_torch_port_data import assert_same_impressions, assert_same_store
from tests.test_torch_port_datasets import ADRESSA_DEMO, ADRESSA_FILES
from tests.test_torch_port_plm import both_routes
from tests.test_torch_port_plm_tokenizer import TEXTS
from tests.test_torch_port_zoo import few_torch_threads  # noqa: F401 (fixture)

TOKENIZER_MAX_LEN = 24
KINDS = ("wordpiece", "bpe")


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """Both fixture kinds from the demo texts; the WordPiece one with a tiny
    BERT beside it (its vocabulary the tokenizer's)."""
    from transformers import BertConfig, BertModel

    root = tmp_path_factory.mktemp("plm_tokenizers")
    dirs = {kind: Path(testing.write_fixture_tokenizer(str(root / kind), TEXTS["demo"], kind,
                                                       size))
            for kind, size in (("wordpiece", 200), ("bpe", 350))}
    vocab = len((dirs["wordpiece"] / "vocab.txt").read_text().splitlines())
    torch.manual_seed(0)
    BertModel(BertConfig(vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_position_embeddings=40, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0)).save_pretrained(
        str(dirs["wordpiece"]), safe_serialization=False)
    return dirs


def _same_files(a: Path, b: Path):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for rel in files:
        assert filecmp.cmp(a / rel, b / rel, shallow=False), rel
    return files


def _mind_pair(tmp_path, tokenizer, **kw):
    """The JAX and the port ``MINDData`` in PLM mode on copies of one
    ``write_mind_fixture``."""
    testing.write_mind_fixture(str(tmp_path / "src"), num_news=60, num_train_behaviors=60,
                               num_dev_behaviors=30)
    out = []
    for side, module in (("jax", jmind), ("port", tmind)):
        shutil.copytree(tmp_path / "src", tmp_path / side)
        out.append(module.MINDData(module.MINDConfig(
            data_dir=str(tmp_path / side), dataset_size="demo", use_plm=True,
            plm_tokenizer=str(tokenizer), tokenizer_max_len=TOKENIZER_MAX_LEN, **kw)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_mind_plm_store_matches_jax(tokenizers, tmp_path, kind):
    jdata, tdata = _mind_pair(tmp_path, tokenizers[kind])
    for split in ("train", "test"):
        jstore, tstore = jdata.news_store(split), tdata.news_store(split)
        assert_same_store(jstore, tstore)
        assert tstore.title.shape[1] == tstore.abstract.shape[1] == TOKENIZER_MAX_LEN
    for split in ("train", "val", "test"):
        assert_same_impressions(jdata.impressions(split), tdata.impressions(split))
    files = _same_files(tmp_path / "jax", tmp_path / "port")
    assert Path("MINDdemo_train/news_store_plm.npz") in files
    assert Path("MINDdemo_dev/news_store_plm.npz") in files
    assert not any(f.name == "news_store.npz" for f in files)
    assert tdata.plm_tokenize_seconds > 0
    # the word-level store beside it, as without PLM mode
    word = tmind.MINDData(tmind.MINDConfig(data_dir=str(tmp_path / "port"),
                                           dataset_size="demo"))
    assert word.news_store("train").title.shape[1] == 30
    assert (tmp_path / "port" / "MINDdemo_train" / "news_store.npz").exists()


@pytest.mark.parametrize("kind", KINDS)
def test_adressa_plm_store_matches_jax(tokenizers, tmp_path, kind):
    out = []
    for side, module in (("jax", jadressa), ("port", adressa)):
        (tmp_path / side).mkdir()
        shutil.copy(ADRESSA_DEMO / "one_week.tar.gz", tmp_path / side)
        out.append(module.AdressaData(module.AdressaConfig(
            data_dir=str(tmp_path / side), neg_num=10, use_plm=True,
            plm_tokenizer=str(tokenizers[kind]), tokenizer_max_len=TOKENIZER_MAX_LEN)))
    jdata, tdata = out
    jstore, tstore = jdata.news_store(), tdata.news_store()
    assert_same_store(jstore, tstore)
    assert tstore.title.shape[1] == TOKENIZER_MAX_LEN and tstore.abstract is None
    for split in ("train", "val", "test"):
        assert_same_impressions(jdata.impressions(split), tdata.impressions(split))
    files = _same_files(tmp_path / "jax" / "Adressa_one_week",
                        tmp_path / "port" / "Adressa_one_week")
    assert Path("news_store_plm.npz") in files and Path("news_store.npz") not in files


def three_month_tar(path: Path, weeks=5, events_per_day=40, num_news=50, num_users=20,
                    seed=0) -> None:
    """A three_month tar of newline-JSON events from 2017-01-02 (a Monday,
    ISO week 1) over ``weeks`` weeks, one member per week, plus events of
    2017-01-01 (ISO week 52 of 2016)."""
    rng = np.random.default_rng(seed)
    titles = [" ".join(rng.choice(TEXTS["demo"][0].split(), size=int(rng.integers(3, 7))))
              for _ in range(num_news)]
    cats = ["nyheter|innenriks", "sport|fotball", "kultur", "okonomi|bolig"]
    start = 1483315200  # 2017-01-02 00:00 UTC
    members = {}
    for day in range(-1, 7 * weeks):
        name = f"three_month/2017_week{max(day, 0) // 7 + 1}"
        for _ in range(events_per_day):
            a = int(rng.integers(0, num_news))
            members.setdefault(name, []).append(json.dumps({
                "id": f"art{a}", "title": titles[a], "category1": cats[a % len(cats)],
                "userId": f"cx:{int(rng.integers(0, num_users))}",
                "time": int(start + day * 86400 + rng.integers(0, 86400))}))
    with tarfile.open(path, "w:gz") as tar:
        for name, lines in members.items():
            blob = ("\n".join(lines) + "\n").encode("utf-8")
            info = tarfile.TarInfo(name=name)
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


@pytest.mark.parametrize("use_plm", [False, True], ids=["words", "plm"])
def test_adressa_three_month_matches_jax(tokenizers, tmp_path, use_plm):
    """Events dated by their ISO week: weeks 1-3 history, week 4 train,
    week 5 (and 2016's week 52) test."""
    three_month_tar(tmp_path / "three_month.tar.gz")
    kw = dict(dataset_size="three_month", train_date_split=4, test_date_split=5, neg_num=10)
    if use_plm:
        kw.update(use_plm=True, plm_tokenizer=str(tokenizers["wordpiece"]),
                  tokenizer_max_len=TOKENIZER_MAX_LEN)
    out = []
    for side, module in (("jax", jadressa), ("port", adressa)):
        (tmp_path / side).mkdir()
        shutil.copy(tmp_path / "three_month.tar.gz", tmp_path / side)
        out.append(module.AdressaData(module.AdressaConfig(data_dir=str(tmp_path / side), **kw)))
    jdata, tdata = out
    assert_same_store(jdata.news_store(), tdata.news_store())
    sizes = {}
    for split in ("train", "val", "test"):
        jimp, timp = jdata.impressions(split), tdata.impressions(split)
        assert_same_impressions(jimp, timp)
        sizes[split] = len(timp)
    assert all(n > 0 for n in sizes.values()), sizes
    assert tdata.vocab_size() == jdata.vocab_size()
    assert tdata.num_users() == jdata.num_users()
    assert tdata.num_classes() == jdata.num_classes()
    root = "Adressa_three_month"
    files = _same_files(tmp_path / "jax" / root, tmp_path / "port" / root)
    store = "news_store_plm.npz" if use_plm else "news_store.npz"
    assert {Path(f.replace("news_store.npz", store)) for f in ADRESSA_FILES} <= set(files)
    # history, train and test clicks split by week
    train_hist = (tmp_path / "port" / root / "behaviors_42.tsv").read_text().splitlines()
    assert train_hist and all(len(line.split("\t")) == 3 for line in train_hist)


# ------------------------------------------------------------ the slice as a whole

def test_first_plm_batch_matches_jax(tokenizers, tmp_path):
    """The tiny BERT beside the WordPiece tokenizer: each package's ETL and
    ``TrainBatcher`` give the same first batch; NRMS over the tower (the
    port's factory and the JAX one load the same checkpoint) gives the same
    scores and CE loss (float32 1e-5)."""
    tok = tokenizers["wordpiece"]
    jdata, tdata = _mind_pair(tmp_path, tok)
    kw = dict(batch_size=4, max_history_len=6, u_bucket_min=64, split_title_len=16, seed=0)
    jb = next(iter(jbatching.TrainBatcher(jdata.news_store("train"),
                                          jdata.impressions("train"), **kw).epoch(0)))
    tb = next(iter(batching.TrainBatcher(tdata.news_store("train"),
                                         tdata.impressions("train"), **kw).epoch(0)))
    for f, want in jb._asdict().items():
        got = getattr(tb, f)
        if f in ("news", "news2"):
            assert (want is None) == (got is None), f
            if want is not None:
                for name, w in want._asdict().items():
                    g = getattr(got, name)
                    assert (w is None) == (g is None), name
                    if w is not None:
                        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), name)
        elif want is not None:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=f)
    assert jb.news.title.max() > 5  # the tokenizer's ids, not word ids
    jm, params, tm = both_routes("nrms", jb, str(tok))
    jscores, _ = jm.apply({"params": params}, jax.tree.map(jnp.asarray, jb))
    jloss = jlosses.cross_entropy_loss(jscores, jnp.asarray(jb.labels),
                                       jnp.asarray(jb.cand_mask),
                                       jnp.asarray(jb.impression_valid))
    batch = to_device(tb, "cpu")
    with torch.no_grad():
        tscores, _ = tm(batch)
        tloss = losses.cross_entropy_loss(tscores, batch.labels, batch.cand_mask,
                                          batch.impression_valid)
    np.testing.assert_allclose(tscores.numpy(), np.asarray(jscores), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)


def _plm_cli_args(tmp_path, tokenizer, *extra):
    from tests.test_torch_port_cli import demo_copy

    data = demo_copy(tmp_path / "data")
    return ["experiment=nrms_demo", "platform=cpu", f"data.data_dir={data}",
            f"data.word_embeddings_fpath={data / 'glove_demo.txt'}",
            f"output_dir={tmp_path / 'run'}", "trainer.max_epochs=1",
            "trainer.limit_train_batches=3", "data.use_plm=true",
            f"data.plm_tokenizer={tokenizer}", f"data.tokenizer_max_len={TOKENIZER_MAX_LEN}",
            "model.use_plm=true", f"model.plm_model={tokenizer}", "model.embed_dim=32",
            "model.num_heads=4", "model.query_dim=16", *extra]


def test_cli_trains_in_plm_mode_on_the_cpu(tokenizers, tmp_path):
    metrics = ttrain.main(_plm_cli_args(tmp_path, tokenizers["wordpiece"]))
    assert np.isfinite(metrics["train/loss"]) and "test/mrr" in metrics
    assert all(np.isfinite(v) for v in metrics.values())
    split = tmp_path / "data" / "MINDdemo_train"
    assert (split / "news_store_plm.npz").exists() and not (split / "news_store.npz").exists()


@pytest.mark.parametrize("case", ["not_local", "unsupported_model", "xmind", "token_range",
                                  "token_range_ckpt"])
def test_plm_mode_refusals_name_their_cause(tokenizers, tmp_path, monkeypatch, case):
    tok = tokenizers["wordpiece"]
    if case == "not_local":
        import socket

        def no_network(*a, **k):
            raise AssertionError("a network call was made")

        monkeypatch.setattr(socket.socket, "connect", no_network)
        args = _plm_cli_args(tmp_path, "roberta-base")
        err, match = FileNotFoundError, "'roberta-base' is not a local directory"
    elif case == "unsupported_model":
        bad = tmp_path / "unigram"
        shutil.copytree(tok, bad)
        spec = json.loads((bad / "tokenizer.json").read_text())
        spec["model"] = {"type": "Unigram", "unk_id": 0, "vocab": [["[UNK]", 0.0]]}
        (bad / "tokenizer.json").write_text(json.dumps(spec))
        args = _plm_cli_args(tmp_path, bad)
        err, match = ValueError, "unsupported tokenizer model 'Unigram'"
    elif case == "xmind":
        args = _plm_cli_args(tmp_path, tok, "data.dataset=xmind")
        err, match = NotImplementedError, "xMIND in PLM mode"
    elif case == "token_range":
        args = _plm_cli_args(tmp_path, tok, "model.plm_model=__random_init__",
                             "model.plm_vocab_size=20")
        err, match = ValueError, r"not below the PLM tower's vocabulary of 20 \(model.plm_voc"
    else:
        small = tmp_path / "small_bert"
        small.mkdir()
        cfg = json.loads((tok / "config.json").read_text())
        (small / "config.json").write_text(json.dumps(dict(cfg, vocab_size=30)))
        args = _plm_cli_args(tmp_path, tok, f"model.plm_model={small}")
        err, match = ValueError, "vocabulary of 30 .*small_bert/config.json"
    with pytest.raises(err, match=match):
        ttrain.main(args)
    assert (tmp_path / "run" / "error.log").exists()
