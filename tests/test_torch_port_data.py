"""The port's pandas-free MIND data path against the JAX package's on the CPU.

* The statfix generator: the JAX and port modules, with their size
  constants monkeypatched to the same small values, write byte-identical
  files for a seed.
* The ETL: on a copy of the raw ``data/demo`` files, on a reduced statfix
  fixture and on raw files with quoting and NA edge cases, each split's
  ``NewsStore`` (every array, ``nid2row``) and ``Impressions`` equal the
  JAX ``MINDData``'s exactly, as do ``vocab_size``, ``num_users``,
  ``num_classes`` and the transformed GloVe and entity matrices (within 0);
  the cache files both write are byte-identical.
* The committed ``data/demo`` caches (read from copies) give the port what
  they give the JAX package, and what a fresh ETL gives but for the entity
  columns, which they hold from an older entity rule.

Nothing is written under ``data/``.
"""

import filecmp
import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from newsreclib_tpu.data import mind as jmind
from newsreclib_tpu.data import statfix as jstatfix
from newsreclib_tpu_torch.data import mind as tmind
from newsreclib_tpu_torch.data import news_store as tnews_store
from newsreclib_tpu_torch.data import statfix as tstatfix

ROOT = Path(__file__).resolve().parents[1]
DEMO = ROOT / "data" / "demo"
RAW_FILES = ("news.tsv", "behaviors.tsv", "entity_embedding.vec")
SMALL_STATFIX = dict(TRAIN_NEWS=600, TRAIN_BEHAVIORS=400, DEV_BEHAVIORS=200, N_USERS=150,
                     SIG_WORDS_PER_CAT=40, COMMON_WORDS=200, N_ENTITIES=100)
STORE_FIELDS = ("title", "abstract", "category", "subcategory", "sentiment",
                "sentiment_score", "title_entities", "abstract_entities")
IMP_FIELDS = ("hist_flat", "hist_offsets", "cand_flat", "cand_offsets", "labels_flat",
              "user_idx", "user_ids")


def copy_raw(src: Path, dst: Path, size: str) -> None:
    """The raw MIND files of ``src`` (no caches) and its GloVe file under ``dst``."""
    for split in ("train", "dev"):
        d = dst / f"MIND{size}_{split}"
        d.mkdir(parents=True)
        for name in RAW_FILES:
            if (src / d.name / name).exists():
                shutil.copy(src / d.name / name, d / name)
    for glove in src.glob("glove_*.txt"):
        shutil.copy(glove, dst / glove.name)


def small_statfix(monkeypatch, data_dir: Path) -> None:
    for module in (jstatfix, tstatfix):
        for name, value in SMALL_STATFIX.items():
            monkeypatch.setattr(module, name, value)
    tstatfix.write_mind_small_statfix(str(data_dir), seed=7)


def configs(data_dir: Path, size: str, glove: str):
    kw = dict(data_dir=str(data_dir), dataset_size=size, max_title_len=30,
              word_embeddings_fpath=str(data_dir / glove), seed=42)
    return jmind.MINDConfig(**kw), tmind.MINDConfig(**kw)


def assert_same_store(a, b):
    assert a.nid2row == b.nid2row
    for f in STORE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def assert_same_impressions(a, b):
    for f in IMP_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f)


def assert_same_data(jdata, tdata):
    for split in ("train", "test"):
        assert_same_store(jdata.news_store(split), tdata.news_store(split))
    for split in ("train", "val", "test"):
        assert_same_impressions(jdata.impressions(split), tdata.impressions(split))
    assert jdata.vocab_size() == tdata.vocab_size()
    assert jdata.num_users() == tdata.num_users()
    assert jdata.num_classes() == tdata.num_classes()
    for name in ("word", "entity"):
        path = f"transformed_{name}_embeddings.npy"
        j = Path(jdata.split_dir("train")) / path
        t = Path(tdata.split_dir("train")) / path
        assert j.exists() == t.exists()
        if j.exists():
            np.testing.assert_array_equal(np.load(j), np.load(t))  # within 0


def assert_same_cache_files(jdir: Path, tdir: Path):
    """Every TSV / JSON / npy cache the two ETLs wrote is byte-identical;
    the npz archives hold equal arrays."""
    jfiles = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    assert jfiles == tfiles
    for rel in jfiles:
        if rel.suffix == ".npz":
            with np.load(jdir / rel) as a, np.load(tdir / rel) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
        else:
            assert filecmp.cmp(jdir / rel, tdir / rel, shallow=False), rel


def run_both(tmp_path, src: Path, size: str, glove: str):
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        copy_raw(src, d, size)
    jcfg, _ = configs(jdir, size, glove)
    _, tcfg = configs(tdir, size, glove)
    jdata, tdata = jmind.MINDData(jcfg), tmind.MINDData(tcfg)
    assert_same_data(jdata, tdata)
    assert_same_cache_files(jdir, tdir)
    return jdir, tdir


def test_statfix_generators_write_identical_files(tmp_path, monkeypatch):
    for module in (jstatfix, tstatfix):
        for name, value in SMALL_STATFIX.items():
            monkeypatch.setattr(module, name, value)
    jstatfix.write_mind_small_statfix(str(tmp_path / "jax"), seed=7)
    tstatfix.write_mind_small_statfix(str(tmp_path / "port"), seed=7)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 7  # 2 x (news, behaviors, entity vectors) + GloVe
    for rel in files:
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel, shallow=False), rel
    news = (tmp_path / "port" / "MINDsmall_train" / "news.tsv").read_text().splitlines()
    assert len(news) == SMALL_STATFIX["TRAIN_NEWS"]


def test_demo_etl_matches_jax(tmp_path):
    run_both(tmp_path, DEMO, "demo", "glove_demo.txt")


def test_statfix_etl_matches_jax(tmp_path, monkeypatch):
    src = tmp_path / "raw"
    small_statfix(monkeypatch, src)
    run_both(tmp_path, src, "small", "glove_statfix.txt")


EDGE_NEWS = [
    # a field opened by a quote is quoted: "" is one quote, text after the
    # closing quote is kept
    'N9001\tnews\tmarkets\t"Stocks ""rally"" win" great\t"a\tb" abstract\turl\t[]\t[]',
    # NA strings: missing title, abstract, entities
    'N9002\tsports\tfootball\tNA\tnull\turl\tnan\tN/A',
    'N9003\tnews\tmarkets\tnull\t\turl\t\t',
    # quotes inside an unquoted field are literal
    'N9004\tnews\tmarkets\tHe said "war" is bad\tNone\turl\t[]\t[]',
    # a quoted field spanning two lines
    'N9005\tnews\tmarkets\t"first line\nsecond line win"\tok\turl\t[]\t[]',
    # words the id maps read back as NA
    'N9006\tnews\tmarkets\tnan null none n/a\tNaN fear\turl\t[]\t[]',
    # a short row: the missing columns are NA
    'N9007\tnews\tmarkets\tshort row',
]


def test_etl_quoting_and_na_fields_match_jax(tmp_path):
    src = tmp_path / "raw"
    copy_raw(DEMO, src, "demo")
    for split in ("train", "dev"):
        news = src / f"MINDdemo_{split}" / "news.tsv"
        news.write_text(news.read_text() + "\n".join(EDGE_NEWS) + "\n")
        bhv = src / f"MINDdemo_{split}" / "behaviors.tsv"
        lines = bhv.read_text().splitlines()
        uid, t = lines[0].split("\t")[1:3]
        extra = [f"9001\t{uid}\t{t}\tN9001 N9002 N9005\tN9003-1 N9004-0 N9006-0 N9007-1",
                 f"9002\tU777\t{t}\tNA\tN9001-1 N9002-0",  # no history: dropped
                 f"9003\tU778\t{t}\tN9006 N404\tN9005-0 N405-1"]  # unknown ids -> row 0
        bhv.write_text("\n".join(lines + extra) + "\n")
    jdir, tdir = run_both(tmp_path, src, "demo", "glove_demo.txt")
    store = tmind.MINDData(configs(tdir, "demo", "glove_demo.txt")[1]).news_store("train")
    assert {"N9001", "N9005", "N9007"} <= set(store.nid2row)
    # the quoted title kept its quotes and the text after the closing one;
    # the words "nan" and "null" read back as one NaN key
    words = tmind._load_idx_map(str(tdir / "MINDdemo_train" / "word2index.tsv"))
    assert {"rally", "great", "line"} <= set(words) and "nan" not in words
    assert tmind.MINDData(configs(tdir, "demo", "glove_demo.txt")[1]).vocab_size() == len(words) + 1


ENTITY_FIELDS = ("title_entities", "abstract_entities")


def test_committed_demo_caches_give_the_same_data(tmp_path):
    """The caches the JAX ETL wrote and the repository keeps, read from
    copies: the port reads them as the JAX package does (from the npz stores
    and, with those removed, from the parsed TSVs), and they equal the
    port's fresh ETL of the raw files but for the entity columns.  Those
    were cached under an older entity rule: ``entity2index.tsv`` holds 12
    entities, while the current rule (occurrences x confidence above the
    threshold) keeps none of the demo's, whose entities carry no
    ``OccurrenceOffsets``; the JAX ETL gives the same (``test_demo_etl_matches_jax``)."""
    jcached, tcached = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(DEMO, jcached)
    shutil.copytree(DEMO, tcached)
    fresh = tmp_path / "fresh"
    copy_raw(DEMO, fresh, "demo")
    jcfg = configs(jcached, "demo", "glove_demo.txt")[0]
    tcfg = configs(tcached, "demo", "glove_demo.txt")[1]
    assert os.path.exists(tcached / "MINDdemo_train" / "news_store.npz")
    assert_same_data(jmind.MINDData(jcfg), tmind.MINDData(tcfg))

    cached = tmind.MINDData(tcfg)
    new = tmind.MINDData(configs(fresh, "demo", "glove_demo.txt")[1])
    for split in ("train", "test"):
        a, b = cached.news_store(split), new.news_store(split)
        assert a.nid2row == b.nid2row
        for f in STORE_FIELDS:
            if f not in ENTITY_FIELDS:
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        n_entities = cached.num_classes()["entity"] - 1
        assert n_entities == 12
        for f in ENTITY_FIELDS:
            assert not getattr(b, f).any()
            assert getattr(a, f).max() <= n_entities
    for split in ("train", "val", "test"):
        assert_same_impressions(cached.impressions(split), new.impressions(split))
    assert (cached.vocab_size(), cached.num_users()) == (new.vocab_size(), new.num_users())
    assert ({k: v for k, v in cached.num_classes().items() if k != "entity"}
            == {k: v for k, v in new.num_classes().items() if k != "entity"})

    # the parsed TSV caches alone, without the npz stores
    for d in (jcached, tcached):
        for p in list(d.rglob("news_store.npz*")) + list(d.rglob("*impressions.npz")):
            p.unlink()
    assert_same_data(jmind.MINDData(jcfg), tmind.MINDData(tcfg))
    for split in ("train", "test"):
        assert_same_store(cached.news_store(split), tmind.MINDData(tcfg).news_store(split))


def test_news_store_save_load_and_trim(tmp_path):
    store = tnews_store.build_news_store(
        ["N1", "N2", "N3"], [[1, 2, 3], [4], []], max_title_len=30,
        tokenized_abstracts=[[5], [6, 7], []], max_abstract_len=20,
        categories=[1, 2, 1], sentiment_scores=[0.5, -0.25, 0.0],
        title_entities=[[9], [], [8, 7]], max_entities=4)
    assert store.num_news == 3 and store.title.shape == (4, 30)
    assert store.nid2row == {"N1": 1, "N2": 2, "N3": 3}
    store.save(str(tmp_path / "s.npz"))
    back = tnews_store.NewsStore.load(str(tmp_path / "s.npz"))
    assert_same_store(store, back)
    trimmed = store.trim_titles(margin=0)
    assert trimmed.title.shape == (4, 8) and trimmed.abstract.shape == (4, 8)
    np.testing.assert_array_equal(trimmed.title, store.title[:, :8])
    assert store.trim_titles(margin=6).title.shape == (4, 16)


def test_download_raises_without_raw_files(tmp_path):
    cfg = tmind.MINDConfig(data_dir=str(tmp_path), dataset_size="small", download=True)
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        tmind.MINDData(cfg).news_store("train")


def test_lexicon_annotator_matches_jax():
    from newsreclib_tpu.data.sentiment import get_annotator as jget
    from newsreclib_tpu_torch.data.sentiment import get_annotator as tget

    texts = ["A great win for the team", "War and crisis: bad news", "", None,
             "Stocks rally", "Best worst day"]
    assert tget("lexicon").annotate_many(texts) == jget("lexicon").annotate_many(texts)
    with pytest.raises(ValueError):
        tget("nope")
