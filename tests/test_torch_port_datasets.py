"""The port's Adressa and xMIND data paths against the JAX package's on the CPU.

* The fixture generators (``write_adressa_fixture``, ``write_adressa_statfix``
  at reduced size, ``write_mind_fixture``, ``write_xmind_statfix``) write the
  same files: the Adressa tar's member names and bytes (its gzip header holds
  the time of writing), every other file byte for byte.
* The Adressa ETL from one tar: ``news.tsv``, ``nid2index.tsv``, the map TSVs,
  the behaviors files and ``news_store.npz`` byte-identical; the ``NewsStore``
  and the ``Impressions`` of every split equal array for array; the same
  ``vocab_size``, ``num_users`` and ``num_classes``; tars with missing,
  quoted and NA-string titles included.  The committed ``data/adressa_demo``
  caches, read by the port from a copy, give what a fresh ETL of a copy of
  its tar gives.
* The host parser (``data/fastetl.py``): native and Python routes and the
  JAX package's, on the same lines, equal (the native case skips only
  without ``g++``).
* xMIND on ``write_mind_fixture``'s data with a ``write_xmind_statfix``
  companion: the store, the extended vocabulary, the extended matrix,
  bilingual-train and zero-shot-test ``Impressions`` and ``load_data_info``
  equal the JAX package's (exactly; the matrices within 0).
* ``train.setup_data`` routes the ``adressa_statfix``, ``adressa_demo``,
  ``mind_demo`` and ``xmind_statfix`` data nodes, generating their fixtures.

Nothing is written under ``data/``; nothing is downloaded.
"""

import filecmp
import io
import json
import os
import shutil
import tarfile
from pathlib import Path

import numpy as np
import pytest

from newsreclib_tpu.data import adressa as jadressa
from newsreclib_tpu.data import fastetl as jfastetl
from newsreclib_tpu.data import mind as jmind
from newsreclib_tpu.data import statfix as jstatfix
from newsreclib_tpu.data import testing as jtesting
from newsreclib_tpu.data import xmind as jxmind
from newsreclib_tpu.models import factory as jfactory
from newsreclib_tpu_torch.data import adressa, fastetl, statfix, testing, xmind
from newsreclib_tpu_torch.data import download
from newsreclib_tpu_torch.data import mind as tmind
from newsreclib_tpu_torch.models import factory
from tests.test_torch_port_data import (
    IMP_FIELDS,
    SMALL_STATFIX,
    assert_same_impressions,
    assert_same_store,
)

ROOT = Path(__file__).resolve().parents[1]
ADRESSA_DEMO = ROOT / "data" / "adressa_demo"
SMALL_ADRESSA = dict(num_news=300, events_per_day=2000)
ADRESSA_FILES = ("news.tsv", "nid2index.tsv", "word2index.tsv", "categ2index.tsv",
                 "subcateg2index.tsv", "sentiment2index.tsv", "behaviors_42.tsv",
                 "dev/behaviors_42.tsv", "test/behaviors_42.tsv", "news_store.npz",
                 "news_store.npz.nids.json")


def tar_members(path: Path):
    with tarfile.open(path, "r:gz") as tar:
        return [(m.name, m.size, tar.extractfile(m).read()) for m in tar.getmembers()]


def edge_case_tar(path: Path) -> None:
    """A one_week tar whose titles are missing, empty, NA strings, quoted
    or non-ASCII, with a line that is no JSON and an event of an unknown
    article; one user with every article clicked (no negative pool)."""
    titles = ["NA", "", '"Quoted" start of a title', "null", "Ærlig talt, øl!",
              "plain title words here", 'mid "quote" title', "nan", "N/A",
              "the final day"]
    lines_by_day = {d: [] for d in range(1, 8)}
    rng = np.random.default_rng(3)
    for d in range(1, 8):
        for k in range(30):
            a = int(rng.integers(0, len(titles)))
            lines_by_day[d].append(json.dumps({
                "id": f"a{a}", "title": titles[a], "category1": "nyheter|innenriks"
                if a % 2 else "sport", "userId": f"cx:{int(rng.integers(0, 6))}",
                "time": 1483225200 + d * 86400 + k}))
        lines_by_day[d].append("not json at all")
        lines_by_day[d].append(json.dumps({"id": "x", "userId": "cx:9", "time": 1}))
    for a in range(len(titles)):  # user cx:99 clicks everything on day 7
        lines_by_day[7].append(json.dumps({"id": f"a{a}", "title": titles[a],
                                           "category1": "sport", "userId": "cx:99",
                                           "time": 1483225200 + 7 * 86400 + a}))
    with tarfile.open(path, "w:gz") as tar:
        for d, lines in lines_by_day.items():
            blob = ("\n".join(lines) + "\n").encode("utf-8")
            info = tarfile.TarInfo(name=f"one_week/2017010{d}")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))


@pytest.fixture(scope="module")
def glove(tmp_path_factory) -> Path:
    """The fixture vocabulary's GloVe file (``write_mind_fixture``'s)."""
    d = tmp_path_factory.mktemp("glove")
    testing.write_mind_fixture(str(d))
    return d / "glove_demo.txt"


# ------------------------------------------------------------ generators

def test_adressa_fixture_writers_write_the_same_tar_members(tmp_path):
    jtesting.write_adressa_fixture(str(tmp_path / "jax"))
    path = testing.write_adressa_fixture(str(tmp_path / "port"))
    assert path == str(tmp_path / "port" / "one_week.tar.gz")
    want = tar_members(tmp_path / "jax" / "one_week.tar.gz")
    assert [m[0] for m in want] == [f"one_week/2017010{d}" for d in range(1, 8)]
    assert tar_members(Path(path)) == want


def test_adressa_statfix_writers_write_the_same_tar_members(tmp_path):
    jstatfix.write_adressa_statfix(str(tmp_path / "jax"), **SMALL_ADRESSA)
    statfix.write_adressa_statfix(str(tmp_path / "port"), **SMALL_ADRESSA)
    want = tar_members(tmp_path / "jax" / "one_week.tar.gz")
    assert len(want) == 7 and all(m[2].count(b"\n") == 2000 for m in want)
    assert tar_members(tmp_path / "port" / "one_week.tar.gz") == want


def test_mind_and_xmind_fixture_writers_write_the_same_files(tmp_path):
    for side, (mind_writer, xmind_writer) in {
            "jax": (jtesting.write_mind_fixture, jstatfix.write_xmind_statfix),
            "port": (testing.write_mind_fixture, statfix.write_xmind_statfix)}.items():
        d = tmp_path / side
        mind_writer(str(d), dataset_size="small")
        shutil.copy(d / "glove_demo.txt", d / "glove_statfix.txt")
        xmind_writer(str(d), lang="fin")
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                   if p.is_file())
    assert len(files) == 11  # 2 x 3 MIND files, 2 GloVe, 2 translated news, aligned
    for rel in files:
        assert filecmp.cmp(tmp_path / "jax" / rel, tmp_path / "port" / rel, shallow=False), rel
    head = (tmp_path / "port" / "xMIND" / "fin" / "train" / "news.tsv").read_text().split("\t")
    assert head[0] == "N1" and head[1].startswith("fin_")


# ------------------------------------------------------------ Adressa ETL

def _both_etls(tmp_path: Path, make_tar, **kw):
    """The JAX and port ``AdressaData`` on copies of one tar."""
    make_tar(tmp_path / "src")
    out = []
    for side, module in (("jax", jadressa), ("port", adressa)):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(tmp_path / "src" / "one_week.tar.gz", d)
        cfg = module.AdressaConfig(data_dir=str(d), **kw)
        out.append(module.AdressaData(cfg))
    return out


TARS = {
    "demo": lambda d: (d.mkdir(), shutil.copy(ADRESSA_DEMO / "one_week.tar.gz", d)),
    "statfix": lambda d: statfix.write_adressa_statfix(str(d), **SMALL_ADRESSA),
    "edge_cases": lambda d: (d.mkdir(), edge_case_tar(d / "one_week.tar.gz")),
}


@pytest.mark.parametrize("tar", sorted(TARS))
def test_adressa_etl_matches_jax(tmp_path, tar, glove):
    kw = dict(neg_num=10 if tar == "demo" else 20, word_embeddings_fpath=str(glove))
    jdata, tdata = _both_etls(tmp_path, TARS[tar], **kw)
    jstore, tstore = jdata.news_store(), tdata.news_store()
    assert_same_store(jstore, tstore)
    assert tstore.abstract is None and tstore.title_entities is None
    for split in ("train", "val", "test"):
        assert_same_impressions(jdata.impressions(split), tdata.impressions(split))
    assert tdata.vocab_size() == jdata.vocab_size()
    assert tdata.num_users() == jdata.num_users()
    assert tdata.num_classes() == jdata.num_classes()
    for rel in ADRESSA_FILES:
        a = tmp_path / "jax" / "Adressa_one_week" / rel
        assert filecmp.cmp(a, tmp_path / "port" / "Adressa_one_week" / rel, shallow=False), rel
    for name in ("word", "categ"):
        rel = f"Adressa_one_week/transformed_{name}_embeddings.npy"
        np.testing.assert_array_equal(np.load(tmp_path / "port" / rel),
                                      np.load(tmp_path / "jax" / rel))
    info = factory.load_data_info(tdata, {"name": "nrms"})
    jinfo = jfactory.load_data_info(jdata, {"name": "nrms"})
    for f in ("vocab_size", "num_users", "num_categories", "num_subcategories",
              "num_sent_classes", "entity_vocab_size"):
        assert getattr(info, f) == getattr(jinfo, f), f
    np.testing.assert_array_equal(info.pretrained_embeddings, jinfo.pretrained_embeddings)


def test_adressa_edge_case_titles_follow_the_pandas_rules(tmp_path):
    """Missing and NA-string titles are read back as missing (no tokens);
    every article keeps its row; the user who clicked everything has no
    impression."""
    _, tdata = _both_etls(tmp_path, TARS["edge_cases"])
    store = tdata.news_store()
    assert store.num_news == 10
    news = (tmp_path / "port" / "Adressa_one_week" / "news.tsv").read_text().splitlines()
    empty = [row.split("\t")[0] for row in news
             if row.split("\t")[3] in ("", "NA", "null", "nan", "N/A")]
    assert len(empty) == 5
    assert all(not store.title[store.nid2row[n]].any() for n in empty)
    users = {int(u) - 1 for s in ("train", "val", "test")
             for u in tdata.impressions(s).user_idx}
    with open(tmp_path / "port" / "Adressa_one_week" / "behaviors_42.tsv") as f:
        uids = {line.split("\t")[0] for line in f}
    assert len(users) <= 6 and "U6" not in uids


def test_committed_adressa_demo_caches_match_a_fresh_etl(tmp_path):
    """The committed caches (read from a copy) and a fresh port ETL of a
    copy of the tar: the same store, impressions and sizes."""
    shutil.copytree(ADRESSA_DEMO, tmp_path / "committed")
    (tmp_path / "fresh").mkdir()
    shutil.copy(ADRESSA_DEMO / "one_week.tar.gz", tmp_path / "fresh")
    cached, fresh = (adressa.AdressaData(adressa.AdressaConfig(
        data_dir=str(tmp_path / d), neg_num=10)) for d in ("committed", "fresh"))
    assert_same_store(cached.news_store(), fresh.news_store())
    for split in ("train", "val", "test"):
        assert_same_impressions(cached.impressions(split), fresh.impressions(split))
    assert cached.vocab_size() == fresh.vocab_size() == 52
    assert cached.num_users() == fresh.num_users()
    assert cached.num_classes() == fresh.num_classes()
    for rel in ADRESSA_FILES:
        a = tmp_path / "committed" / "Adressa_one_week" / rel
        assert filecmp.cmp(a, tmp_path / "fresh" / "Adressa_one_week" / rel,
                           shallow=False), rel


def test_adressa_refuses_plm_mode_and_a_missing_tar(tmp_path):
    """PLM mode with a tokenizer that is not a local directory (the
    config's ``NbAiLab/nb-bert-base``) is refused when the store is built;
    a missing tar, when it is read."""
    (tmp_path / "plm").mkdir()
    shutil.copy(ADRESSA_DEMO / "one_week.tar.gz", tmp_path / "plm")
    data = adressa.AdressaData(adressa.AdressaConfig(
        data_dir=str(tmp_path / "plm"), use_plm=True, plm_tokenizer="NbAiLab/nb-bert-base"))
    with pytest.raises(FileNotFoundError, match="not a local directory.*fetches nothing"):
        data.news_store()
    with pytest.raises(FileNotFoundError, match="download disabled"):
        adressa.AdressaData(adressa.AdressaConfig(data_dir=str(tmp_path))).prepare_raw()


# ------------------------------------------------------------ fastetl

LINES = {
    "ids": ["N1 N2 N3", "", "  N4   N999 N2 ", "N5"],
    "impressions": ["N1-1 N2-0 N3-0", "N4-0", "bad N7- -1 N2-1  N999-0", "N5-1 N1-0 N2-0 N3-0"],
    "texts": ["the team wins, the market falls!", "", "ærlig talt; øl | 2017 ...",
              "under_score and-dash?"],
}
NIDS = {f"N{i}": i for i in range(1, 8)}
VOCAB = {w: i for i, w in enumerate(
    "the team wins , market falls ! ærlig talt ; øl | 2017 . under_score and dash ?".split(), 1)}


def _routes(tmp_path, monkeypatch, native: bool):
    """(port StrMap, JAX StrMap) constructors on the chosen route; the JAX
    library is built into ``tmp_path``, not beside its source."""
    if native and shutil.which("g++") is None:
        pytest.skip("no g++: the native route cannot be built")
    monkeypatch.setattr(jfastetl, "_LIB_PATH", str(tmp_path / "libfastetl.so"))
    monkeypatch.setattr(jfastetl, "_lib", None)
    monkeypatch.setattr(jfastetl, "_lib_tried", not native)
    if native:
        assert fastetl.get_lib() is not None and jfastetl.get_lib() is not None
    else:
        _python_route(monkeypatch)
    return fastetl.StrMap, jfastetl.StrMap


def _python_route(monkeypatch):
    """The port's host ETL on its pure-Python route for the rest of the test."""
    monkeypatch.setattr(fastetl, "_lib", None)
    monkeypatch.setattr(fastetl, "_lib_tried", True)


@pytest.mark.parametrize("route", ["native", "python"])
def test_fastetl_routes_match_jax(tmp_path, monkeypatch, route):
    port_map, jax_map = _routes(tmp_path, monkeypatch, route == "native")
    tn, jn = port_map(NIDS), jax_map(NIDS)
    assert tn.native == jn.native == (route == "native")
    for cap in (2, 8):
        got = fastetl.parse_id_lists(LINES["ids"], tn, cap=cap)
        want = jfastetl.parse_id_lists(LINES["ids"], jn, cap=cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        got = fastetl.parse_impressions(LINES["impressions"], tn, cap=cap)
        want = jfastetl.parse_impressions(LINES["impressions"], jn, cap=cap)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    tv, jv = port_map(VOCAB), jax_map(VOCAB)
    got = fastetl.tokenize_ids(LINES["texts"], tv, cap=12)
    want = jfastetl.tokenize_ids(LINES["texts"], jv, cap=12)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[1][2] == 9  # "ærlig talt ; øl | 2017 . . ." -> 9 tokens


def test_fastetl_native_and_python_routes_agree_on_adressa_behaviors(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native route cannot be built")
    statfix.write_adressa_statfix(str(tmp_path), **SMALL_ADRESSA)
    data = adressa.AdressaData(adressa.AdressaConfig(data_dir=str(tmp_path)))
    assert fastetl.get_lib() is not None
    assert str(fastetl.library_path()).startswith(str(ROOT / "build"))
    native = {split: data.impressions(split) for split in ("train", "val", "test")}
    _python_route(monkeypatch)
    for split in ("train", "val", "test"):
        python = data.impressions(split)
        for f in IMP_FIELDS:
            np.testing.assert_array_equal(getattr(native[split], f), getattr(python, f),
                                          err_msg=f)


def test_fastetl_falls_back_to_python_with_a_warning(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(fastetl, "_lib", None)
    monkeypatch.setattr(fastetl, "_lib_tried", False)
    monkeypatch.setattr(fastetl, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with caplog.at_level("WARNING", logger="newsreclib_tpu_torch"):
        assert fastetl.get_lib() is None
    assert "Python route" in caplog.text
    m = fastetl.StrMap(NIDS)
    assert not m.native
    rows, lens = fastetl.parse_id_lists(LINES["ids"], m, cap=4)
    assert lens.tolist() == [3, 0, 3, 1]


def test_extract_unpacks_local_archives(tmp_path):
    src = tmp_path / "src"
    (src / "sub").mkdir(parents=True)
    (src / "sub" / "a.txt").write_text("alpha")
    shutil.make_archive(str(tmp_path / "arch"), "gztar", src)
    shutil.make_archive(str(tmp_path / "arch"), "zip", src)
    for name in ("arch.tar.gz", "arch.zip"):
        dst = tmp_path / f"out_{name}"
        download.extract(str(tmp_path / name), str(dst))
        assert (dst / "sub" / "a.txt").read_text() == "alpha"
    with pytest.raises(ValueError, match="unknown archive format"):
        download.extract(str(tmp_path / "src" / "sub" / "a.txt"), str(tmp_path / "x"))
    # an existing destination is never fetched again
    assert download.maybe_download("http://localhost:9/none", str(src / "sub" / "a.txt")) == \
        str(src / "sub" / "a.txt")


# ------------------------------------------------------------ xMIND

@pytest.fixture(scope="module")
def xmind_dirs(tmp_path_factory):
    """``write_mind_fixture``'s data at size ``small`` with its
    ``write_xmind_statfix`` companion, one copy for each package."""
    src = tmp_path_factory.mktemp("xmind_src")
    testing.write_mind_fixture(str(src), dataset_size="small")
    shutil.copy(src / "glove_demo.txt", src / "glove_statfix.txt")
    statfix.write_xmind_statfix(str(src), lang="fin")
    out = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp(f"xmind_{side}")
        shutil.copytree(src, d, dirs_exist_ok=True)
        out[side] = d
    return out


def _xmind_pair(dirs, **xcfg):
    out = []
    for side, mmod, xmod in (("jax", jmind, jxmind), ("port", tmind, xmind)):
        d = dirs[side]
        mind = mmod.MINDData(mmod.MINDConfig(
            data_dir=str(d), dataset_size="small", word_embeddings_fpath=str(
                d / "glove_statfix.txt"), seed=42))
        out.append(xmod.XMINDData(mind, xmod.XMINDConfig(seed=42, **xcfg)))
    return out


@pytest.mark.parametrize("mode", ["zeroshot", "bilingual"])
def test_xmind_matches_jax(xmind_dirs, mode):
    """The CLI's order of calls: the train store, the data info (extended
    vocabulary and matrix), train / val impressions, the test store and
    impressions."""
    jx, tx = _xmind_pair(xmind_dirs, bilingual_train=mode == "bilingual")
    assert_same_store(jx.news_store("train"), tx.news_store("train"))
    jinfo = jfactory.load_data_info(jx, {"name": "nrms"})
    info = factory.load_data_info(tx, {"name": "nrms"})
    assert info.vocab_size == jinfo.vocab_size > tx.mind.vocab_size()
    assert (info.num_users, info.num_categories) == (jinfo.num_users, jinfo.num_categories)
    assert info.pretrained_embeddings.shape == (info.vocab_size, 300)
    np.testing.assert_array_equal(info.pretrained_embeddings, jinfo.pretrained_embeddings)
    assert tx._ensure_extended_vocab() == jx._ensure_extended_vocab()
    for split in ("train", "val"):
        assert_same_impressions(jx.impressions(split), tx.impressions(split))
    assert_same_store(jx.news_store("test"), tx.news_store("test"))
    test_imp = tx.impressions("test")
    assert_same_impressions(jx.impressions("test"), test_imp)
    n_base = len(tx.mind.news_store("train").nid2row)
    assert (test_imp.cand_flat > n_base).mean() > 0.5  # zero-shot: translated candidates
    train_imp = tx.impressions("train")
    assert ((train_imp.cand_flat > n_base).any()) == (mode == "bilingual")
    lang = xmind_dirs["port"] / "xMIND" / "fin"
    for rel in ("word2index.tsv", "word2index.meta.json",
                "transformed_word_embeddings.npy.meta.json"):
        assert filecmp.cmp(lang / rel, xmind_dirs["jax"] / "xMIND" / "fin" / rel,
                           shallow=False), rel


def test_xmind_caches_are_reused_and_invalidated(xmind_dirs, tmp_path):
    """A second object reads the extended vocabulary and matrix back; a
    changed base vocabulary fingerprint rebuilds them."""
    _, first = _xmind_pair(xmind_dirs)
    first.news_store("train")
    d = first.ensure_word_embeddings()
    matrix = np.load(os.path.join(d, "transformed_word_embeddings.npy"))
    _, again = _xmind_pair(xmind_dirs)
    assert again._ensure_extended_vocab() == first._ensure_extended_vocab()
    assert again.ensure_word_embeddings() == d
    np.testing.assert_array_equal(np.load(os.path.join(d, "transformed_word_embeddings.npy")),
                                  matrix)
    assert xmind.XMINDData._base_fingerprint({"a": 1, "b": 2}) != \
        xmind.XMINDData._base_fingerprint({"b": 1, "a": 2})


# ------------------------------------------------------------ CLI routing

def _compose(node, data_dir, *extra):
    from newsreclib_tpu_torch.config.compose import compose

    return compose(overrides=[f"data={node}", "platform=cpu", f"data.data_dir={data_dir}",
                              *extra])


def test_setup_data_routes_the_adressa_nodes(tmp_path, monkeypatch):
    """``adressa_statfix`` writes ``write_adressa_statfix``'s tar at its
    default seed 0 (as the repository's ``train.py``; reduced size here),
    ``adressa_demo`` (``generate_fixture: true``) ``write_adressa_fixture``'s;
    an existing tar is never overwritten; ``three_month`` takes the node's
    week splits and reads ``three_month.tar.gz``."""
    from newsreclib_tpu_torch import train

    def small_statfix(data_dir):
        return real(data_dir, **SMALL_ADRESSA)

    real = statfix.write_adressa_statfix
    monkeypatch.setattr(statfix, "write_adressa_statfix", small_statfix)
    data = train.setup_data(_compose("adressa_statfix", tmp_path / "sf"))
    assert isinstance(data, adressa.AdressaData) and data.cfg.neg_num == 20
    jstatfix.write_adressa_statfix(str(tmp_path / "jsf"), seed=0, **SMALL_ADRESSA)
    assert tar_members(tmp_path / "sf" / "one_week.tar.gz") == tar_members(
        tmp_path / "jsf" / "one_week.tar.gz")
    assert data.news_store().num_news == 300

    data = train.setup_data(_compose("adressa_demo", tmp_path / "demo"))
    assert data.cfg.neg_num == 10 and data.cfg.seed == 42
    assert tar_members(tmp_path / "demo" / "one_week.tar.gz") == tar_members(
        ADRESSA_DEMO / "one_week.tar.gz")
    before = (tmp_path / "demo" / "one_week.tar.gz").stat().st_mtime_ns
    train.setup_data(_compose("adressa_demo", tmp_path / "demo"))
    assert (tmp_path / "demo" / "one_week.tar.gz").stat().st_mtime_ns == before
    data = train.setup_data(_compose("adressa_demo", tmp_path / "tm",
                                     "data.dataset_size=three_month",
                                     "data.train_date_split=4", "data.test_date_split=5"))
    assert (data.cfg.dataset_size, data.cfg.train_date_split, data.cfg.test_date_split) == (
        "three_month", 4, 5)
    assert data._tar_path() == str(tmp_path / "tm" / "three_month.tar.gz")


def test_setup_data_routes_the_mind_demo_and_xmind_statfix_nodes(tmp_path, monkeypatch):
    """``mind_demo`` (``generate_fixture: true``) writes
    ``write_mind_fixture``'s files; ``xmind_statfix`` writes the MIND
    statfix fixture (reduced size) and its xMIND companion."""
    from newsreclib_tpu_torch import train

    mind = train.setup_data(_compose("mind_demo", tmp_path / "md"))
    assert isinstance(mind, tmind.MINDData)
    jtesting.write_mind_fixture(str(tmp_path / "jmd"), dataset_size="demo")
    for rel in ("MINDdemo_train/news.tsv", "MINDdemo_dev/behaviors.tsv", "glove_demo.txt"):
        assert filecmp.cmp(tmp_path / "md" / rel, tmp_path / "jmd" / rel, shallow=False), rel

    for name, value in SMALL_STATFIX.items():
        monkeypatch.setattr(statfix, name, value)
    d = tmp_path / "xsf"
    data = train.setup_data(_compose("xmind_statfix", d,
                                     f"data.word_embeddings_fpath={d / 'glove_statfix.txt'}"))
    assert isinstance(data, xmind.XMINDData) and data.cfg.tgt_lang == "fin"
    assert not data.cfg.bilingual_train and data.cfg.pct_tgt_lang_test == 1.0
    for rel in ("MINDsmall_train/news.tsv", "xMIND/fin/train/news.tsv",
                "xMIND/fin/dev/news.tsv", "xMIND/fin/aligned_embeddings.txt"):
        assert (d / rel).exists(), rel
    store = data.news_store("train")
    assert store.num_news == 2 * SMALL_STATFIX["TRAIN_NEWS"]
