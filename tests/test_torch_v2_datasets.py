"""The port's v2 datasets (``paddle_tpu_torch/v2/dataset/``): the port's
copy of ``tests/test_datasets.py`` (each module's real-format parse of a
tiny crafted archive in a tmp ``DATA_HOME``; the cache, ``split`` and
``cluster_files_reader``; ``download`` of a missing file raising, and
memoized), and the synthetic corpora against the JAX package's: with
both packages' ``DATA_HOME`` an empty tmp dir (and the JAX package's
``urlopen`` refused, so that nothing is fetched), every reader and
dictionary gives the JAX package's records, record for record, over the
first SYNTH_RECORDS records.
"""

import gzip
import io
import os
import pickle
import tarfile
import zipfile

import numpy as np
import pytest

from paddle_tpu_torch.v2.dataset import common


@pytest.fixture
def data_home(tmp_path, monkeypatch):
    """Point DATA_HOME at a tmp dir and clear every module-level memo."""
    monkeypatch.setattr(common, "DATA_HOME", str(tmp_path))
    monkeypatch.setattr(common, "_DOWNLOAD_MEMO", {})
    monkeypatch.setattr(common, "_VERIFIED", set())
    from paddle_tpu_torch.v2.dataset import imdb, movielens, uci_housing, sentiment

    monkeypatch.setattr(imdb, "_DICT_CACHE", {})
    monkeypatch.setattr(movielens, "_META", None)
    monkeypatch.setattr(uci_housing, "_DATA", {})
    monkeypatch.setattr(sentiment, "_CACHE", {})
    return tmp_path


def _put(tmp_path, module, fname, data: bytes):
    d = tmp_path / module
    d.mkdir(parents=True, exist_ok=True)
    (d / fname).write_bytes(data)
    return d / fname


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


def test_download_uses_cached_file_and_never_overwrites(data_home, capsys):
    p = _put(data_home, "m", "f.txt", b"fixture")
    got = common.download("http://example.invalid/f.txt", "m", "0" * 32)
    assert got == str(p)
    assert p.read_bytes() == b"fixture"  # not clobbered


def test_download_missing_offline_raises_and_memoizes(data_home):
    url = "http://127.0.0.1:9/nothing.bin"  # port 9: always refused
    with pytest.raises(RuntimeError):
        common.download(url, "m", "0" * 32, retry_limit=1)
    assert common.maybe_download(url, "m", "0" * 32) is None
    # memoized: second call must not retry (returns instantly)
    assert common.maybe_download(url, "m", "0" * 32) is None


def test_split_and_cluster_files_reader(data_home, tmp_path):
    recs = [(i, i * i) for i in range(10)]
    suffix = str(tmp_path / "chunk-%05d.pickle")
    common.split(lambda: iter(recs), 4, suffix=suffix)
    r0 = common.cluster_files_reader(str(tmp_path / "chunk-*.pickle"), 2, 0)
    r1 = common.cluster_files_reader(str(tmp_path / "chunk-*.pickle"), 2, 1)
    got = sorted(list(r0()) + list(r1()))
    assert got == recs


# ---------------------------------------------------------------------------
# cifar
# ---------------------------------------------------------------------------


def _cifar_tar(path, sub_names, n=3, nclass=10, key="labels"):
    with tarfile.open(path, "w:gz") as tf:
        for sub in sub_names:
            batch = {"data": (np.arange(n * 3072) % 255).reshape(n, 3072)
                     .astype(np.uint8),
                     key: list(range(n))}
            blob = pickle.dumps(batch, protocol=2)
            info = tarfile.TarInfo(f"cifar-10-batches-py/{sub}")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def test_cifar10_real_parse(data_home):
    from paddle_tpu_torch.v2.dataset import cifar

    _cifar_tar(str(_put(data_home, "cifar", "cifar-10-python.tar.gz",
                        b"").parent / "cifar-10-python.tar.gz"),
               ["data_batch_1", "data_batch_2"])
    recs = list(cifar.train10()())
    assert len(recs) == 6
    x, y = recs[0]
    assert x.shape == (3072,) and x.dtype == np.float32
    assert 0.0 <= x.min() and x.max() <= 1.0
    assert y == 0
    np.testing.assert_allclose(x[:4], np.arange(4) / 255.0, atol=1e-6)


def test_cifar_synth_fallback(data_home):
    from paddle_tpu_torch.v2.dataset import cifar

    recs = [next(iter(cifar.test10()())) for _ in range(2)]
    assert recs[0][0].shape == (3072,)
    np.testing.assert_array_equal(recs[0][0], recs[1][0])  # deterministic


# ---------------------------------------------------------------------------
# imdb
# ---------------------------------------------------------------------------


def _imdb_tar(path):
    docs = {
        "aclImdb/train/pos/0_9.txt": b"A great great movie, truly great!",
        "aclImdb/train/pos/1_8.txt": b"great fun; great cast.",
        "aclImdb/train/neg/0_2.txt": b"A bad bad film -- just bad!",
        "aclImdb/train/neg/1_1.txt": b"bad plot bad acting",
        "aclImdb/test/pos/0_10.txt": b"great great!",
        "aclImdb/test/neg/0_1.txt": b"bad.",
    }
    with tarfile.open(path, "w:gz") as tf:
        for name, blob in docs.items():
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def test_imdb_real_parse_and_corpus_dict(data_home):
    from paddle_tpu_torch.v2.dataset import imdb

    tar = data_home / "imdb" / "aclImdb_v1.tar.gz"
    tar.parent.mkdir(parents=True)
    _imdb_tar(str(tar))

    wd = imdb.word_dict(cutoff=0)
    # corpus-built: most frequent word first ('great' 7x, 'bad' 6x)
    assert wd["great"] == 0 and wd["bad"] == 1
    assert wd["<unk>"] == len(wd) - 1
    assert "w0" not in wd  # NOT the synthetic stand-in

    recs = list(imdb.train(wd)())
    assert len(recs) == 4
    seq, label = recs[0]
    assert label == 0 and wd["great"] in seq  # pos doc first, interleaved
    assert recs[1][1] == 1  # then neg


def test_imdb_synth_fallback(data_home):
    from paddle_tpu_torch.v2.dataset import imdb

    wd = imdb.word_dict()
    assert wd["<unk>"] == len(wd) - 1
    seq, label = next(iter(imdb.train()()))
    assert label in (0, 1) and all(isinstance(t, int) for t in seq)


# ---------------------------------------------------------------------------
# imikolov
# ---------------------------------------------------------------------------


def _imikolov_tar(path):
    train = b"the cat sat\nthe cat ran\n"
    valid = b"the dog sat\n"
    with tarfile.open(path, "w:gz") as tf:
        for name, blob in (("./simple-examples/data/ptb.train.txt", train),
                           ("./simple-examples/data/ptb.valid.txt", valid)):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def test_imikolov_real_parse(data_home):
    from paddle_tpu_torch.v2.dataset import imikolov

    tar = data_home / "imikolov" / "simple-examples.tgz"
    tar.parent.mkdir(parents=True)
    _imikolov_tar(str(tar))

    wd = imikolov.build_dict(min_word_freq=0)
    assert "the" in wd and "<unk>" in wd and wd["<unk>"] == len(wd) - 1
    # 'the' appears 3x -> most frequent real word
    assert wd["the"] == min(v for k, v in wd.items()
                            if k not in ("<s>", "<e>"))

    grams = list(imikolov.train(wd, 3)())
    # "<s> the cat sat <e>" -> 3 trigrams, "<s> the cat ran <e>" -> 3
    assert len(grams) == 6
    assert all(len(g) == 3 for g in grams)

    pairs = list(imikolov.test(wd, 0, imikolov.DataType.SEQ)())
    assert pairs[0][0][0] == wd["<s>"]
    assert pairs[0][1][-1] == wd["<e>"]


# ---------------------------------------------------------------------------
# uci_housing
# ---------------------------------------------------------------------------


def test_uci_housing_real_parse(data_home):
    rows = np.arange(10 * 14, dtype=np.float64).reshape(10, 14)
    blob = "\n".join(" ".join(f"{v:.4f}" for v in r) for r in rows)
    _put(data_home, "uci_housing", "housing.data", blob.encode())
    from paddle_tpu_torch.v2.dataset import uci_housing

    train = list(uci_housing.train()())
    test = list(uci_housing.test()())
    assert len(train) == 8 and len(test) == 2  # 80/20 split
    x, y = train[0]
    assert x.shape == (13,) and y.shape == (1,)
    # feature normalization: (x - mean) / (max - min); col 0 spans 0..126
    assert abs(float(x[0]) - (0.0 - 63.0) / 126.0) < 1e-5
    assert float(y[0]) == 13.0  # label column is NOT normalized


# ---------------------------------------------------------------------------
# movielens
# ---------------------------------------------------------------------------


def _ml_zip(path):
    movies = ("1::Toy Story (1995)::Animation|Children's|Comedy\n"
              "2::Jumanji (1995)::Adventure|Children's|Fantasy\n")
    users = ("1::F::1::10::48067\n"
             "2::M::56::16::70072\n")
    ratings = ("1::1::5::978300760\n"
               "2::1::3::978302109\n"
               "1::2::4::978301968\n"
               "2::2::2::978300275\n")
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("ml-1m/movies.dat", movies)
        z.writestr("ml-1m/users.dat", users)
        z.writestr("ml-1m/ratings.dat", ratings)


def test_movielens_real_parse(data_home):
    _ml_zip(str(_put(data_home, "movielens", "ml-1m.zip", b"").parent
                / "ml-1m.zip"))
    from paddle_tpu_torch.v2.dataset import movielens

    assert movielens.max_user_id() == 2
    assert movielens.max_movie_id() == 2
    assert movielens.max_job_id() == 16
    cats = movielens.movie_categories()
    assert "Animation" in cats and len(cats) == 5
    title_dict = movielens.get_movie_title_dict()
    assert "toy" in title_dict and "jumanji" in title_dict

    recs = list(movielens.train()()) + list(movielens.test()())
    assert len(recs) == 4
    uid, gender, age, job, mid, cat_ids, title_ids, rating = recs[0]
    assert gender in (0, 1) and 0 <= age < 7
    assert all(c in cats.values() for c in cat_ids)
    assert 1.0 <= rating <= 5.0


# ---------------------------------------------------------------------------
# wmt14
# ---------------------------------------------------------------------------


def _wmt_tar(path):
    src_dict = b"<s>\n<e>\n<unk>\nle\nchat\n"
    trg_dict = b"<s>\n<e>\n<unk>\nthe\ncat\n"
    train = b"le chat\tthe cat\n"
    test = b"le\tthe\n"
    with tarfile.open(path, "w:gz") as tf:
        for name, blob in (("wmt14/src.dict", src_dict),
                           ("wmt14/trg.dict", trg_dict),
                           ("wmt14/train/train", train),
                           ("wmt14/test/test", test)):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def test_wmt14_real_parse(data_home):
    _wmt_tar(str(_put(data_home, "wmt14", "wmt14.tgz", b"").parent
                 / "wmt14.tgz"))
    from paddle_tpu_torch.v2.dataset import wmt14

    src_dict, trg_dict = wmt14.get_dict(dict_size=5)
    assert src_dict["le"] == 3 and trg_dict["cat"] == 4

    recs = list(wmt14.train(dict_size=5)())
    assert len(recs) == 1
    src, trg_in, trg_next = recs[0]
    assert src == [0, 3, 4, 1]            # <s> le chat <e>
    assert trg_in == [0, 3, 4]            # <s> the cat
    assert trg_next == [3, 4, 1]          # the cat <e>


# ---------------------------------------------------------------------------
# conll05
# ---------------------------------------------------------------------------


def _conll_tar(path):
    # one sentence, one predicate 'ate' with A0/V/A1 spans
    words = b"The\ncat\nate\nfish\n\n"
    props = (b"-\t(A0*\n"
             b"-\t*)\n"
             b"ate\t(V*)\n"
             b"-\t(A1*)\n"
             b"\n")
    wbuf, pbuf = io.BytesIO(), io.BytesIO()
    with gzip.GzipFile(fileobj=wbuf, mode="wb") as g:
        g.write(words)
    with gzip.GzipFile(fileobj=pbuf, mode="wb") as g:
        g.write(props)
    with tarfile.open(path, "w:gz") as tf:
        for name, blob in (
                ("conll05st-release/test.wsj/words/test.wsj.words.gz",
                 wbuf.getvalue()),
                ("conll05st-release/test.wsj/props/test.wsj.props.gz",
                 pbuf.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def test_conll05_real_parse(data_home):
    _conll_tar(str(_put(data_home, "conll05st", "conll05st-tests.tar.gz",
                        b"").parent / "conll05st-tests.tar.gz"))
    from paddle_tpu_torch.v2.dataset import conll05

    triples = list(conll05.corpus_reader(
        common.cache_path("conll05st", "conll05st-tests.tar.gz"))())
    assert triples == [(["The", "cat", "ate", "fish"], "ate",
                        ["B-A0", "I-A0", "B-V", "B-A1"])]

    recs = list(conll05.test()())
    assert len(recs) == 1
    word, c2, c1, c0, p1, p2, verb, mark, label = recs[0]
    assert len(word) == 4 and len(label) == 4
    assert mark == [1, 1, 1, 1]  # window of 2 around verb idx 2 covers all
    assert len(set(verb)) == 1   # predicate id broadcast


# ---------------------------------------------------------------------------
# sentiment
# ---------------------------------------------------------------------------


def test_sentiment_real_parse(data_home):
    base = data_home / "sentiment" / "movie_reviews"
    for cls, text in (("pos", "a fine film"), ("neg", "a dire film")):
        d = base / cls
        d.mkdir(parents=True)
        (d / f"{cls}0.txt").write_text(text)
    from paddle_tpu_torch.v2.dataset import sentiment

    wd = dict(sentiment.get_word_dict())
    assert "film" in wd and "fine" in wd
    recs = list(sentiment.train()())
    assert len(recs) == 2
    # interleaved neg first (label 0), then pos (label 1)
    assert recs[0][1] == 0 and recs[1][1] == 1
    assert recs[0][0] != recs[1][0]


# ---------------------------------------------------------------------------
# mq2007
# ---------------------------------------------------------------------------


def test_mq2007_real_parse(data_home):
    lines = []
    for qid, rels in (("10", [2, 0]), ("11", [1, 1])):
        for i, rel in enumerate(rels):
            feats = " ".join(f"{k + 1}:{(k + i) / 10:.2f}" for k in range(46))
            lines.append(f"{rel} qid:{qid} {feats} #docid = d{i}")
    d = data_home / "MQ2007" / "Fold1"
    d.mkdir(parents=True)
    (d / "train.txt").write_text("\n".join(lines))
    from paddle_tpu_torch.v2.dataset import mq2007

    pts = list(mq2007.train(format="pointwise")())
    assert len(pts) == 4
    assert pts[0][0].shape == (46,) and pts[0][1] == 2.0

    pairs = list(mq2007.train(format="pairwise")())
    assert len(pairs) == 1  # only qid 10 has a strict preference
    hi, lo = pairs[0]
    np.testing.assert_allclose(hi[0], 0.0, atol=1e-6)  # rel-2 doc first
    np.testing.assert_allclose(lo[0], 0.1, atol=1e-6)

    lists = list(mq2007.train(format="listwise")())
    assert len(lists) == 2 and lists[0][0] == [2.0, 0.0]


# ---------------------------------------------------------------------------
# flowers / voc2012 (PIL + scipy paths)
# ---------------------------------------------------------------------------


def _jpg_bytes(color, size=(300, 280)):
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="JPEG")
    return buf.getvalue()


def test_flowers_real_parse(data_home):
    import scipy.io as scio

    fdir = data_home / "flowers"
    fdir.mkdir(parents=True)
    with tarfile.open(fdir / "102flowers.tgz", "w:gz") as tf:
        for i, color in ((1, (255, 0, 0)), (2, (0, 255, 0))):
            blob = _jpg_bytes(color)
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    scio.savemat(fdir / "imagelabels.mat",
                 {"labels": np.array([[5, 9]], np.uint8)})
    scio.savemat(fdir / "setid.mat",
                 {"tstid": np.array([[1, 2]], np.int32),
                  "trnid": np.array([[2]], np.int32),
                  "valid": np.array([[1]], np.int32)})
    from paddle_tpu_torch.v2.dataset import flowers

    recs = list(flowers.train()())
    assert len(recs) == 2
    x, y = recs[0]
    assert x.shape == (3 * 224 * 224,) and y == 4  # label 5 -> 0-based 4
    # first image is red: R-plane ~1, G-plane ~0
    assert x[:10].mean() > 0.8 and x[224 * 224: 224 * 224 + 10].mean() < 0.2
    assert [r[1] for r in flowers.test()()] == [8]


def test_voc2012_real_parse(data_home):
    from PIL import Image

    vdir = data_home / "voc2012"
    vdir.mkdir(parents=True)
    mask = Image.new("P", (20, 10))
    mask.putpixel((3, 3), 7)
    # full palette: stops PIL's PNG writer remapping sparse indices
    mask.putpalette(sum(([i, i, i] for i in range(256)), []))
    mbuf = io.BytesIO()
    mask.save(mbuf, format="PNG")
    with tarfile.open(vdir / "VOCtrainval_11-May-2012.tar", "w") as tf:
        for name, blob in (
                ("VOCdevkit/VOC2012/ImageSets/Segmentation/trainval.txt",
                 b"2007_000001\n"),
                ("VOCdevkit/VOC2012/JPEGImages/2007_000001.jpg",
                 _jpg_bytes((0, 0, 255), (20, 10))),
                ("VOCdevkit/VOC2012/SegmentationClass/2007_000001.png",
                 mbuf.getvalue())):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    from paddle_tpu_torch.v2.dataset import voc2012

    recs = list(voc2012.train()())
    assert len(recs) == 1
    img, msk = recs[0]
    assert img.shape == (3, 10, 20) and img.dtype == np.float32
    assert msk.shape == (10, 20) and msk[3, 3] == 7 and msk[0, 0] == 0


# ---------------------------------------------------------------------------
# mnist fixture (the one pre-existing real path)
# ---------------------------------------------------------------------------


def test_mnist_real_parse(data_home):
    import struct

    d = data_home / "mnist"
    d.mkdir(parents=True)
    imgs = np.arange(2 * 784, dtype=np.uint8).reshape(2, 784) % 255
    with gzip.open(d / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">IIII", 2051, 2, 28, 28) + imgs.tobytes())
    with gzip.open(d / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">II", 2049, 2) + bytes([3, 7]))
    from paddle_tpu_torch.v2.dataset import mnist

    recs = list(mnist.train()())
    assert len(recs) == 2
    x, y = recs[0]
    assert x.shape == (784,) and y == 3
    np.testing.assert_allclose(x[1], 1 / 127.5 - 1.0, atol=1e-6)


# ---------------------------------------------------------------------------
# the synthetic corpora against the JAX package's
# ---------------------------------------------------------------------------

SYNTH_RECORDS = 16


@pytest.fixture
def both_homes(tmp_path, monkeypatch, data_home):
    """The port's DATA_HOME (``data_home``) and the JAX package's both
    empty, every memo cleared, and the JAX package's downloads refused
    before they reach the network."""
    import urllib.request

    from paddle_tpu.v2.dataset import common as jcommon
    from paddle_tpu.v2.dataset import imdb, movielens, sentiment, uci_housing

    def refuse(*args, **kwargs):
        raise OSError("no network in this test")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    jhome = tmp_path / "jax_home"
    jhome.mkdir()
    monkeypatch.setattr(jcommon, "DATA_HOME", str(jhome))
    monkeypatch.setattr(jcommon, "_DOWNLOAD_MEMO", {})
    monkeypatch.setattr(jcommon, "_VERIFIED", set())
    monkeypatch.setattr(imdb, "_DICT_CACHE", {})
    monkeypatch.setattr(movielens, "_META", None)
    monkeypatch.setattr(uci_housing, "_DATA", {})
    monkeypatch.setattr(sentiment, "_CACHE", {})
    return data_home, jhome


def _same(got, want, where):
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=str(where))
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, (where, i))
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same(got[k], want[k], (where, k))
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _modules(name):
    import importlib

    return (importlib.import_module(f"paddle_tpu_torch.v2.dataset.{name}"),
            importlib.import_module(f"paddle_tpu.v2.dataset.{name}"))


READERS = [
    ("cifar", "train10", ()), ("cifar", "test10", ()),
    ("cifar", "train100", ()), ("cifar", "test100", ()),
    ("mnist", "train", ()), ("mnist", "test", ()),
    ("imdb", "train", ()), ("imdb", "test", ()),
    ("imikolov", "train", ({"<s>": 0, "a": 1, "<e>": 2, "<unk>": 3}, 3)),
    ("uci_housing", "train", ()), ("uci_housing", "test", ()),
    ("movielens", "train", ()), ("movielens", "test", ()),
    ("conll05", "test", ()), ("conll05", "train", ()),
    ("sentiment", "train", ()), ("sentiment", "test", ()),
    ("wmt14", "train", (30,)), ("wmt14", "test", (30,)),
    ("mq2007", "train", ("pairwise",)), ("mq2007", "test", ("listwise",)),
    ("flowers", "train", ()), ("voc2012", "val", ()),
]


@pytest.mark.parametrize("module,fn,args", READERS,
                         ids=[f"{m}.{f}" for m, f, _ in READERS])
def test_synthetic_records_equal_jax(both_homes, module, fn, args):
    import itertools

    port, jax_mod = _modules(module)
    got = list(itertools.islice(getattr(port, fn)(*args)(), SYNTH_RECORDS))
    want = list(itertools.islice(getattr(jax_mod, fn)(*args)(),
                                 SYNTH_RECORDS))
    assert got, (module, fn)
    _same(got, want, (module, fn))


DICTS = [
    ("imdb", "word_dict", ()), ("imikolov", "build_dict", ()),
    ("movielens", "get_movie_title_dict", ()),
    ("movielens", "max_user_id", ()), ("movielens", "max_movie_id", ()),
    ("movielens", "max_job_id", ()), ("conll05", "get_dict", ()),
    ("conll05", "get_embedding", ()), ("wmt14", "get_dict", (30,)),
]


@pytest.mark.parametrize("module,fn,args", DICTS,
                         ids=[f"{m}.{f}" for m, f, _ in DICTS])
def test_synthetic_dicts_equal_jax(both_homes, module, fn, args):
    port, jax_mod = _modules(module)
    got, want = getattr(port, fn)(*args), getattr(jax_mod, fn)(*args)
    if isinstance(want, str):
        # a path into each package's own DATA_HOME
        assert os.path.basename(got) == os.path.basename(want)
        return
    _same(got, want, (module, fn))


def test_port_download_never_fetches(data_home, monkeypatch):
    """A missing file raises at once: the port opens no connection."""
    import urllib.request

    def refuse(*args, **kwargs):
        raise AssertionError("the port tried to download")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    with pytest.raises(RuntimeError):
        common.download("http://example.invalid/x.bin", "m", None)
    assert not (data_home / "m").exists()
