"""The nine dataset loaders of ``paddle_tpu_torch.dataset`` against the JAX
package's ``paddle_tpu.dataset``.

Each loader serves a cached archive when one is present and otherwise a
deterministic surrogate. Both paths are held here, on the CPU, with
nothing downloaded: ``PADDLE_TPU_DATA_HOME`` points both packages at a
fresh ``tmp_path``; the surrogate tests leave it empty, and the archive
tests write a few rows in each loader's standard format into it. Every
row, dictionary and helper value must be equal, exactly, in value and in
order (the loaders are plain numpy on both sides). The module caches
(``movielens._CACHE``, ``conll05._real_cache``) are reset in both
packages around each test.
"""
import gzip
import io
import os
import pickle
import struct
import tarfile
import warnings
import zipfile

import numpy as np
import pytest

import paddle_tpu.dataset as jds
import paddle_tpu_torch.dataset as tds

LOADERS = ["mnist", "cifar", "uci_housing", "imdb", "conll05", "movielens", "wmt14",
           "wmt16", "flowers"]


@pytest.fixture
def home(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    for pkg in (jds, tds):
        pkg.movielens._CACHE = None
        pkg.conll05._real_cache.clear()
    yield tmp_path
    for pkg in (jds, tds):
        pkg.movielens._CACHE = None
        pkg.conll05._real_cache.clear()


def _same(a, b, where="row"):
    """Equal in structure, type family and value, exactly."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, type(a), type(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a.items()) == list(b.items()), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _rows(creator):
    return list(creator())


def _same_rows(jcreator, tcreator, label):
    a, b = _rows(jcreator), _rows(tcreator)
    assert len(a) == len(b) > 0, (label, len(a), len(b))
    for i, (x, y) in enumerate(zip(a, b)):
        _same(x, y, f"{label} row {i}")
    return len(a)


# -- the surrogates --------------------------------------------------------------------------

# loader -> [(label, function of the module that returns a reader creator)]
SURROGATE_READERS = {
    "mnist": [("train", lambda m: m.train()), ("test", lambda m: m.test())],
    "cifar": [("train10", lambda m: m.train10()), ("test10", lambda m: m.test10()),
              ("train100", lambda m: m.train100()), ("test100", lambda m: m.test100())],
    "uci_housing": [("train", lambda m: m.train()), ("test", lambda m: m.test())],
    "conll05": [("test", lambda m: m.test())],
    "movielens": [("train", lambda m: m.train()), ("test", lambda m: m.test()),
                  ("test-ratio", lambda m: m.test(test_ratio=0.3, rand_seed=5))],
    "wmt14": [("train", lambda m: m.train(40)), ("test", lambda m: m.test(40))],
    "wmt16": [("train", lambda m: m.train(120, 120)), ("test", lambda m: m.test(50, 60)),
              ("validation", lambda m: m.validation(50, 50))],
    "flowers": [("train", lambda m: m.train()), ("test", lambda m: m.test()),
                ("valid", lambda m: m.valid())],
}


@pytest.mark.parametrize("name", sorted(SURROGATE_READERS))
def test_surrogate_rows_equal_jax(home, name):
    for label, make in SURROGATE_READERS[name]:
        _same_rows(make(getattr(jds, name)), make(getattr(tds, name)), f"{name}.{label}")


def test_imdb_surrogate_dictionary_and_rows_equal_jax(home):
    jd, td = jds.imdb.word_dict(), tds.imdb.word_dict()
    _same(jd, td, "word_dict")
    assert td["<unk>"] == len(td) - 1
    for split in ("train", "test"):
        _same_rows(getattr(jds.imdb, split)(jd), getattr(tds.imdb, split)(td), split)
    docs = jds.imdb._docs("train")
    for cutoff in (0, 40):
        _same(jds.imdb.build_dict(docs, cutoff), tds.imdb.build_dict(docs, cutoff), "build_dict")
    text = "A film, NOT worth 2 hours!\nIt's bad."
    assert tds.imdb.tokenize(text) == jds.imdb.tokenize(text)


def test_conll05_surrogate_dictionaries_equal_jax(home):
    _same(list(jds.conll05.get_dict()), list(tds.conll05.get_dict()), "get_dict")
    assert jds.conll05.get_embedding() is None and tds.conll05.get_embedding() is None


def test_movielens_surrogate_helpers_equal_jax(home):
    for fn in ("max_user_id", "max_movie_id", "max_job_id", "movie_categories",
               "get_movie_title_dict", "user_info", "movie_info"):
        _same(getattr(jds.movielens, fn)(), getattr(tds.movielens, fn)(), fn)
    assert tds.movielens.age_table == jds.movielens.age_table
    # the module cache: built once, reset by clearing it
    first = tds.movielens._corpus()
    assert tds.movielens._corpus() is first
    tds.movielens._CACHE = None
    assert tds.movielens._corpus() is not first


@pytest.mark.parametrize("reverse", [False, True])
def test_wmt_dictionaries_equal_jax(home, reverse):
    for lang in ("en", "de"):
        _same(jds.wmt16.get_dict(lang, 60, reverse), tds.wmt16.get_dict(lang, 60, reverse),
              f"wmt16 {lang}")
    _same(list(jds.wmt14.get_dict(40, reverse)), list(tds.wmt14.get_dict(40, reverse)), "wmt14")
    d = tds.wmt16.get_dict("en", 60)
    assert (d["<s>"], d["<e>"], d["<unk>"]) == (0, 1, 2)
    src, trg_in, trg_lbl = next(iter(tds.wmt16.train(120, 120)()))
    assert trg_in[0] == 0 and trg_lbl[-1] == 1 and trg_in[1:] == trg_lbl[:-1]


def test_data_home_is_the_jax_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_DATA_HOME", str(tmp_path))
    assert tds.data_home("mnist") == jds.data_home("mnist") == str(tmp_path / "mnist")
    monkeypatch.delenv("PADDLE_TPU_DATA_HOME")
    assert tds.data_home("imdb") == jds.data_home("imdb") == os.path.expanduser(
        "~/.cache/paddle/dataset/imdb")


def _surrogate_warnings(pkg, read):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("default")
        read(pkg)
        read(pkg)
    return [str(w.message) for w in caught if issubclass(w.category, UserWarning)]


# loader -> (the name its warning gives, a first read of its surrogate)
FIRST_READS = {
    "mnist": ("mnist", lambda p: next(iter(p.mnist.test()()))),
    "cifar": ("cifar", lambda p: next(iter(p.cifar.test10()()))),
    "uci_housing": ("uci_housing", lambda p: next(iter(p.uci_housing.test()()))),
    "imdb": ("imdb", lambda p: p.imdb.word_dict()),
    "conll05": ("conll05st", lambda p: p.conll05.test()),
    "movielens": ("movielens", lambda p: p.movielens.max_user_id()),
    "wmt14": ("wmt14", lambda p: next(iter(p.wmt14.train(30)()))),
    "wmt16": ("wmt16", lambda p: next(iter(p.wmt16.train(30, 30)()))),
    "flowers": ("flowers", lambda p: next(iter(p.flowers.test()()))),
}


@pytest.mark.parametrize("name", LOADERS)
def test_the_surrogate_warns_once_with_the_jax_text(home, name):
    """Two reads warn once (Python's default filter shows a warning once a
    call site), with the JAX package's text, which names the dataset and
    the directory it looked in."""
    label, read = FIRST_READS[name]
    got, want = _surrogate_warnings(tds, read), _surrogate_warnings(jds, read)
    assert len(got) == 1 and got == want, (got, want)
    assert f"dataset.{label}:" in got[0] and str(home) in got[0]


# -- the cached archives ------------------------------------------------------------------

def _write_mnist(d, rng):
    os.makedirs(d)
    for stem, n in (("train", 6), ("t10k", 4)):
        imgs = rng.randint(0, 256, (n, 5, 4)).astype(np.uint8)
        labels = rng.randint(0, 10, n).astype(np.uint8)
        with gzip.open(os.path.join(d, f"{stem}-images-idx3-ubyte.gz"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 5, 4) + imgs.tobytes())
        with gzip.open(os.path.join(d, f"{stem}-labels-idx1-ubyte.gz"), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def _write_cifar(d, rng):
    ten = os.path.join(d, "cifar-10-batches-py")
    hundred = os.path.join(d, "cifar-100-python")
    os.makedirs(ten)
    os.makedirs(hundred)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(ten, name), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (3, 3072)).astype(np.uint8),
                         b"labels": rng.randint(0, 10, 3).tolist()}, f)
    for name in ("train", "test"):
        with open(os.path.join(hundred, name), "wb") as f:
            pickle.dump({b"data": rng.randint(0, 256, (4, 3072)).astype(np.uint8),
                         b"fine_labels": rng.randint(0, 100, 4).tolist()}, f)


def _write_uci(d, rng):
    os.makedirs(d)
    rows = np.concatenate([rng.rand(11, 13) * 100, rng.rand(11, 1) * 50], axis=1)
    np.savetxt(os.path.join(d, "housing.data"), rows, fmt="%.4f")


def _write_imdb(d, rng):
    words = ["great", "film", "bad", "plot", "the", "a", "and"]
    for split in ("train", "test"):
        for sub in ("pos", "neg"):
            p = os.path.join(d, "aclImdb", split, sub)
            os.makedirs(p)
            for i in range(3):
                # "the" 200 times a train document: over the reference's cutoff of 150
                text = " ".join(rng.choice(words, 30)) + " The," * 200 + "!"
                with open(os.path.join(p, f"{i}_{sub}.txt"), "w") as f:
                    f.write(text.upper() if i == 1 else text)


def _write_conll05(d, rng):
    os.makedirs(d)
    words = "The cat sat on the mat today\n\nA dog ran home\n"
    props = ("-\t(A0*\t*\n-\t*)\t(A0*\nsit\t(V*)\t*)\n-\t(A1*\t(V*)\n-\t*\t(A1*\n"
             "-\t*)\t*\n-\t*\t*)\n\nrun\t(V*)\n-\t(A1*\n-\t*)\n-\t*\n")
    with gzip.open(os.path.join(d, "test.wsj.words.gz"), "wt") as f:
        f.write("\n".join(words.replace(" ", "\n").split("\n")) + "\n")
    with gzip.open(os.path.join(d, "test.wsj.props.gz"), "wt") as f:
        f.write(props)


def _write_movielens(d, rng):
    os.makedirs(d)
    users = "".join(f"{u}::{'MF'[u % 2]}::{[1, 18, 25][u % 3]}::{u % 5}::00000\n"
                    for u in range(1, 7))
    movies = "".join(f"{m}::Film Number {m} (199{m})::{['Comedy', 'Drama|Comedy'][m % 2]}\n"
                     for m in range(1, 6))
    ratings = "".join(f"{rng.randint(1, 7)}::{rng.randint(1, 7)}::{rng.randint(1, 6)}::0\n"
                      for _ in range(60))
    with zipfile.ZipFile(os.path.join(d, "ml-1m.zip"), "w") as z:
        for name, text in (("users", users), ("movies", movies), ("ratings", ratings)):
            z.writestr(f"ml-1m/{name}.dat", text.encode("latin1"))


def _write_wmt(d, rng, dataset):
    os.makedirs(d)
    vocab_s, vocab_t = ["the", "cat", "sat", "dog", "ran"], ["le", "chat", "chien", "a"]
    lines = {s: "\n".join(" ".join(rng.choice(vocab_s, rng.randint(2, 6))) + " ||| "
                          + " ".join(rng.choice(vocab_t, rng.randint(2, 6)))
                          for _ in range(n)) for s, n in (("train", 12), ("test", 5))}
    with tarfile.open(os.path.join(d, f"{dataset}.tar.gz"), "w:gz") as t:
        for split, text in lines.items():
            data = text.encode("utf-8")
            info = tarfile.TarInfo(f"{dataset}/{split}")
            info.size = len(data)
            t.addfile(info, io.BytesIO(data))


def _write_flowers(d, rng):
    os.makedirs(d)
    for split in ("train", "test"):
        np.savez(os.path.join(d, f"{split}.npz"), images=rng.rand(3, 3, 8, 8),
                 labels=rng.randint(0, 102, 3))


ARCHIVES = {
    "mnist": (_write_mnist, SURROGATE_READERS["mnist"]),
    "cifar": (_write_cifar, SURROGATE_READERS["cifar"]),
    "uci_housing": (_write_uci, SURROGATE_READERS["uci_housing"]),
    "imdb": (_write_imdb, []),
    "conll05": (_write_conll05, SURROGATE_READERS["conll05"]),
    "movielens": (_write_movielens, SURROGATE_READERS["movielens"]),
    "wmt14": (lambda d, rng: _write_wmt(d, rng, "wmt14"), SURROGATE_READERS["wmt14"]),
    "wmt16": (lambda d, rng: _write_wmt(d, rng, "wmt16"), SURROGATE_READERS["wmt16"]),
    "flowers": (_write_flowers, SURROGATE_READERS["flowers"]),
}


@pytest.mark.parametrize("name", LOADERS)
def test_a_cached_archive_reads_to_the_jax_rows(home, name):
    """A few rows in the standard format (idx gz, CIFAR pickles,
    ``housing.data``, the aclImdb tree, the conll05 words/props pair,
    ``ml-1m.zip``, the wmt tarballs, flowers' npz) read to the same rows
    in both packages, with no surrogate warning."""
    write, readers = ARCHIVES[name]
    write(str(home / name), np.random.RandomState(LOADERS.index(name)))
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)   # the surrogate must not serve
        for label, make in readers:
            n = _same_rows(make(getattr(jds, name)), make(getattr(tds, name)),
                           f"{name}.{label}")
            assert n < 100, (name, label, n)             # the archive's rows, not the surrogate's
        if name == "imdb":
            jd, td = jds.imdb.word_dict(), tds.imdb.word_dict()
            _same(jd, td, "word_dict")
            assert "the" in td and len(td) == 2          # cutoff 150 keeps one word
            for split in ("train", "test"):
                _same_rows(getattr(jds.imdb, split)(jd), getattr(tds.imdb, split)(td), split)
        elif name == "conll05":
            _same(list(jds.conll05.get_dict()), list(tds.conll05.get_dict()), "get_dict")
        elif name == "movielens":
            for fn in ("max_user_id", "max_movie_id", "get_movie_title_dict", "movie_info"):
                _same(getattr(jds.movielens, fn)(), getattr(tds.movielens, fn)(), fn)
        elif name in ("wmt14", "wmt16"):
            mod = (jds, tds)
            args = (20, True) if name == "wmt14" else ("en", 20, False)
            _same(getattr(mod[0], name).get_dict(*args), getattr(mod[1], name).get_dict(*args),
                  "get_dict")
