"""IMDB sentiment reader creators (reference python/paddle/dataset/imdb.py:1).

Surface parity: ``word_dict()`` builds {word: idx} with '<unk>' last;
``train(word_idx)`` / ``test(word_idx)`` yield ([word ids], label 0/1).
Reads the aclImdb tree from the cache dir when present; else a synthetic
sentiment corpus (two class-conditional word distributions with a shared
stopword pool) that a pooled-LSTM classifier genuinely learns from.

The port's copy of ``paddle_tpu/dataset/imdb.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import glob
import os
import re
import tarfile

import numpy as np

_VOCAB = 2048          # synthetic vocab (reference uses cutoff-150 dict)
_TRAIN_N = 2000
_TEST_N = 400
_CUTOFF = 150


def _home():
    from . import data_home
    return data_home("imdb")


def _find_real():
    base = _home()
    if os.path.isdir(os.path.join(base, "aclImdb", "train", "pos")):
        return os.path.join(base, "aclImdb")
    tar = os.path.join(base, "aclImdb_v1.tar.gz")
    if os.path.exists(tar):
        with tarfile.open(tar) as t:
            t.extractall(base)
        return os.path.join(base, "aclImdb")
    return None


def tokenize(text):
    return re.sub(r"[^a-z0-9\s]", "", text.lower()).split()


def _real_docs(root, split):
    out = []
    for label, sub in ((1, "pos"), (0, "neg")):
        for p in sorted(glob.glob(os.path.join(root, split, sub, "*.txt"))):
            with open(p, encoding="utf-8", errors="ignore") as f:
                out.append((tokenize(f.read()), label))
    return out


def _synthetic(split):
    from . import _warn_synthetic
    _warn_synthetic("imdb")
    n = _TRAIN_N if split == "train" else _TEST_N
    rng = np.random.RandomState(0 if split == "train" else 1)
    # class-conditional unigram models over a shared vocab: words
    # [0, 200) are "stopwords" (class-neutral), [200, 400) positive-leaning,
    # [400, 600) negative-leaning
    docs = []
    for i in range(n):
        label = int(rng.randint(0, 2))
        length = int(rng.randint(20, 80))
        topical = rng.randint(200, 400, length) if label else \
            rng.randint(400, 600, length)
        stop = rng.randint(0, 200, length)
        use_topical = rng.rand(length) < 0.4
        words = np.where(use_topical, topical, stop)
        docs.append(([f"w{w}" for w in words], label))
    return docs


def _docs(split):
    root = _find_real()
    if root is not None:
        return _real_docs(root, split)
    return _synthetic(split)


def build_dict(docs, cutoff=_CUTOFF):
    """{word: idx} dropping words with freq <= cutoff (reference :41 semantics),
    then capped at _VOCAB-1 entries by frequency (a fixed-vocab cap)."""
    freq = {}
    for words, _ in docs:
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    kept = [w for w, c in freq.items() if c > cutoff]
    kept.sort(key=lambda w: (-freq[w], w))
    kept = kept[:_VOCAB - 1]
    word_idx = {w: i for i, w in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def word_dict():
    """{word: idx} over the train split, '<unk>' last (reference :131).

    The reference cutoff (150) applies to the real aclImdb corpus; the
    synthetic corpus keeps every word (its topical words have freq ~100 by
    construction, so the real-data cutoff would empty the signal vocabulary).
    """
    cutoff = _CUTOFF if _find_real() is not None else 0
    return build_dict(_docs("train"), cutoff=cutoff)


def _reader_creator(split, word_idx):
    unk = word_idx["<unk>"]

    def reader():
        for words, label in _docs(split):
            yield [word_idx.get(w, unk) for w in words], label

    return reader


def train(word_idx):
    return _reader_creator("train", word_idx)


def test(word_idx):
    return _reader_creator("test", word_idx)
