"""WMT16 en<->de reader creators (reference python/paddle/dataset/wmt16.py:
147,196,292 -- train/test/get_dict with <s>/<e>/<unk> conventions).

Reads a cached wmt16 tarball when present; else a synthetic parallel corpus
whose "translation" is a deterministic token permutation + reversal, which a
seq2seq+attention model genuinely learns (the same role the real corpus
plays for the machine-translation chapter, offline).

The port's copy of ``paddle_tpu/dataset/wmt16.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

_START, _END, _UNK = 0, 1, 2
_N_TRAIN = 3000
_N_TEST = 300


def _home(dataset="wmt16"):
    from . import data_home
    return data_home(dataset)


def get_dict(lang, dict_size, reverse=False, dataset="wmt16"):
    """{token: id} with <s>=0, <e>=1, <unk>=2 (reference :292). With a
    cached real tarball, dicts are the same frequency-built ones the reader
    ids with (decode-coherent); else the synthetic vocab."""
    real = _find_real(dataset)
    if real:
        with tarfile.open(real) as t:
            lines = t.extractfile(f"{dataset}/train").read().decode(
                "utf-8").splitlines()
        words = _build_dict(lines, 0 if lang == "en" else 1, dict_size)
    else:
        words = {"<s>": _START, "<e>": _END, "<unk>": _UNK}
        for i in range(3, dict_size):
            words[f"{lang}{i}"] = i
    if reverse:
        return {v: k for k, v in words.items()}
    return words


def _find_real(dataset="wmt16"):
    p = os.path.join(_home(dataset), f"{dataset}.tar.gz")
    return p if os.path.exists(p) else None


def _synthetic_pairs(n, dict_size, seed, dataset="wmt16"):
    from . import _warn_synthetic
    _warn_synthetic(dataset)
    rng = np.random.RandomState(seed)
    # deterministic "translation": permute the id space and reverse the order
    perm = np.arange(3, dict_size)
    rng.shuffle(perm)
    mapping = np.concatenate([np.arange(3), perm])
    for _ in range(n):
        L = int(rng.randint(3, 10))
        src = rng.randint(3, dict_size, L)
        trg = mapping[src][::-1]
        yield (src.tolist(),
               [_START] + trg.tolist(),
               trg.tolist() + [_END])


def _build_dict(lines, side, dict_size):
    freq = {}
    for line in lines:
        if "|||" not in line:
            continue
        for w in line.split("|||")[side].split():
            freq[w] = freq.get(w, 0) + 1
    kept = sorted(freq, key=lambda w: (-freq[w], w))[:dict_size - 3]
    d = {"<s>": _START, "<e>": _END, "<unk>": _UNK}
    for w in kept:
        d[w] = len(d)
    return d


def _real_pairs(path, split, src_dict_size, trg_dict_size, src_lang,
                dataset="wmt16"):
    # layout per the reference: wmt16/{train,test}; ||| separated pairs.
    # Dictionaries are built from the train split by frequency (the
    # reference ships prebuilt dicts; building from the corpus keeps real
    # tokens out of <unk> without assuming the tarball carries them).
    with tarfile.open(path) as t:
        train_lines = t.extractfile(f"{dataset}/train").read().decode(
            "utf-8").splitlines()
        src_d = _build_dict(train_lines, 0, src_dict_size)
        trg_d = _build_dict(train_lines, 1, trg_dict_size)
        lines = (train_lines if split == "train" else
                 t.extractfile(f"{dataset}/{split}").read().decode(
                     "utf-8").splitlines())
        for line in lines:
            if "|||" not in line:
                continue
            s, tr = line.split("|||")[:2]
            si = [src_d.get(w, _UNK) for w in s.split()]
            ti = [trg_d.get(w, _UNK) for w in tr.split()]
            yield si, [_START] + ti, ti + [_END]


def _creator(split, src_dict_size, trg_dict_size, src_lang,
             dataset="wmt16"):
    real = _find_real(dataset)

    def reader():
        if real:
            yield from _real_pairs(real, split, src_dict_size,
                                   trg_dict_size, src_lang, dataset)
        else:
            n = _N_TRAIN if split == "train" else _N_TEST
            yield from _synthetic_pairs(n, min(src_dict_size, trg_dict_size),
                                        0 if split == "train" else 1,
                                        dataset)

    return reader


def train(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("train", src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("test", src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    return _creator("test", src_dict_size, trg_dict_size, src_lang)
