"""CIFAR reader creators (reference python/paddle/dataset/cifar.py).

train10()/test10() yield (image: float32[3072] in [0, 1], label: int 0..9);
train100()/test100() the 100-class variant. Reads the standard
``cifar-10-batches-py`` / ``cifar-100-python`` pickles when cached; else a
class-conditional synthetic surrogate.

The port's copy of ``paddle_tpu/dataset/cifar.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

_TRAIN_N = 4096
_TEST_N = 512


def _home():
    from . import data_home
    return data_home("cifar")


def _load_pickles(paths, label_key):
    imgs, labels = [], []
    for p in paths:
        with open(p, "rb") as f:
            d = pickle.load(f, encoding="bytes")
        imgs.append(d[b"data"].astype("float32") / 255.0)
        labels.extend(d[label_key])
    return np.concatenate(imgs), np.asarray(labels, "int64")


def _find(n_classes, split):
    base = _home()
    if n_classes == 10:
        d = os.path.join(base, "cifar-10-batches-py")
        names = ([f"data_batch_{i}" for i in range(1, 6)]
                 if split == "train" else ["test_batch"])
        paths = [os.path.join(d, n) for n in names]
        key = b"labels"
    else:
        d = os.path.join(base, "cifar-100-python")
        paths = [os.path.join(d, "train" if split == "train" else "test")]
        key = b"fine_labels"
    if all(os.path.exists(p) for p in paths):
        return paths, key
    return None


def _synthetic(n_classes, split):
    from . import _warn_synthetic
    _warn_synthetic("cifar")
    n = _TRAIN_N if split == "train" else _TEST_N
    # fixed seeds: python hash() is randomized per process, which would hand
    # every host a DIFFERENT "deterministic" surrogate
    seeds = {(10, "train"): 100, (10, "test"): 101,
             (100, "train"): 200, (100, "test"): 201}
    rng = np.random.RandomState(seeds[(n_classes, split)])
    protos = np.random.RandomState(7).rand(n_classes, 3072).astype("float32")
    labels = rng.randint(0, n_classes, n).astype("int64")
    imgs = np.clip(0.55 * protos[labels] +
                   0.45 * rng.rand(n, 3072).astype("float32"), 0.0, 1.0)
    return imgs, labels


def _reader(n_classes, split):
    def read():
        found = _find(n_classes, split)
        if found is not None:
            imgs, labels = _load_pickles(*found)
        else:
            imgs, labels = _synthetic(n_classes, split)
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])
    return read


def train10():
    return _reader(10, "train")


def test10():
    return _reader(10, "test")


def train100():
    return _reader(100, "train")


def test100():
    return _reader(100, "test")
