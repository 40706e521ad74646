"""MNIST reader creators (reference python/paddle/dataset/mnist.py:1).

train()/test() yield (image: float32[784] scaled to [-1, 1], label: int).
Reads the standard idx-ubyte files from the cache dir when present; else a
class-conditional synthetic surrogate (each digit = fixed prototype blob +
noise) so classifiers actually converge on it.

The port's copy of ``paddle_tpu/dataset/mnist.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_TRAIN_N = 8192   # synthetic sizes (real files override)
_TEST_N = 1024


def _home():
    from . import data_home
    return data_home("mnist")


def _read_idx(img_path, lab_path):
    def op(p):
        return gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")
    with op(img_path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        imgs = np.frombuffer(f.read(n * rows * cols), np.uint8)
        imgs = imgs.reshape(n, rows * cols)
    with op(lab_path) as f:
        magic, n2 = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(n2), np.uint8)
    return imgs.astype("float32") / 127.5 - 1.0, labels.astype("int64")


def _find(split):
    base = _home()
    stems = (("train-images-idx3-ubyte", "train-labels-idx1-ubyte")
             if split == "train" else
             ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"))
    for suffix in (".gz", ""):
        ip = os.path.join(base, stems[0] + suffix)
        lp = os.path.join(base, stems[1] + suffix)
        if os.path.exists(ip) and os.path.exists(lp):
            return ip, lp
    return None


def _synthetic(split):
    from . import _warn_synthetic
    _warn_synthetic("mnist")
    n = _TRAIN_N if split == "train" else _TEST_N
    rng = np.random.RandomState(0 if split == "train" else 1)
    protos = np.random.RandomState(42).randn(10, 784).astype("float32")
    labels = rng.randint(0, 10, n).astype("int64")
    imgs = (0.6 * protos[labels] +
            0.8 * rng.randn(n, 784).astype("float32"))
    return np.clip(imgs, -1.0, 1.0), labels


def _reader(split):
    def read():
        found = _find(split)
        if found is not None:
            imgs, labels = _read_idx(*found)
        else:
            imgs, labels = _synthetic(split)
        for i in range(len(labels)):
            yield imgs[i], int(labels[i])
    return read


def train():
    return _reader("train")


def test():
    return _reader("test")
