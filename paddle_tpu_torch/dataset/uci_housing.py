"""UCI housing reader creators (reference python/paddle/dataset/uci_housing.py).

train()/test() yield (features: float32[13] normalized, price: float32[1]).
Reads ``housing.data`` when cached; else a synthetic linear-model surrogate
(fixed ground-truth weights + noise) so regression examples converge.

The port's copy of ``paddle_tpu/dataset/uci_housing.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import os

import numpy as np

FEATURE_DIM = 13
_TRAIN_N = 404
_TEST_N = 102


def _home():
    from . import data_home
    return data_home("uci_housing")


def _load_real():
    path = os.path.join(_home(), "housing.data")
    if not os.path.exists(path):
        return None
    raw = np.loadtxt(path).astype("float32")
    x, y = raw[:, :-1], raw[:, -1:]
    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    return x, y


def _synthetic():
    from . import _warn_synthetic
    _warn_synthetic("uci_housing")
    rng = np.random.RandomState(3)
    w = np.random.RandomState(11).randn(FEATURE_DIM, 1).astype("float32")
    x = rng.randn(_TRAIN_N + _TEST_N, FEATURE_DIM).astype("float32")
    y = x @ w + 0.1 * rng.randn(len(x), 1).astype("float32") + 22.5
    return x, y


def _reader(split):
    def read():
        data = _load_real()
        if data is None:
            data = _synthetic()
        x, y = data
        n_train = int(len(x) * 0.8)
        sl = slice(0, n_train) if split == "train" else slice(n_train, None)
        for xi, yi in zip(x[sl], y[sl]):
            yield xi, yi
    return read


def train():
    return _reader("train")


def test():
    return _reader("test")
