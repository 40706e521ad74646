"""Oxford-102 flowers reader creators (reference python/paddle/dataset/
flowers.py:47,146,175,204 -- train/test/valid yielding (image, label)).

Reads cached 102flowers data when present (images as .npy bundles); else a
class-conditional synthetic surrogate (per-class color/texture prototypes)
so classifiers converge. Images are [3, 32, 32] float32 in [0, 1] (the
reference's mapper resized/cropped to a model-chosen size; callers reshape
as needed).

The port's copy of ``paddle_tpu/dataset/flowers.py``, plain numpy: the same rows,
in the same order, from the same archive or the same surrogate.
"""
from __future__ import annotations

import os

import numpy as np

_N_CLASSES = 102
_TRAIN_PER = 16
_TEST_PER = 4
_HW = 32


def _home():
    from . import data_home
    return data_home("flowers")


def _find_real(split):
    p = os.path.join(_home(), f"{split}.npz")
    return p if os.path.exists(p) else None


def _reader(split):
    real = _find_real(split)
    if real:
        data = np.load(real)
        for img, label in zip(data["images"], data["labels"]):
            yield img.astype("float32"), int(label)
        return
    from . import _warn_synthetic
    _warn_synthetic("flowers")
    per = _TRAIN_PER if split == "train" else _TEST_PER
    rng = np.random.RandomState(0 if split == "train" else 1)
    protos = np.random.RandomState(42).rand(_N_CLASSES, 3, 1, 1)
    tex = np.random.RandomState(43).rand(_N_CLASSES, 3, _HW, _HW) * 0.5
    for label in range(_N_CLASSES):
        for _ in range(per):
            img = (0.5 * protos[label] + 0.5 * tex[label] +
                   0.15 * rng.rand(3, _HW, _HW))
            yield np.clip(img, 0, 1).astype("float32"), label


def train(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    def reader():
        while True:
            yield from _reader("train")
            if not cycle:
                break
    return reader


def test(mapper=None, buffered_size=1024, use_xmap=True, cycle=False):
    return lambda: _reader("test")


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return lambda: _reader("test")
