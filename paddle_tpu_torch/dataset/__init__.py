"""Canned datasets (the port's copy of ``paddle_tpu/dataset/``; reference:
python/paddle/dataset/ -- mnist.py:1, cifar.py, uci_housing.py, common.py).

The reference downloads archives at import time (common.py:download). These
loaders download nothing. Each one:
  1. reads the standard archive files from the local cache dir if present
     (``~/.cache/paddle/dataset/<name>`` or ``$PADDLE_TPU_DATA_HOME``, the
     directory the JAX package reads, so both read one cache) -- drop the
     files there and you get the real dataset, identical format to the
     reference;
  2. otherwise yields a DETERMINISTIC SYNTHETIC surrogate with the same
     shapes/dtypes/label space, class-conditional so models genuinely learn
     (loss curves behave), row for row the JAX package's (numpy
     ``RandomState``s with the same seeds); a loud warning, with the JAX
     package's text, is emitted once per dataset.

Reader creators follow the reference contract: ``mnist.train()`` returns a
zero-arg callable yielding ``(image_float32[784] in [-1,1], int label)``.
Plain numpy and the standard library: nothing here touches torch.
"""
from __future__ import annotations

import os
import warnings

from . import mnist  # noqa: F401
from . import cifar  # noqa: F401
from . import uci_housing  # noqa: F401
from . import imdb  # noqa: F401
from . import conll05  # noqa: F401
from . import movielens  # noqa: F401
from . import wmt16  # noqa: F401
from . import wmt14  # noqa: F401
from . import flowers  # noqa: F401

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "conll05", "movielens",
           "wmt14", "wmt16", "flowers", "data_home"]


def data_home(name: str) -> str:
    root = os.environ.get("PADDLE_TPU_DATA_HOME",
                          os.path.expanduser("~/.cache/paddle/dataset"))
    return os.path.join(root, name)


def _warn_synthetic(name: str):
    warnings.warn(
        f"paddle_tpu.dataset.{name}: no cached archive found under "
        f"{data_home(name)} and this environment has no network access -- "
        f"serving the deterministic synthetic surrogate (same shapes/labels; "
        f"place the standard files in that directory to use the real data)",
        UserWarning, stacklevel=3)
