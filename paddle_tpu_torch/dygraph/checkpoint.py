"""Dygraph state-dict save/load (reference: python/paddle/fluid/dygraph/checkpoint.py).

The port's copy of ``paddle_tpu/dygraph/checkpoint.py``: one ``.npz`` of
name -> array, the JAX package's format, so a float32 file written by either
package loads in the other. A tensor is saved as numpy, a bfloat16 one
widened to float32 (numpy has no bfloat16 here; the values are exact), and
``set_dict`` rounds it back into a bfloat16 parameter. numpy saves the JAX
package's bfloat16 arrays (``ml_dtypes``) as 2-byte void data ('|V2'), which
that package cannot load back; ``load_dygraph`` reads such an array as
bfloat16 bits and returns it widened to float32.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.executor import to_numpy


def save_dygraph(state_dict: dict, model_path: str):
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    np.savez(model_path + ".npz",
             **{k: to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in state_dict.items()})


def _widen(a: np.ndarray) -> np.ndarray:
    """A '|V2' array (bfloat16 saved without its dtype) -> float32."""
    if a.dtype.kind != "V" or a.dtype.itemsize != 2:
        return a
    bits = np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def load_dygraph(model_path: str):
    data = np.load(model_path + ".npz", allow_pickle=False)
    return {k: _widen(data[k]) for k in data.files}, None
