"""Data entry layer (the port's copy of ``paddle_tpu/layers/io.py: data``)."""
from __future__ import annotations

from ..framework import default_main_program


def data(name, shape, dtype="float32", type=None, append_batch_size=True,
         lod_level=0, stop_gradient=True):
    """Declare a feed entry point; append_batch_size=True prepends -1 (dynamic batch)."""
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    block = default_main_program().global_block()
    v = block.create_var(name, shape, dtype, is_data=True, stop_gradient=stop_gradient)
    v.is_data = True  # also when ``name`` already existed
    return v
