"""Data entry and reader layers (the port's copy of
``paddle_tpu/layers/io.py``: ``data``, ``double_buffer``, ``py_reader``,
``create_py_reader_by_data``, ``load``, ``read_file``).

There is no reader op in the graph: a ``PyReader`` (``reader.py``) yields
feed dicts by name, and these layers give reference-shaped programs the
loader and its feed variables."""
from __future__ import annotations

import re

import numpy as np

from .. import unique_name
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


def double_buffer(reader, place=None, name=None):
    """The identity: the DataLoader's producer already stages the next
    batch while the step runs."""
    return reader


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None, use_double_buffer=True):
    """A ``PyReader`` over new feed variables of ``shapes`` / ``dtypes``
    (``read_file`` returns them); feed it with its ``decorate_*`` methods."""
    from ..reader import PyReader
    block = default_main_program().current_block()
    feed_vars = []
    for i, (shp, dt) in enumerate(zip(shapes, dtypes)):
        v = block.create_var(unique_name.generate(f"py_reader_{i}"), tuple(shp), dt)
        v.is_data = True
        feed_vars.append(v)
    loader = PyReader(feed_vars, capacity=capacity, use_double_buffer=use_double_buffer)
    loader.feed_vars = feed_vars
    return loader


def create_py_reader_by_data(capacity, feed_list, name=None, use_double_buffer=True):
    """A ``PyReader`` over existing feed variables."""
    from ..reader import PyReader
    return PyReader(feed_list, capacity=capacity, use_double_buffer=use_double_buffer)


def load(out, file_path, load_as_fp16=None):
    """One whole-variable ``.npy`` into ``out``'s slot of the global scope.
    A shard chunk of a sharded checkpoint (``*.r<k>c<i>.npy``) holds a part
    of a variable and is refused: load such checkpoints with
    ``io.load_vars`` / ``load_persistables``."""
    from ..core.executor import global_scope, tensor_from_numpy
    if re.search(r"\.r\d+c\d+\.npy$", file_path):
        raise ValueError(f"{file_path!r} is a shard chunk of a sharded checkpoint; load "
                         f"the checkpoint with io.load_vars/load_persistables")
    arr = np.load(file_path, allow_pickle=False)
    global_scope().set_var(out.name if hasattr(out, "name") else str(out),
                           tensor_from_numpy(arr))
    return out


def read_file(reader):
    """The loader's feed variables, so that ``img, label =
    layers.read_file(reader)`` works as in reference programs."""
    fv = getattr(reader, "feed_vars", None) or getattr(reader, "feed_list", None)
    if fv is None:
        raise ValueError("read_file expects a DataLoader/PyReader "
                         "(feeds by name; no reader op exists)")
    return list(fv)
