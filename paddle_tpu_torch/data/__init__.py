"""Fault-tolerant data plane (the port's copy of ``paddle_tpu/data/``):
streaming ingestion with source retry, poison-record quarantine and exact
mid-stream resume.

Not imported by ``paddle_tpu_torch/__init__.py``: a run that never streams
starts no reader thread and opens no buffer.

    from paddle_tpu_torch.data import StreamingDataset, FileTailSource
    ds = StreamingDataset()
    ds.add_source(FileTailSource("clicks.txt", follow=True))
    ds.set_use_var([x, label]); ds.set_batch_size(64)
    ds.set_epoch_bound(steps=1000)
    exe.train_from_dataset(main, ds, fetch_list=[loss])

``paddle_tpu_torch.data`` is also the ``data(...)`` input-layer function
(``layers/io.py``). Importing this package rebinds the parent's ``data``
attribute to the module, so the module is made callable and forwards: both
``pt.data("x", [8], "float32")`` and ``paddle_tpu_torch.data.StreamingDataset``
work, in either import order, as in the JAX package.
"""
import sys
import types

from ..layers.io import data as _data_layer_fn
from .streaming import (FileTailSource, GeneratorSource,  # noqa: F401
                        PoisonFeed, SocketSource, SourceLost, StreamError,
                        StreamSource, StreamingDataset)

__all__ = [
    "FileTailSource", "GeneratorSource", "PoisonFeed", "SocketSource",
    "SourceLost", "StreamError", "StreamSource", "StreamingDataset",
]


class _CallableDataModule(types.ModuleType):
    """Module subclass forwarding calls to the ``data`` layer function."""

    def __call__(self, *args, **kwargs):
        return _data_layer_fn(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableDataModule
