"""Helpers the training loop's fault tolerance stands on (the port's copy of
the part of ``paddle_tpu/utils/`` it needs): ``clock`` (the time seam),
``fs`` (local and scheme'd paths) and ``checkpointer`` (``Checkpointer``)."""
from . import checkpointer, clock, fs  # noqa: F401
