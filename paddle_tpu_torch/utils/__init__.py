"""Helpers (the port's copy of the part of ``paddle_tpu/utils/`` it needs):
``clock`` (the time seam), ``fs`` (local and scheme'd paths),
``checkpointer`` (``Checkpointer``), ``flops`` (``program_flops`` and the
card's peak table) and ``benchtime`` (per-call time from chained
segments)."""
from . import benchtime, checkpointer, clock, flops, fs  # noqa: F401
