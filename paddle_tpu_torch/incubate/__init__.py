"""Incubate namespace: the MultiSlot data generator (the port's copy of
``paddle_tpu/incubate/data_generator.py``; the fleet facade is not ported)."""
from . import data_generator  # noqa: F401
