"""Rank and world size from the launcher's environment (the port's copy of
``paddle_tpu/parallel/env.py``: ``get_rank``, ``get_world_size``,
``shard_batch``).

The variables are the JAX package's: ``PROCESS_ID`` / ``PADDLE_TRAINER_ID``
for the rank, ``NUM_PROCESSES`` / ``PADDLE_TRAINERS_NUM`` or the count of
``PADDLE_TRAINER_ENDPOINTS`` for the world. There is no
``torch.distributed`` process group behind them yet.
"""
from __future__ import annotations

import os
from typing import Optional


def _env_int(*names, default=0) -> int:
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return default


def get_rank() -> int:
    """Process index: ``PROCESS_ID``, else ``PADDLE_TRAINER_ID``, else 0."""
    return _env_int("PROCESS_ID", "PADDLE_TRAINER_ID", default=0)


def get_world_size() -> int:
    """Process count: ``NUM_PROCESSES``, ``PADDLE_TRAINERS_NUM``, the number
    of ``PADDLE_TRAINER_ENDPOINTS``, else 1."""
    n = _env_int("NUM_PROCESSES", "PADDLE_TRAINERS_NUM", default=0)
    if n:
        return n
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return len(eps.split(",")) if eps else 1


def shard_batch(array, rank: Optional[int] = None, world_size: Optional[int] = None):
    """This process's rows of a global batch: rows [r*B/W, (r+1)*B/W)."""
    r = rank if rank is not None else get_rank()
    w = world_size if world_size is not None else get_world_size()
    if w <= 1:
        return array
    b = array.shape[0]
    if b % w != 0:
        raise ValueError(f"global batch {b} not divisible by {w} hosts")
    per = b // w
    return array[r * per:(r + 1) * per]
