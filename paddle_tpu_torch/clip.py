"""Gradient clipping: the port's copy of ``append_gradient_clip_ops`` from
``paddle_tpu/clip.py``, for the path with no clip set.

A parameter with a ``gradient_clip`` attr raises: the clip classes are not
ported yet (ROADMAP queue 1, item 1).
"""
from __future__ import annotations


def append_gradient_clip_ops(params_grads):
    """Apply per-param clip attrs (none are ported: a set one raises)."""
    for p, g in params_grads:
        if g is not None and getattr(p, "gradient_clip", None) is not None:
            raise NotImplementedError(
                f"gradient clipping (param {p.name!r}) is not ported yet "
                f"(ROADMAP queue 1, item 1: clip and regularizer classes)")
    return list(params_grads)
