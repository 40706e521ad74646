"""Weight decay: the port's copy of ``append_regularization_ops`` from
``paddle_tpu/regularizer.py``, for the path with no regularizer set.

A regularizer on a parameter or on the optimizer raises: the regularizer
classes are not ported yet (ROADMAP queue 1, item 1).
"""
from __future__ import annotations


def append_regularization_ops(params_grads, regularization=None):
    """Per-param attr wins over the optimizer-level setting; none is ported,
    so a set one raises."""
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is not None and g is not None:
            raise NotImplementedError(
                f"regularization (param {p.name!r}) is not ported yet "
                f"(ROADMAP queue 1, item 1: clip and regularizer classes)")
    return list(params_grads)
