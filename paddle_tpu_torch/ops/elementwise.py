"""Broadcastable binary elementwise ops with Fluid ``axis`` semantics (the
port's copy of ``paddle_tpu/ops/elementwise.py``).

Fluid broadcast rule: Y's shape must match a contiguous dim-run of X starting
at ``axis`` (default: trailing alignment, axis = x.ndim - y.ndim); Y is
reshaped to x.ndim with singleton dims outside the run, then broadcast.
"""
from __future__ import annotations

from ..core.registry import register


def _broadcast_y(x, y, axis):
    if x.shape == y.shape or y.ndim == 0:
        return y
    if axis is None or axis == -1:
        axis = x.ndim - y.ndim
    yshape = list(y.shape)
    # trailing singleton dims of Y beyond the matched run are dropped
    # (X [2,3,4], Y [3,1] with axis=1 means Y is really [3])
    while len(yshape) > 1 and yshape[-1] == 1 and axis + len(yshape) > x.ndim:
        yshape.pop()
    return y.reshape([1] * axis + yshape + [1] * (x.ndim - axis - len(yshape)))


@register("elementwise_add")
def elementwise_add(ctx, ins):
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [x + _broadcast_y(x, y, ctx.attr("axis", -1))]}
