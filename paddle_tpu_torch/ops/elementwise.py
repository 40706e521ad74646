"""Broadcastable binary elementwise ops with Fluid ``axis`` semantics (the
port's copy of ``paddle_tpu/ops/elementwise.py``: add, sub, mul, div, min,
max, pow, mod and floordiv).

Fluid broadcast rule: Y's shape must match a contiguous dim-run of X starting
at ``axis`` (default: trailing alignment, axis = x.ndim - y.ndim); Y is
reshaped to x.ndim with singleton dims outside the run, then broadcast.
Integer operands compute in their own dtype (``beam_decode`` multiplies an
int64 prefix by 0); the generic grad differentiates float inputs only.
"""
from __future__ import annotations

import torch

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


def _binary(name, fn):
    @register(name)
    def lower(ctx, ins):
        x, y = ins["X"][0], ins["Y"][0]
        return {"Out": [fn(x, _broadcast_y(x, y, ctx.attr("axis", -1)))]}

    return lower


elementwise_add = _binary("elementwise_add", lambda x, y: x + y)
elementwise_sub = _binary("elementwise_sub", lambda x, y: x - y)
elementwise_mul = _binary("elementwise_mul", lambda x, y: x * y)
# true division for integer operands too, as jnp's ``/``
elementwise_div = _binary("elementwise_div", lambda x, y: x / y)
elementwise_max = _binary("elementwise_max", torch.maximum)
# at a tie both take half the gradient, as jnp.minimum / jnp.maximum
elementwise_min = _binary("elementwise_min", torch.minimum)
elementwise_pow = _binary("elementwise_pow", torch.pow)
# ``jnp.mod`` takes the divisor's sign: ``torch.remainder``, not ``fmod``
elementwise_mod = _binary("elementwise_mod", torch.remainder)


def _floor_divide(x, y):
    """``jnp.floor_divide``: the floor of x / y (Python's rule, as
    ``torch.floor_divide``). Piecewise constant, so its gradient is zero, as
    JAX's; PyTorch has none, so the output is cut from autograd."""
    return torch.floor_divide(x.detach(), y.detach())


elementwise_floordiv = _binary("elementwise_floordiv", _floor_divide)
