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
from .basic import jax_maximum, jax_minimum


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
# at a tie both take half the gradient and at a NaN neither takes any, as
# jnp.minimum / jnp.maximum (basic._MinMax)
elementwise_max = _binary("elementwise_max", jax_maximum)
elementwise_min = _binary("elementwise_min", jax_minimum)


class _Pow(torch.autograd.Function):
    """``torch.pow`` with JAX's gradient for a floating exponent: dX = g * y *
    x^(y - 1) unmasked (NaN at x = 0, y = 0, where ``torch.pow`` gives 0),
    dY = g * log(x, with 0 read as 1) * x^y. Differentiable again."""

    @staticmethod
    def forward(ctx, x, y):
        z = torch.pow(x, y)
        ctx.save_for_backward(x, y, z)
        return z

    @staticmethod
    def backward(ctx, g):
        x, y, z = ctx.saved_tensors
        gx = (g * (y * torch.pow(x, y - 1))).sum_to_size(x.shape)
        safe = torch.where(x == 0, torch.ones_like(x), x)
        gy = (g * (torch.log(safe) * z)).sum_to_size(y.shape)
        return gx, gy


def _pow(x, y):
    if x.is_floating_point() and y.is_floating_point():
        return _Pow.apply(x, y)
    return torch.pow(x, y)


elementwise_pow = _binary("elementwise_pow", _pow)
# ``jnp.mod`` takes the divisor's sign: ``torch.remainder``, not ``fmod``
elementwise_mod = _binary("elementwise_mod", torch.remainder)


def _floor_divide(x, y):
    """``jnp.floor_divide``: the floor of x / y (Python's rule, as
    ``torch.floor_divide``). Piecewise constant, so its gradient is zero, as
    JAX's; PyTorch has none, so the output is cut from autograd."""
    return torch.floor_divide(x.detach(), y.detach())


elementwise_floordiv = _binary("elementwise_floordiv", _floor_divide)
