"""Reductions (the port's copy of ``paddle_tpu/ops/reduce_ops.py``:
``reduce_sum``, ``reduce_mean``, ``reduce_max``, ``reduce_min``,
``reduce_prod``, ``reduce_all``, ``reduce_any``, ``logsumexp`` and
``cumsum``): attrs ``dim`` (a list of axes, may be negative), ``keep_dim``
and ``reduce_all``.

``reduce_max`` / ``reduce_min`` are ``amax`` / ``amin``, whose gradient
splits evenly among tied maxima, as ``jnp.max``'s does.
"""
from __future__ import annotations

import torch

from ..core.registry import register


def _axes(ctx, x):
    """The reduced axes, or None for all of them."""
    if ctx.attr("reduce_all", False):
        return None
    dim = ctx.attr("dim", [0])
    if isinstance(dim, int):
        dim = [dim]
    return tuple(d % x.ndim for d in dim)


def _all_axes(fn):
    """``fn(x, axes, keep)`` with None read as every axis."""
    def reduce(x, axes, keep):
        return fn(x, tuple(range(x.ndim)) if axes is None else axes, keep)
    return reduce


def _prod(x, axes, keep):
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keep)
    return x


def _reduce(name, fn, grad="auto"):
    @register(name, grad=grad)
    def lower(ctx, ins):
        x = ins["X"][0]
        return {"Out": [fn(x, _axes(ctx, x), ctx.attr("keep_dim", False))]}

    return lower


@register("reduce_sum")
def reduce_sum(ctx, ins):
    x = ins["X"][0]
    axes, keep = _axes(ctx, x), ctx.attr("keep_dim", False)
    if axes is None:
        out = x.sum()
        if keep:
            out = out.reshape((1,) * x.ndim)
    else:
        out = torch.sum(x, dim=axes, keepdim=keep)
    return {"Out": [out]}


reduce_mean = _reduce("reduce_mean", _all_axes(lambda x, a, k: torch.mean(x, dim=a, keepdim=k)))
reduce_max = _reduce("reduce_max", _all_axes(lambda x, a, k: torch.amax(x, dim=a, keepdim=k)))
reduce_min = _reduce("reduce_min", _all_axes(lambda x, a, k: torch.amin(x, dim=a, keepdim=k)))
reduce_prod = _reduce("reduce_prod", _all_axes(_prod))
reduce_all = _reduce("reduce_all", _all_axes(lambda x, a, k: torch.all(x.bool(), dim=a, keepdim=k)),
                     grad=None)
reduce_any = _reduce("reduce_any", _all_axes(lambda x, a, k: torch.any(x.bool(), dim=a, keepdim=k)),
                     grad=None)
logsumexp = _reduce("logsumexp", _all_axes(lambda x, a, k: torch.logsumexp(x, dim=a, keepdim=k)))


@register("cumsum")
def cumsum(ctx, ins):
    """Along ``axis`` (all of x flattened with ``flatten``), optionally
    ``reverse`` and ``exclusive`` (each sum leaves out its own element)."""
    x = ins["X"][0]
    axis = ctx.attr("axis", -1)
    if ctx.attr("flatten", False):
        x, axis = x.reshape(-1), 0
    axis %= x.ndim
    reverse = ctx.attr("reverse", False)
    if reverse:
        x = torch.flip(x, dims=(axis,))
    out = torch.cumsum(x, dim=axis)
    if ctx.attr("exclusive", False):
        head = torch.zeros_like(out.narrow(axis, 0, 1))
        out = torch.cat([head, out.narrow(axis, 0, x.shape[axis] - 1)], dim=axis)
    if reverse:
        out = torch.flip(out, dims=(axis,))
    return {"Out": [out]}
