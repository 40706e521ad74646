"""Reductions (the port's copy of ``reduce_sum`` from
``paddle_tpu/ops/reduce_ops.py``): attrs ``dim`` (a list of axes, may be
negative), ``keep_dim`` and ``reduce_all``."""
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
