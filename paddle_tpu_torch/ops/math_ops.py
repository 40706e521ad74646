"""Matmul ops (the port's copy of ``mul`` from ``paddle_tpu/ops/math_ops.py``).

The product stays ``torch.matmul``, as the JAX package leaves it to XLA.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register


@register("mul")
def mul(ctx, ins):
    """Flattening matmul: X flattened to 2D at x_num_col_dims, Y at y_num_col_dims."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    xlead = tuple(x.shape[:xn])
    # mixed operands (a bf16 activation against an f32 weight) promote as in JAX
    dt = torch.promote_types(x.dtype, y.dtype)
    x2 = x.reshape(math.prod(xlead), -1).to(dt)
    y2 = y.reshape(math.prod(y.shape[:yn]), -1).to(dt)
    return {"Out": [torch.matmul(x2, y2).reshape(xlead + tuple(y.shape[yn:]))]}
