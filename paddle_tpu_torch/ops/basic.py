"""Creation, casting, copy and sum ops (the port's copy of part of
``paddle_tpu/ops/basic.py``).

New tensors go on ``ctx.device`` (the meta device under shape inference).
Random ops draw from the op's ``torch.Generator``, seeded on the host; the
numbers differ from the JAX package's, so tests hold them by mean and std,
not by bits. They run in startup programs, once: they are registered
``host_rng``, and the executor does not capture a program that holds one as
a CUDA graph (a replay would draw the numbers of the captured run again).
"""
from __future__ import annotations

import torch

from ..core.registry import register, simple_op, torch_dtype


def _shape(ctx):
    return tuple(int(s) for s in ctx.attr("shape", []))


@register("fill_constant", grad=None)
def fill_constant(ctx, ins):
    return {"Out": [torch.full(_shape(ctx), ctx.attr("value", 0.0),
                               dtype=torch_dtype(ctx.attr("dtype", "float32")),
                               device=ctx.device)]}


@register("gaussian_random", grad=None, host_rng=True)
def gaussian_random(ctx, ins):
    x = torch.randn(_shape(ctx), generator=ctx.rng(ctx.attr("seed", 0)),
                    dtype=torch.float32, device=ctx.device)
    x = x * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)
    return {"Out": [x.to(torch_dtype(ctx.attr("dtype", "float32")))]}


@register("uniform_random", grad=None, host_rng=True)
def uniform_random(ctx, ins):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    x = torch.rand(_shape(ctx), generator=ctx.rng(ctx.attr("seed", 0)),
                   dtype=torch.float32, device=ctx.device)
    return {"Out": [(x * (hi - lo) + lo).to(torch_dtype(ctx.attr("dtype", "float32")))]}


@simple_op("assign")
def assign(ctx, x):
    return x


@simple_op("cast")
def cast(ctx, x):
    return x.to(torch_dtype(ctx.attr("out_dtype", "float32")))


@simple_op("scale")
def scale(ctx, x):
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return (x * s + b).to(x.dtype)
    return ((x + b) * s).to(x.dtype)


@register("sum")
def sum_op(ctx, ins):
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}
