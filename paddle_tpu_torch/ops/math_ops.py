"""Matmuls, softmax, cross-entropy and mean (the port's copy of ``matmul``,
``mul``, ``softmax``, ``log_softmax``, ``softmax_with_cross_entropy``,
``cross_entropy``, ``sigmoid_cross_entropy_with_logits``, ``mean``,
``square_error_cost`` and ``cos_sim`` from ``paddle_tpu/ops/math_ops.py``).

The products stay ``torch.matmul``, as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register


@register("matmul")
def matmul(ctx, ins):
    x, y = ins["X"][0], ins["Y"][0]
    if ctx.attr("transpose_X", False) and x.ndim > 1:
        x = x.transpose(-1, -2)
    if ctx.attr("transpose_Y", False) and y.ndim > 1:
        y = y.transpose(-1, -2)
    dt = torch.promote_types(x.dtype, y.dtype)
    out = torch.matmul(x.to(dt), y.to(dt))
    alpha = ctx.attr("alpha", 1.0)
    if alpha != 1.0:
        # alpha rounded to the output dtype first, as the JAX package does;
        # filled on the device, with no host copy
        out = out * torch.full((), alpha, dtype=out.dtype, device=out.device)
    return {"Out": [out]}


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


@register("softmax")
def softmax(ctx, ins):
    """Written out as ``jax.nn.softmax`` computes it, in x's dtype."""
    x = ins["X"][0]
    axis = ctx.attr("axis", -1)
    e = torch.exp(x - x.amax(dim=axis, keepdim=True).detach())
    return {"Out": [e / e.sum(dim=axis, keepdim=True)]}


@register("log_softmax")
def log_softmax(ctx, ins):
    """Written out as ``jax.nn.log_softmax`` computes it, in x's dtype."""
    x = ins["X"][0]
    axis = ctx.attr("axis", -1)
    shifted = x - x.amax(dim=axis, keepdim=True).detach()
    return {"Out": [shifted - torch.log(torch.exp(shifted).sum(dim=axis, keepdim=True))]}


@register("softmax_with_cross_entropy", nondiff_inputs=("Label",),
          nondiff_outputs=("Softmax",))
def softmax_with_cross_entropy(ctx, ins):
    """Stable softmax + cross-entropy. Hard labels: Label int [N...,1]; soft
    labels: Label of Logits' shape. Outputs Softmax (no gradient flows
    through it) and Loss [N...,1]."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    axis = ctx.attr("axis", -1)
    log_probs = logits - torch.logsumexp(logits, dim=axis, keepdim=True)
    softmax_out = torch.exp(log_probs).detach()
    if ctx.attr("soft_label", False):
        loss = -(label.to(log_probs.dtype) * log_probs).sum(dim=axis, keepdim=True)
    else:
        lab = label
        if lab.ndim == logits.ndim and lab.shape[axis] == 1:
            lab = lab.squeeze(axis)
        loss = -torch.take_along_dim(log_probs, lab.unsqueeze(-1).long(), dim=axis)
        ignore = ctx.attr("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where(lab.unsqueeze(-1) != ignore, loss, torch.zeros_like(loss))
    return {"Softmax": [softmax_out], "Loss": [loss]}


@register("cross_entropy", nondiff_inputs=("Label",))
def cross_entropy(ctx, ins):
    """Cross-entropy of probabilities X: hard labels (int [N...,1]) or soft
    labels of X's shape; Y [N...,1]."""
    x, label = ins["X"][0], ins["Label"][0]
    if ctx.attr("soft_label", False):
        loss = -(label.to(x.dtype) * torch.log(x)).sum(dim=-1, keepdim=True)
    else:
        lab = label
        if lab.ndim == x.ndim and lab.shape[-1] == 1:
            lab = lab.squeeze(-1)
        loss = -torch.log(torch.take_along_dim(x, lab.unsqueeze(-1).long(), dim=-1))
        ignore = ctx.attr("ignore_index", -100)
        if ignore >= 0:
            loss = torch.where(lab.unsqueeze(-1) != ignore, loss, torch.zeros_like(loss))
    return {"Y": [loss]}


@register("sigmoid_cross_entropy_with_logits")
def sigmoid_cross_entropy_with_logits(ctx, ins):
    """The JAX package's stable form, max(x, 0) - x z + log1p(exp(-|x|)),
    written out so that the generic grad differentiates the same expression
    (Label is differentiable there too). ``ignore_index`` zeroes the
    positions whose label equals it; ``normalize`` divides by the count of
    the others."""
    x, label = ins["X"][0], ins["Label"][0]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    # |x| whose gradient at 0 is 1, as ``jnp.abs``'s (``torch.abs``'s is 0)
    abs_x = torch.where(x >= 0, x, -x)
    loss = (torch.maximum(x, zero) - x * label.to(x.dtype)
            + torch.log1p(torch.exp(-abs_x)))
    ignore = ctx.attr("ignore_index", -100)
    if ignore >= 0:
        loss = torch.where(label != ignore, loss, torch.zeros_like(loss))
    if ctx.attr("normalize", False):
        loss = loss / torch.clamp_min(torch.sum((label != ignore).to(x.dtype)), 1.0)
    return {"Out": [loss]}


@register("mean")
def mean(ctx, ins):
    return {"Out": [ins["X"][0].mean().reshape((1,))]}


@register("square_error_cost")
def square_error_cost(ctx, ins):
    d = ins["X"][0] - ins["Y"][0]
    return {"Out": [d * d]}


@register("cos_sim")
def cos_sim(ctx, ins):
    """Cosine of X and Y along the last axis, [..., 1], with the norms
    XNorm and YNorm; no epsilon, as the JAX lowering has none."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn)
    return {"Out": [out], "XNorm": [xn], "YNorm": [yn]}
