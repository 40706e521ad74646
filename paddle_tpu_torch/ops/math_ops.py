"""Matmuls, softmax, the losses, the norms and mean (the port's copy of
``paddle_tpu/ops/math_ops.py``, all 18 types).

The products stay ``torch.matmul``, as the JAX package leaves them to XLA.
``|x|`` is ``activations.jnp_abs`` wherever the JAX lowering takes
``jnp.abs``, whose gradient at 0 is 1 (``torch.abs``'s is 0).
"""
from __future__ import annotations

import math

import torch

from ..core.registry import register
from .activations import jnp_abs


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
    loss = (torch.maximum(x, zero) - x * label.to(x.dtype)
            + torch.log1p(torch.exp(-jnp_abs(x))))
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


@register("bmm")
def bmm(ctx, ins):
    return {"Out": [torch.matmul(ins["X"][0], ins["Y"][0])]}


@register("dot")
def dot(ctx, ins):
    """The rows' inner products, [..., 1]."""
    return {"Out": [torch.sum(ins["X"][0] * ins["Y"][0], dim=-1, keepdim=True)]}


@register("cross_entropy2", nondiff_inputs=("Label",))
def cross_entropy2(ctx, ins):
    """Hard-label cross-entropy of probabilities X, with the matched
    probability MatchX (no gradient). A row whose label is ``ignore_index``
    or out of [0, classes) gives 0 and no gradient."""
    x, label = ins["X"][0], ins["Label"][0]
    lab = label.squeeze(-1) if label.ndim == x.ndim and label.shape[-1] == 1 else label
    li = lab.unsqueeze(-1)
    keep = (li != ctx.attr("ignore_index", -100)) & (li >= 0) & (li < x.shape[-1])
    safe = torch.where(keep, li, torch.zeros_like(li)).long()
    picked = torch.take_along_dim(x, safe, dim=-1)
    loss = torch.where(keep, -torch.log(picked), torch.zeros_like(picked))
    return {"Y": [loss], "MatchX": [picked.detach()]}


@register("huber_loss", nondiff_outputs=("Residual",))
def huber_loss(ctx, ins):
    """r = Y - X; 0.5 r^2 where |r| <= delta, else delta (|r| - delta / 2)."""
    x, y = ins["X"][0], ins["Y"][0]
    d = ctx.attr("delta", 1.0)
    r = y - x
    a = jnp_abs(r)
    loss = torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))
    return {"Out": [loss], "Residual": [r.detach()]}


@register("smooth_l1_loss", nondiff_outputs=("Diff",))
def smooth_l1_loss(ctx, ins):
    """d = (X - Y) * InsideWeight; 0.5 d^2 sigma^2 where |d| < 1 / sigma^2,
    else |d| - 0.5 / sigma^2; times OutsideWeight, summed per row: [N, 1]."""
    x, y = ins["X"][0], ins["Y"][0]
    s2 = ctx.attr("sigma", 1.0) ** 2
    d = x - y
    inside = ins.get("InsideWeight", [None])
    if inside and inside[0] is not None:
        d = d * inside[0]
    a = jnp_abs(d)
    loss = torch.where(a < 1.0 / s2, 0.5 * d * d * s2, a - 0.5 / s2)
    outside = ins.get("OutsideWeight", [None])
    if outside and outside[0] is not None:
        loss = loss * outside[0]
    return {"Out": [loss.reshape(loss.shape[0], -1).sum(dim=1, keepdim=True)],
            "Diff": [d.detach()]}


@register("l2_normalize")
def l2_normalize(ctx, ins):
    """x / sqrt(sum(x^2 along axis) + epsilon), with that Norm."""
    x = ins["X"][0]
    norm = torch.sqrt(torch.sum(x * x, dim=ctx.attr("axis", -1), keepdim=True)
                      + ctx.attr("epsilon", 1e-12))
    return {"Out": [x / norm], "Norm": [norm]}


@register("p_norm")
def p_norm(ctx, ins):
    """(sum |x|^p along axis)^(1/p)."""
    x = ins["X"][0]
    p = ctx.attr("porder", 2.0)
    s = torch.sum(torch.pow(jnp_abs(x), p), dim=ctx.attr("axis", -1),
                  keepdim=ctx.attr("keepdim", False))
    return {"Out": [torch.pow(s, 1.0 / p)]}


@register("log_loss")
def log_loss(ctx, ins):
    """-label log(p + eps) - (1 - label) log(1 - p + eps)."""
    p, label = ins["Predicted"][0], ins["Labels"][0]
    eps = ctx.attr("epsilon", 1e-4)
    return {"Loss": [-label * torch.log(p + eps) - (1 - label) * torch.log(1 - p + eps)]}
