"""Normalization / regularization ops (the port's copy of ``layer_norm`` and
``dropout`` from ``paddle_tpu/ops/nn_ops.py``)."""
from __future__ import annotations

import torch

from ..core.registry import register


@register("layer_norm", nondiff_outputs=("Mean", "Variance"))
def layer_norm(ctx, ins):
    """Normalize over dims >= begin_norm_axis, computed in f32 and cast back."""
    x = ins["X"][0]
    eps = ctx.attr("epsilon", 1e-5)
    bna = ctx.attr("begin_norm_axis", 1)
    axes = tuple(range(bna, x.ndim))
    norm_shape = (1,) * bna + tuple(x.shape[bna:])
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    scale = ins.get("Scale", [None])[0]
    if scale is not None:
        y = y * scale.reshape(norm_shape).float()
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        y = y + bias.reshape(norm_shape).float()
    lead = tuple(x.shape[:bna])
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(lead)],
            "Variance": [var.reshape(lead)]}


@register("dropout", nondiff_outputs=("Mask",))
def dropout(ctx, ins):
    """dropout_implementation: 'downgrade_in_infer' (scale the output by
    (1-p) at inference) or 'upscale_in_train' (scale kept units by 1/(1-p)
    in training). The train-mode mask comes from the op's generator."""
    x = ins["X"][0]
    p = ctx.attr("dropout_prob", 0.5)
    impl = ctx.attr("dropout_implementation", "downgrade_in_infer")
    if ctx.attr("is_test", False):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        # the declared Mask output is produced as a broadcast view of one 1
        return {"Out": [out],
                "Mask": [torch.ones((), dtype=x.dtype, device=ctx.device).expand(x.shape)]}
    keep = torch.rand(x.shape, generator=ctx.rng(ctx.attr("seed", 0) or 0),
                      device=ctx.device) >= p
    mask = keep.to(x.dtype)
    if impl == "upscale_in_train":
        out = torch.zeros_like(x) if p >= 1.0 else x * mask / (1.0 - p)
    else:
        out = x * mask
    return {"Out": [out], "Mask": [mask]}
