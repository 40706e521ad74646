"""Convolution, pooling, normalization and dropout ops (the port's copy of
``conv2d``, ``pool2d``, ``batch_norm``, ``layer_norm`` and ``dropout`` from
``paddle_tpu/ops/nn_ops.py``).

Convolution and pooling are PyTorch's (``F.conv2d``, ``F.max_pool2d``,
``F.avg_pool2d``), as the JAX package leaves them to XLA. Activations keep
their declared layout: an NHWC tensor is handed over as its NCHW-shaped
permuted view (channels-last strides, no copy) and the result is permuted
back. The filter is OIHW in both layouts. No layout is tuned: the JAX
package's ``tuning.decide`` default is the declared format.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _to_nchw(x, fmt):
    return x.permute(0, 3, 1, 2) if fmt == "NHWC" else x


def _from_nchw(y, fmt):
    return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


@register("conv2d")
def conv2d(ctx, ins):
    """2-D convolution, ``paddings`` [ph, pw] (symmetric) or [top, bottom,
    left, right]; ``F.conv2d`` pads symmetrically only, so a 4-element
    padding is applied with ``F.pad`` first."""
    x, w = ins["Input"][0], ins["Filter"][0]
    fmt = ctx.attr("data_format", "NCHW") or "NCHW"
    pads = [int(p) for p in (ctx.attr("paddings", [0, 0]) or [0, 0])]
    xc = _to_nchw(x, fmt)
    if len(pads) == 4:
        xc = F.pad(xc, (pads[2], pads[3], pads[0], pads[1]))
        pads = [0, 0]
    y = F.conv2d(xc, w, stride=_pair(ctx.attr("strides", [1, 1])),
                 padding=tuple(pads), dilation=_pair(ctx.attr("dilations", [1, 1])),
                 groups=ctx.attr("groups", 1) or 1)
    return {"Output": [_from_nchw(y, fmt)]}


@register("pool2d")
def pool2d(ctx, ins):
    """max (padding -inf) or avg (``exclusive``: padded cells not counted)
    pooling; ``global_pooling`` reduces H and W; ``adaptive`` splits them
    into ``ksize`` equal bins (dims must divide)."""
    x = ins["X"][0]
    ptype = ctx.attr("pooling_type", "max")
    k = _pair(ctx.attr("ksize", [2, 2]))
    s = _pair(ctx.attr("strides", [2, 2]))
    p = _pair(ctx.attr("paddings", [0, 0]))
    fmt = ctx.attr("data_format", "NCHW") or "NCHW"
    sp_axes = (2, 3) if fmt == "NCHW" else (1, 2)
    if ctx.attr("global_pooling", False):
        if ptype == "max":
            return {"Out": [x.amax(dim=sp_axes, keepdim=True)]}
        return {"Out": [x.mean(dim=sp_axes, keepdim=True)]}
    if ctx.attr("adaptive", False):
        if fmt == "NCHW":
            n, c, h, w_ = x.shape
            xb = x.reshape(n, c, k[0], h // k[0], k[1], w_ // k[1])
            axes = (3, 5)
        else:
            n, h, w_, c = x.shape
            xb = x.reshape(n, k[0], h // k[0], k[1], w_ // k[1], c)
            axes = (2, 4)
        return {"Out": [xb.amax(dim=axes) if ptype == "max" else xb.mean(dim=axes)]}
    xc = _to_nchw(x, fmt)
    if ptype == "max":
        y = F.max_pool2d(xc, k, s, p)
    else:
        y = F.avg_pool2d(xc, k, s, p, count_include_pad=not ctx.attr("exclusive", True))
    return {"Out": [_from_nchw(y, fmt)]}


@register("batch_norm", nondiff_inputs=("Mean", "Variance"),
          nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
          state_inputs=("Mean", "Variance"))
def batch_norm(ctx, ins):
    """Train mode: batch statistics over every axis but the channel's, in
    f32, with the JAX package's E[x^2] - E[x]^2 variance; gradients flow
    through them; the running statistics move by ``momentum``. Test mode
    (``is_test`` or ``use_global_stats``): the running statistics.
    ``SavedVariance`` is rsqrt(var + eps)."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    c_axis = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.ndim - 1
    red_axes = tuple(i for i in range(x.ndim) if i != c_axis)
    bshape = [1] * x.ndim
    bshape[c_axis] = x.shape[c_axis]
    if ctx.attr("is_test", False) or ctx.attr("use_global_stats", False):
        mean, var = mean_in, var_in
        saved_mean, mean_out, var_out = mean_in, mean_in, var_in
    else:
        xf = x.float()
        mean = xf.mean(dim=red_axes)
        var = xf.square().mean(dim=red_axes) - mean.square()
        saved_mean = mean
        mean_out = mean_in * momentum + mean * (1 - momentum)
        var_out = var_in * momentum + var * (1 - momentum)
    inv = torch.rsqrt(var.float() + eps)
    y = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
    y = y * scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y.to(x.dtype)],
            "MeanOut": [mean_out.detach()], "VarianceOut": [var_out.detach()],
            "SavedMean": [saved_mean.detach()], "SavedVariance": [inv.detach()]}


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
