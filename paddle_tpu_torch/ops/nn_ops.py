"""Convolution, pooling, normalization, dropout and resize ops (the port's
copy of ``paddle_tpu/ops/nn_ops.py``: ``conv2d``, ``depthwise_conv2d``,
``conv2d_transpose``, ``conv3d``, ``conv3d_transpose``, ``pool2d``,
``pool3d``, ``batch_norm`` and its alias ``sync_batch_norm``
(``paddle_tpu/ops/tail_ops.py``), ``layer_norm``, ``group_norm``,
``instance_norm``, ``prelu``, ``dropout``, the resize family
``interpolate``, ``nearest_interp``, ``bilinear_interp``,
``trilinear_interp``, and ``space_to_depth`` and ``fsp`` from
``paddle_tpu/ops/extra_ops.py``).

Convolution and pooling are PyTorch's (``F.conv2d``, ``F.conv3d``, their
transposes, ``F.max_pool2d`` / ``3d``, ``F.avg_pool2d`` / ``3d``), as the
JAX package leaves them to XLA. A ``depthwise_conv2d`` is ``conv2d`` with
one group a channel. ``sync_batch_norm`` is ``batch_norm``: on one card
the batch statistics are the global ones (the JAX package's alias: under
its whole-program jit the reductions are global). Activations keep
their declared layout: an NHWC tensor is handed over as its NCHW-shaped
permuted view (channels-last strides, no copy) and the result is permuted
back. The filter is OIHW in both layouts. The layout cuDNN computes in is
the autotuner's ``conv2d.layout`` choice (``conv_in_layout``); its default
is the declared format.

The resize family is ``jax.image.resize``'s method, ported as it computes,
not ``F.interpolate`` (whose ``nearest`` takes another source index, whose
``bicubic`` has another kernel, and which does not antialias a downsample
by default). Each resized axis is a contraction with a weight matrix built
as ``jax.image.scale_and_translate`` builds it (half-pixel centres; the
triangle or the Keys cubic kernel with a = -0.5, widened by the scale on a
downsample), cached per shape and device; ``nearest`` gathers
``floor((i + 0.5) * in / out)``, and its gradient sums each source's run of
outputs in a fixed order (``_NearestSelect``), so a step on the card is the
same run to run. ``align_corners`` and ``align_mode`` are not read: the JAX
package ignores them too (ROADMAP 3.22).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register
from . import dropout as dropout_op
from .basic import device_constant


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _to_nchw(x, fmt):
    return x.permute(0, 3, 1, 2) if fmt == "NHWC" else x


def _from_nchw(y, fmt):
    return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


def conv_in_layout(x, w, strides, pads, dils, groups, fmt, layout):
    """A 2-D convolution of ``x`` (declared layout ``fmt``) computed by cuDNN
    in ``layout``, returned in ``fmt``: with ``layout`` the declared one the
    activations go over as they are (an NHWC tensor as its channels-last
    NCHW view); otherwise the activations and the filter are copied into
    ``layout``'s memory format (``torch.channels_last`` for NHWC, contiguous
    for NCHW) and the output is copied back into ``fmt``'s. ``pads`` is
    [ph, pw] (symmetric) or [top, bottom, left, right]; ``F.conv2d`` pads
    symmetrically only, so a 4-element padding is applied with ``F.pad``."""
    pads = [int(p) for p in pads]
    xc = _to_nchw(x, fmt)
    if layout != fmt:
        mf = torch.channels_last if layout == "NHWC" else torch.contiguous_format
        xc, w = xc.contiguous(memory_format=mf), w.contiguous(memory_format=mf)
    if len(pads) == 4:
        xc = F.pad(xc, (pads[2], pads[3], pads[0], pads[1]))
        pads = [0, 0]
    y = F.conv2d(xc, w, stride=tuple(strides), padding=tuple(pads), dilation=tuple(dils),
                 groups=groups)
    out = _from_nchw(y, fmt)
    return out.contiguous() if layout != fmt else out


def _conv(ctx, ins, depthwise=False):
    """2-D convolution (``conv_in_layout``) in the layout the autotuner's
    ``conv2d.layout`` picks, the declared ``data_format`` by default;
    ``depthwise``: one group a channel, whatever ``groups`` says."""
    x, w = ins["Input"][0], ins["Filter"][0]
    fmt = ctx.attr("data_format", "NCHW") or "NCHW"
    pads = [int(p) for p in (ctx.attr("paddings", [0, 0]) or [0, 0])]
    strides = _pair(ctx.attr("strides", [1, 1]))
    dils = _pair(ctx.attr("dilations", [1, 1]))
    groups = ctx.attr("groups", 1) or 1
    if depthwise:
        groups = x.shape[1] if fmt == "NCHW" else x.shape[-1]
    layout = fmt
    if not ctx.abstract and x.ndim == 4:
        from ..tuning import choices as _choices
        layout = _choices.decide("conv2d.layout", {
            "x_shape": tuple(x.shape), "w_shape": tuple(w.shape),
            "strides": tuple(strides), "pads": list(_pair(pads)),
            "dils": tuple(dils), "groups": groups, "fmt": fmt,
            "dtype": _choices.dtype_name(x)})
    return {"Output": [conv_in_layout(x, w, strides, pads, dils, groups, fmt, layout)]}


register("conv2d")(lambda ctx, ins: _conv(ctx, ins))
register("depthwise_conv2d")(lambda ctx, ins: _conv(ctx, ins, depthwise=True))


def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


@register("conv3d")
def conv3d(ctx, ins):
    """3-D convolution, NCDHW, filter OIDHW, symmetric ``paddings``."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": [F.conv3d(x, w, stride=_triple(ctx.attr("strides", [1, 1, 1])),
                                padding=_triple(ctx.attr("paddings", [0, 0, 0])),
                                dilation=_triple(ctx.attr("dilations", [1, 1, 1])),
                                groups=ctx.attr("groups", 1) or 1)]}


@register("conv3d_transpose")
def conv3d_transpose(ctx, ins):
    """3-D transposed convolution: filter [in_c, out_c / groups, kd, kh,
    kw], ``paddings`` cropping the output (``conv2d_transpose``'s rules)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": [F.conv_transpose3d(
        x, w, stride=_triple(ctx.attr("strides", [1, 1, 1])),
        padding=_triple(ctx.attr("paddings", [0, 0, 0])),
        dilation=_triple(ctx.attr("dilations", [1, 1, 1])), groups=ctx.attr("groups", 1) or 1)]}


@register("conv2d_transpose")
def conv2d_transpose(ctx, ins):
    """2-D transposed convolution (cuDNN's ``conv_transpose2d``): filter
    [in_c, out_c / groups, kh, kw], ``paddings`` cropping the output, any
    kernel size, dilation and groups (the JAX package's padding and layout
    rules, ``paddle_tpu/ops/nn_ops.py:116-125``)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    return {"Output": [F.conv_transpose2d(
        x, w, stride=_pair(ctx.attr("strides", [1, 1])),
        padding=_pair(ctx.attr("paddings", [0, 0])),
        dilation=_pair(ctx.attr("dilations", [1, 1])), groups=ctx.attr("groups", 1) or 1)]}


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


@register("pool3d")
def pool3d(ctx, ins):
    """``pool2d``'s knobs over D, H and W of an NCDHW tensor."""
    x = ins["X"][0]
    ptype = ctx.attr("pooling_type", "max")
    k = _triple(ctx.attr("ksize", [2, 2, 2]))
    s = _triple(ctx.attr("strides", [2, 2, 2]))
    p = _triple(ctx.attr("paddings", [0, 0, 0]))
    if ctx.attr("global_pooling", False):
        axes = (2, 3, 4)
        return {"Out": [x.amax(dim=axes, keepdim=True) if ptype == "max"
                        else x.mean(dim=axes, keepdim=True)]}
    if ctx.attr("adaptive", False):
        n, c, d, h, w = x.shape
        xb = x.reshape(n, c, k[0], d // k[0], k[1], h // k[1], k[2], w // k[2])
        axes = (3, 5, 7)
        return {"Out": [xb.amax(dim=axes) if ptype == "max" else xb.mean(dim=axes)]}
    if ptype == "max":
        return {"Out": [F.max_pool3d(x, k, s, p)]}
    return {"Out": [F.avg_pool3d(x, k, s, p,
                                 count_include_pad=not ctx.attr("exclusive", True))]}


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


register("sync_batch_norm", nondiff_inputs=("Mean", "Variance"),
         nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
         state_inputs=("Mean", "Variance"))(batch_norm)


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


def _affine(y, ins, c, ndim):
    """y * Scale + Bias over the channel axis 1, each where the op has it."""
    bshape = (1, c) + (1,) * (ndim - 2)
    scale = ins.get("Scale", [None])[0]
    if scale is not None:
        y = y * scale.reshape(bshape)
    bias = ins.get("Bias", [None])[0]
    if bias is not None:
        y = y + bias.reshape(bshape)
    return y


@register("group_norm", nondiff_outputs=("Mean", "Variance"))
def group_norm(ctx, ins):
    """Normalize each of ``groups`` channel groups over its channels and
    spatial axes, in f32; ``Mean`` / ``Variance`` are [N, groups]."""
    x = ins["X"][0]
    g = ctx.attr("groups", 1)
    eps = ctx.attr("epsilon", 1e-5)
    n, c = x.shape[0], x.shape[1]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:])).float()
    axes = tuple(range(2, xg.ndim))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    y = _affine(((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape), ins, c, x.ndim)
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(n, g).detach()],
            "Variance": [var.reshape(n, g).detach()]}


@register("instance_norm", nondiff_outputs=("SavedMean", "SavedVariance"))
def instance_norm(ctx, ins):
    """Normalize each (sample, channel) over its spatial axes, in f32;
    ``SavedMean`` / ``SavedVariance`` squeezed as the JAX package's."""
    x = ins["X"][0]
    eps = ctx.attr("epsilon", 1e-5)
    axes = tuple(range(2, x.ndim))
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    var = (xf - mean).square().mean(dim=axes, keepdim=True)
    y = _affine((xf - mean) * torch.rsqrt(var + eps), ins, x.shape[1], x.ndim)
    return {"Y": [y.to(x.dtype)], "SavedMean": [mean.squeeze().detach()],
            "SavedVariance": [var.squeeze().detach()]}


@register("prelu")
def prelu(ctx, ins):
    """x where x > 0, else alpha * x; ``mode`` all (one alpha), channel (one
    a channel, axis 1) or element (one an element of a sample)."""
    x, alpha = ins["X"][0], ins["Alpha"][0]
    mode = ctx.attr("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    elif mode == "element":
        alpha = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": [torch.where(x > 0, x, alpha * x)]}


@register("space_to_depth")
def space_to_depth(ctx, ins):
    """NCHW [B, C, H, W] -> [B, C s^2, H / s, W / s], channel index
    (dh s + dw) C + c, as the JAX package orders it."""
    x = ins["X"][0]
    s = int(ctx.attr("blocksize"))
    b, c, h, w = x.shape
    out = x.reshape(b, c, h // s, s, w // s, s).permute(0, 3, 5, 1, 2, 4)
    return {"Out": [out.reshape(b, c * s * s, h // s, w // s)]}


@register("fsp")
def fsp(ctx, ins):
    """The flow-of-solution-procedure matrix of two NCHW feature maps:
    [B, C1, HW] @ [B, HW, C2] / HW."""
    x, y = ins["X"][0], ins["Y"][0]
    h, w = x.shape[2], x.shape[3]
    return {"Out": [torch.einsum("bchw,bdhw->bcd", x, y) / (h * w)]}


@register("dropout", nondiff_outputs=("Mask",))
def dropout(ctx, ins):
    """dropout_implementation: 'downgrade_in_infer' (scale the output by
    (1-p) at inference) or 'upscale_in_train' (scale kept units by 1/(1-p)
    in training). The train-mode mask is Philox's for the op's dropout seed
    (``ops/dropout.py``: the CUDA kernel on the card, its plain version on the
    CPU); the attr ``seed`` offsets the op's salt."""
    x = ins["X"][0]
    p = ctx.attr("dropout_prob", 0.5)
    upscale = ctx.attr("dropout_implementation", "downgrade_in_infer") == "upscale_in_train"
    if ctx.attr("is_test", False):
        out = x if upscale else x * (1.0 - p)
        # the declared Mask output is produced as a broadcast view of one 1
        return {"Out": [out],
                "Mask": [torch.ones((), dtype=x.dtype, device=ctx.device).expand(x.shape)]}
    if ctx.abstract:
        return {"Out": [torch.empty_like(x)], "Mask": [torch.empty_like(x)]}
    out, mask = dropout_op.dropout(x, p, upscale, ctx.kernel_seed(ctx.attr("seed", 0) or 0))
    return {"Out": [out], "Mask": [mask]}


# ---------------------------------------------------------------------------------------
# the resize family (jax.image.resize's method)
# ---------------------------------------------------------------------------------------

def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    """The Keys cubic kernel, a = -0.5 (``jax.image``'s ``cubic``)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = torch.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return torch.where(x >= 2., 0., out)


_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def _weight_mat(m, n, method, antialias=True):
    """``jax.image.compute_weight_mat(m, n, n / m, 0.0, kernel, antialias)``
    in f32, op for op: [m, n], column j the weights of output j."""
    f32 = torch.float32
    inv_scale = 1. / (n / m)
    kernel_scale = float(np.float32(max(inv_scale, 1.))) if antialias else 1.
    sample_f = (torch.arange(n, dtype=f32) + 0.5) * inv_scale - 0.0 * inv_scale - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(m, dtype=f32)[:, None]) / kernel_scale
    weights = _KERNELS[method](x)
    total = torch.sum(weights, 0, keepdim=True)
    weights = torch.where(torch.abs(total) > 1000. * float(torch.finfo(f32).eps),
                          weights / torch.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], weights, 0)


def _nearest_index(m, n):
    """The source row of each output row, ``floor((i + 0.5) * m / n)`` in
    f32 as ``jax.image`` computes it (torch's ``nearest-exact``)."""
    return torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n).to(torch.int64)


def _nearest_runs(m, n):
    """[m, R] output rows that read each source row, padded with n (a zero
    row appended to the gradient): R is the longest run."""
    idx = _nearest_index(m, n).numpy()
    width = max(1, int(np.bincount(idx, minlength=m).max()))
    runs = np.full((m, width), n, dtype=np.int64)
    for i in range(m):
        js = np.flatnonzero(idx == i)
        runs[i, :len(js)] = js
    return torch.from_numpy(runs)


class _NearestSelect(torch.autograd.Function):
    """``x.index_select(dim, index)`` whose gradient sums each source row's
    outputs in a fixed order (``runs``), not with atomics."""

    @staticmethod
    def forward(ctx, x, dim, index, runs):
        ctx.dim, ctx.runs = dim, runs
        return x.index_select(dim, index)

    @staticmethod
    def backward(ctx, g):
        dim, runs = ctx.dim, ctx.runs
        pad = [0, 0] * (g.ndim - 1 - dim) + [0, 1]
        gp = F.pad(g, pad)
        m, width = runs.shape
        taken = gp.index_select(dim, runs.reshape(-1))
        shape = list(g.shape)
        shape[dim:dim + 1] = [m, width]
        return taken.reshape(shape).sum(dim + 1), None, None, None


def _resize(x, out_shape, method, device):
    """``jax.image.resize(x, out_shape, method)`` (antialias on): every axis
    whose size changes, in order."""
    for d, (m, n) in enumerate(zip(x.shape, out_shape)):
        if m == n:
            continue
        if method == "nearest":
            index = device_constant(("nearest_index", m, n), device, lambda: _nearest_index(m, n))
            runs = device_constant(("nearest_runs", m, n), device, lambda: _nearest_runs(m, n))
            x = _NearestSelect.apply(x, d, index, runs)
            continue
        w = device_constant(("resize_weights", m, n, method), device,
                    lambda: _weight_mat(m, n, method)).to(x.dtype)
        x = torch.movedim(torch.tensordot(x, w, dims=([d], [0])), -1, d)
    return x


@register("interpolate")
def interpolate(ctx, ins):
    """``interp_method`` nearest / bilinear / bicubic to ``out_h`` x
    ``out_w`` (or ``scale`` x the input), NCHW, through ``_resize``."""
    x = ins["X"][0]
    method = ctx.attr("interp_method", "nearest")
    out_h, out_w = ctx.attr("out_h", 0), ctx.attr("out_w", 0)
    scale = ctx.attr("scale", 0.0)
    n, c, h, w = x.shape
    if scale and scale > 0:
        out_h, out_w = int(h * scale), int(w * scale)
    jmethod = {"nearest": "nearest", "bilinear": "linear", "bicubic": "cubic"}[method]
    return {"Out": [_resize(x, (n, c, out_h, out_w), jmethod, ctx.device).to(x.dtype)]}


def _interp_as(method):
    def lower(ctx, ins):
        ctx.attrs = dict(ctx.attrs, interp_method=method)
        return interpolate(ctx, ins)
    return lower


register("nearest_interp")(_interp_as("nearest"))
register("bilinear_interp")(_interp_as("bilinear"))


@register("trilinear_interp")
def trilinear_interp(ctx, ins):
    """[B, C, D, H, W] to ``out_d`` x ``out_h`` x ``out_w``, linear on each
    axis (``jax.image``'s ``trilinear``)."""
    x = ins["X"][0]
    shape = tuple(x.shape[:2]) + (int(ctx.attr("out_d")), int(ctx.attr("out_h")),
                                  int(ctx.attr("out_w")))
    return {"Out": [_resize(x, shape, "linear", ctx.device).to(x.dtype)]}
