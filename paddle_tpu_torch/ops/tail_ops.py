"""The operator-library tail (the port's copy of the 22 op types of
``paddle_tpu/ops/tail_ops.py``; its three aliases ``sync_batch_norm``,
``multiclass_nms2`` and ``generate_mask_labels`` came with the vision and
detection slices): activations and losses, tensor utilities, the fused
``fc`` op, ``cvm``, ``conv_shift``, max pooling with indices and
``unpool``, ``spp``, ``depthwise_conv2d_transpose``, ``proximal_adagrad``,
deformable convolution and ``similarity_focus``.

Bilinear sampling (``deformable_conv``) takes its pixels through
``extra_ops.gather_pixels``, whose gradient adds rows in a fixed order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import LowerCtx, register, simple_op, torch_dtype
from .basic import device_constant
from .extra_ops import gather_pixels
from .nn_ops import conv2d_transpose


# -- activations / losses ----------------------------------------------------

@simple_op("selu")
def selu(ctx, x):
    """scale * (x > 0 ? x : alpha * (exp(x) - 1))."""
    scale = ctx.attr("scale", 1.0507009873554805)
    alpha = ctx.attr("alpha", 1.6732632423543772)
    return scale * torch.where(x > 0, x, alpha * (torch.exp(x) - 1.0))


@register("hinge_loss")
def hinge_loss(ctx, ins):
    """max(1 - pred * (2 label - 1), 0)."""
    pred, label = ins["Logits"][0], ins["Labels"][0]
    return {"Loss": [torch.clamp_min(1.0 - pred * (2.0 * label.to(pred.dtype) - 1.0), 0.0)]}


@register("modified_huber_loss")
def modified_huber_loss(ctx, ins):
    """Over z = pred * (2y - 1): max(0, 1 - z)^2 for z >= -1, else -4z;
    IntermediateVal is z (no gradient)."""
    pred, label = ins["X"][0], ins["Y"][0]
    z = pred * (2.0 * label.to(pred.dtype) - 1.0)
    loss = torch.where(z >= -1.0, torch.square(torch.clamp_min(1.0 - z, 0.0)), -4.0 * z)
    return {"Out": [loss], "IntermediateVal": [z.detach()]}


@register("squared_l2_distance")
def squared_l2_distance(ctx, ins):
    """Per-row sum of squared differences (Y may be one row, broadcast);
    sub_result is X - Y (no gradient)."""
    sub = ins["X"][0] - ins["Y"][0]
    return {"Out": [torch.sum(torch.square(sub), dim=-1, keepdim=True)],
            "sub_result": [sub.detach()]}


@simple_op("l1_norm")
def l1_norm(ctx, x):
    """The sum of absolute values, [1]."""
    return torch.sum(torch.abs(x)).reshape(1)


# -- elementwise / tensor utilities ------------------------------------------

@register("minus")
def minus(ctx, ins):
    return {"Out": [ins["X"][0] - ins["Y"][0]]}


@register("norm")
def norm(ctx, ins):
    """X l2-normalised along ``axis``; Norm = sqrt(sum(x^2) + epsilon) (no
    gradient)."""
    x = ins["X"][0]
    n = torch.sqrt(torch.sum(torch.square(x), dim=ctx.attr("axis", 1), keepdim=True)
                   + ctx.attr("epsilon", 1e-10))
    return {"Out": [x / n], "Norm": [n.detach()]}


@register("size", grad=None)
def size(ctx, ins):
    """The number of elements, int32 [1] (the JAX package's integer width
    with x64 off)."""
    return {"Out": [torch.full((1,), int(np.prod(ins["Input"][0].shape)), dtype=torch.int32,
                               device=ctx.device)]}


@register("fill", grad=None)
def fill(ctx, ins):
    """attr ``value`` (a flat list) as a tensor of attr ``shape`` and
    ``dtype``, through float64 as the JAX lowering converts it; on the card
    uploaded once, outside any capture."""
    shape = [int(s) for s in ctx.attr("shape", [])]
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    vals = tuple(float(v) for v in ctx.attr("value", []))
    return {"Out": [device_constant(("fill", vals, tuple(shape), dtype), ctx.device,
                                    lambda: torch.tensor(vals, dtype=torch.float64)
                                    .reshape(shape).to(dtype))]}


@register("fill_zeros_like2", grad=None)
def fill_zeros_like2(ctx, ins):
    """Zeros of X's shape in attr ``dtype`` (X's when none)."""
    x = ins["X"][0]
    dt = ctx.attr("dtype", None)
    return {"Out": [torch.zeros(x.shape, dtype=torch_dtype(dt) if dt is not None else x.dtype,
                                device=x.device)]}


@register("crop")
def crop(ctx, ins):
    """A static crop at ``offsets`` to ``shape`` (or Y's shape)."""
    x = ins["X"][0]
    y = ins.get("Y", [None])[0]
    shape = list(y.shape) if y is not None else list(ctx.attr("shape", []))
    offsets = list(ctx.attr("offsets", []) or [0] * x.ndim)
    out = x
    for axis, (o, s) in enumerate(zip(offsets, shape)):
        out = out.narrow(axis, int(o), int(s))
    return {"Out": [out]}


@register("fc")
def fc(ctx, ins):
    """The fused inference fc op: Input flattened at ``in_num_col_dims``,
    times W, plus the optional Bias."""
    x, w = ins["Input"][0], ins["W"][0]
    ncol = ctx.attr("in_num_col_dims", 1)
    out = x.reshape(int(np.prod(x.shape[:ncol])), -1) @ w
    b = ins.get("Bias", [None])[0]
    if b is not None:
        out = out + b.reshape(1, -1)
    return {"Out": [out.reshape(tuple(x.shape[:ncol]) + (w.shape[1],))]}


@register("cvm")
def cvm(ctx, ins):
    """Rows [show, click, features...]: with ``use_cvm`` Y[0] = log(show +
    1), Y[1] = log(click + 1) - log(show + 1); without, the two columns
    dropped."""
    x = ins["X"][0]
    if ctx.attr("use_cvm", True):
        show = torch.log(x[:, :1] + 1.0)
        return {"Y": [torch.cat([show, torch.log(x[:, 1:2] + 1.0) - show, x[:, 2:]], dim=1)]}
    return {"Y": [x[:, 2:]]}


@register("conv_shift")
def conv_shift(ctx, ins):
    """Circular convolution: out[b, i] = sum_j x[b, (i + j - (M-1)//2) mod N]
    * y[b, j]."""
    x, y = ins["X"][0], ins["Y"][0]
    m = y.shape[1]
    half = (m - 1) // 2
    out = torch.roll(x, -(0 - half), dims=1) * y[:, 0:1]
    for j in range(1, m):
        out = out + torch.roll(x, -(j - half), dims=1) * y[:, j:j + 1]
    return {"Out": [out]}


# -- pooling tail ------------------------------------------------------------

@register("max_pool2d_with_index", nondiff_outputs=("Mask",))
def max_pool2d_with_index(ctx, ins):
    """Max pooling over non-overlapping windows (stride == ksize, no
    padding, divisible maps; anything else raises, as in the JAX package)
    and Mask, the flat index of each window's first maximum in its map."""
    x = ins["X"][0]
    k = ctx.attr("ksize", [2, 2])
    s = ctx.attr("strides", k) or k
    p = ctx.attr("paddings", [0, 0]) or [0, 0]
    n, c, h, w = x.shape
    kh, kw = int(k[0]), int(k[1])
    if list(k) != list(s) or any(p) or h % kh or w % kw:
        raise NotImplementedError(
            "max_pool2d_with_index: non-overlapping unpadded windows over divisible maps "
            "only (stride == ksize, H % kh == W % kw == 0); use pool2d for plain max pooling")
    xb = x.reshape(n, c, h // kh, kh, w // kw, kw).permute(0, 1, 2, 4, 3, 5) \
        .reshape(n, c, h // kh, w // kw, kh * kw)
    out = torch.amax(xb, dim=-1)
    win = torch.argmax(xb, dim=-1)
    rows = torch.arange(h // kh, device=x.device)[:, None] * kh + win // kw
    cols = torch.arange(w // kw, device=x.device)[None, :] * kw + win % kw
    return {"Out": [out], "Mask": [(rows * w + cols).to(torch.int32)]}


@register("unpool", nondiff_inputs=("Indices",))
def unpool(ctx, ins):
    """X's values put back at the flat indices ``max_pool2d_with_index``
    recorded (zeros elsewhere), in an ``unpool_size`` map (default (in - 1)
    * stride + ksize)."""
    x, idx = ins["X"][0], ins["Indices"][0]
    n, c, h, w = x.shape
    out_size = ctx.attr("unpool_size", None) or ctx.attr("output_size", None)
    if out_size is None:
        k = ctx.attr("ksize", [2, 2])
        st = ctx.attr("strides", k) or k
        out_size = [(h - 1) * int(st[0]) + int(k[0]), (w - 1) * int(st[1]) + int(k[1])]
    hs, ws = int(out_size[0]), int(out_size[1])
    flat = torch.zeros((n, c, hs * ws), dtype=x.dtype, device=x.device)
    flat = flat.scatter(2, idx.reshape(n, c, -1).long(), x.reshape(n, c, -1))
    return {"Out": [flat.reshape(n, c, hs, ws)]}


@register("spp")
def spp(ctx, ins):
    """Spatial pyramid pooling: level l pools to 2^l x 2^l bins, windows of
    ceil(size / bins) clipped to the map (``avg`` over the valid cells)."""
    x = ins["X"][0]
    height = ctx.attr("pyramid_height", 1)
    ptype = ctx.attr("pooling_type", "max")
    n, c, h, w = x.shape
    pieces = []
    for level in range(height):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        for i in range(bins):
            h0 = min(max(0, i * kh - ph), h - 1)
            h1 = max(h0 + 1, min(h, i * kh - ph + kh))
            for j in range(bins):
                w0 = min(max(0, j * kw - pw), w - 1)
                w1 = max(w0 + 1, min(w, j * kw - pw + kw))
                cell = x[:, :, h0:h1, w0:w1]
                red = (torch.amax(cell, dim=(2, 3)) if ptype == "max"
                       else torch.mean(cell, dim=(2, 3)))
                pieces.append(red.reshape(n, c, 1))
    return {"Out": [torch.cat(pieces, dim=2).reshape(n, -1)]}


# -- conv tail ---------------------------------------------------------------

@register("depthwise_conv2d_transpose")
def depthwise_conv2d_transpose(ctx, ins):
    """``conv2d_transpose`` with one group a channel, on a copy of the
    context (the op's attrs stay as they are)."""
    sub = LowerCtx({**ctx.attrs, "groups": int(ins["Input"][0].shape[1])}, ctx.device,
                   ctx.seed, ctx.counter, ctx._salt, ctx.abstract, ctx.graphs,
                   ctx.counter_t, ctx.block_runner)
    return conv2d_transpose(sub, ins)


# -- optimizer tail ----------------------------------------------------------

@register("proximal_adagrad", grad=None)
def proximal_adagrad(ctx, ins):
    """m_out = m + g^2; prox = p - lr g / sqrt(m_out); then the l1
    threshold and the l2 denominator with the raw scalar lr."""
    p, g, m = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    lr = ins["LearningRate"][0].reshape(())
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    m_out = m + g * g
    prox = p - lr * g / torch.sqrt(m_out)
    if l1 > 0.0:
        p_out = torch.sign(prox) * torch.clamp_min(torch.abs(prox) - lr * l1, 0.0) / (1.0 + lr * l2)
    else:
        p_out = prox / (1.0 + lr * l2)
    return {"ParamOut": [p_out.to(p.dtype)], "MomentOut": [m_out]}


# -- deformable convolution ---------------------------------------------------

def _bilinear_sample_nchw(x, py, px):
    """x [N, C, H, W] sampled bilinearly at float coordinates py / px [N,
    S]; a corner outside the map adds zero. [N, C, S]."""
    n, c, h, w = x.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    wy, wx = py - y0, px - x0
    out = 0.0
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        yy, xx = y0 + dy, x0 + dx
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        idx = torch.clamp(yy, 0, h - 1).long() * w + torch.clamp(xx, 0, w - 1).long()
        wgt = (wy if dy else 1.0 - wy) * (wx if dx else 1.0 - wx) * valid.to(x.dtype)
        out = out + gather_pixels(x, idx) * wgt[:, None, :]
    return out


@register("deformable_conv")
def deformable_conv(ctx, ins):
    """Modulated deformable convolution (v2): kernel tap k samples the input
    at p0 + p_k + Offset[n, 2k:2k+2, p0] bilinearly, scaled by Mask, then
    the taps contract with the filter (float32)."""
    x, off, w = ins["Input"][0], ins["Offset"][0], ins["Filter"][0]
    mask = ins.get("Mask", [None])[0]
    strides = ctx.attr("strides", [1, 1]) or [1, 1]
    pads = ctx.attr("paddings", [0, 0]) or [0, 0]
    dil = ctx.attr("dilations", [1, 1]) or [1, 1]
    groups = int(ctx.attr("groups", 1) or 1)
    dg = int(ctx.attr("deformable_groups", 1) or 1)
    n, cin, h, wd = x.shape
    cout, _, kh, kw = w.shape
    ho = (h + 2 * pads[0] - (dil[0] * (kh - 1) + 1)) // strides[0] + 1
    wo = (wd + 2 * pads[1] - (dil[1] * (kw - 1) + 1)) // strides[1] + 1
    K = kh * kw
    base_y = (torch.arange(ho, device=x.device, dtype=torch.float32)[:, None]
              * strides[0] - pads[0]).expand(ho, wo)
    base_x = (torch.arange(wo, device=x.device, dtype=torch.float32)[None, :]
              * strides[1] - pads[1]).expand(ho, wo)
    off = off.reshape(n, dg, K, 2, ho, wo).float()
    cg = cin // dg
    cols = []
    for g in range(dg):
        xg = x[:, g * cg:(g + 1) * cg]
        taps = []
        for ki in range(kh):
            for kj in range(kw):
                k = ki * kw + kj
                py = base_y[None] + ki * dil[0] + off[:, g, k, 0]
                px = base_x[None] + kj * dil[1] + off[:, g, k, 1]
                s = _bilinear_sample_nchw(xg, py.reshape(n, -1), px.reshape(n, -1))
                if mask is not None:
                    m = mask.reshape(n, dg, K, ho, wo)[:, g, k]
                    s = s * m.reshape(n, 1, -1).to(s.dtype)
                taps.append(s)                                 # [N, cg, Ho*Wo]
        cols.append(torch.stack(taps, dim=2))                  # [N, cg, K, S]
    col = torch.cat(cols, dim=1)                               # [N, Cin, K, S]
    out = torch.einsum("ngcks,gock->ngos",
                       col.reshape(n, groups, cin // groups, K, ho * wo),
                       w.reshape(groups, cout // groups, cin // groups, K))
    return {"Output": [out.reshape(n, cout, ho, wo).to(x.dtype)]}


@register("deformable_conv_v1")
def deformable_conv_v1(ctx, ins):
    """The unmodulated form (no Mask)."""
    ins = dict(ins)
    ins.pop("Mask", None)
    return deformable_conv(ctx, ins)


# -- similarity focus ---------------------------------------------------------

@register("similarity_focus", grad=None)
def similarity_focus(ctx, ins):
    """For each batch and each index in ``indexes`` along ``axis``: walk the
    2-D slice's cells in descending value order (ties by cell index, a
    stable sort) and pick each cell whose row and column are both unused;
    the mask is 1 at picked cells, broadcast over the axis dim and OR-ed
    across the indexes. The walk is a Python loop over the R x C cells of
    the static shape, the whole batch at a time."""
    x = ins["X"][0]
    axis = int(ctx.attr("axis", 1))
    indexes = list(ctx.attr("indexes", []))
    if x.ndim != 4 or axis not in (1, 2, 3):
        raise ValueError("similarity_focus: X must be 4-D with axis in {1,2,3} "
                         "(reference contract)")
    if not indexes:
        raise ValueError("similarity_focus: Indexes' size can not be 0")
    perm = [0, axis] + [d for d in (1, 2, 3) if d != axis]
    xp = x.permute(perm)
    B, A, R, C = xp.shape
    dev = x.device
    bidx = torch.arange(B, device=dev)
    mask = torch.zeros((B, R * C), dtype=torch.bool, device=dev)
    for index in indexes:
        if not 0 <= index < A:
            raise ValueError("similarity_focus: Index exceeds tensor shape limit")
        order = torch.sort(-xp[:, index].reshape(B, -1), dim=1, stable=True)[1]
        rows = torch.zeros((B, R), dtype=torch.bool, device=dev)
        cols = torch.zeros((B, C), dtype=torch.bool, device=dev)
        pick = torch.zeros((B, R * C), dtype=torch.bool, device=dev)
        for step in range(R * C):
            idx = order[:, step]
            r, c = idx // C, idx % C
            free = ~rows[bidx, r] & ~cols[bidx, c]
            rows = rows.index_put((bidx, r), free | rows[bidx, r])
            cols = cols.index_put((bidx, c), free | cols[bidx, c])
            pick = pick.index_put((bidx, idx), free)
        mask = mask | pick
    out = mask.reshape(B, 1, R, C).expand(B, A, R, C)
    inv = [perm.index(d) for d in range(4)]
    return {"Out": [out.permute(inv).to(x.dtype)]}
