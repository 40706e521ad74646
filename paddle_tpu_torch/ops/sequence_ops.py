"""Sequence ops over padded data plus lengths (the port's copy of all 16
op types of ``paddle_tpu/ops/sequence_ops.py``).

The reference's LoD (ragged rows) is a dense padded [B, T, ...] tensor plus
a ``Length`` vector [B], which carries no gradient. Every loop and every
shape comes from the static padded T of the tensor's shape, never from a
length: nothing is read back to the host, so a captured step holds these
ops, and a length changes the values, never the work.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.registry import register, torch_dtype
from .basic import device_constant
from .ctc_crf_ops import compact_front
from .tensor_ops import _add_rows, take_axis

_NEG = -1e9


def _mask(lengths, T, dtype):
    """[B, T] of 1 where t < length, else 0, in ``dtype``."""
    ar = torch.arange(T, device=lengths.device)[None, :]
    return (ar < lengths.reshape(-1, 1)).to(dtype)


def _per_row(x, lengths):
    """``x``'s mask broadcast over its trailing dims: [B, T, 1, ...]."""
    B, T = x.shape[0], x.shape[1]
    return _mask(lengths, T, x.dtype).reshape(B, T, *([1] * (x.ndim - 2)))


def _lengths_as(x, lengths):
    """The lengths as x's dtype, at least 1, shaped [B, 1, ...] for x[:, 0]."""
    return torch.clamp_min(lengths.reshape(-1, *([1] * (x.ndim - 2))).to(x.dtype), 1)


@register("sequence_pool", nondiff_inputs=("Length",))
def sequence_pool(ctx, ins):
    """X: [B, T, D] padded; Length: [B]. pooltype: SUM / AVERAGE / SQRT /
    MAX / LAST / FIRST. MAX fills the pad with -1e9 and takes ``amax``,
    whose gradient splits evenly among tied maxima, as ``jnp.max``'s does
    (``torch.max(dim)`` would give it all to one index)."""
    x, lengths = ins["X"][0], ins["Length"][0]
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    m = _per_row(x, lengths)
    if ptype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / _lengths_as(x, lengths)
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(_lengths_as(x, lengths))
    elif ptype == "MAX":
        neg = torch.full((), _NEG, dtype=x.dtype, device=x.device)
        out = torch.amax(torch.where(m > 0, x, neg), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp_min(lengths.reshape(-1) - 1, 0).long()
        out = torch.take_along_dim(x, idx.reshape(-1, 1, *([1] * (x.ndim - 2))),
                                   dim=1).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out]}


@register("sequence_reverse", nondiff_inputs=("Length",))
def sequence_reverse(ctx, ins):
    """Each row's first ``length`` steps reversed, the pad tail in place
    (a permutation of the steps, so its gradient is the inverse one)."""
    x, lengths = ins["X"][0], ins["Length"][0]
    T = x.shape[1]
    idx = torch.arange(T, device=x.device)[None, :]
    rev = lengths.reshape(-1, 1).long() - 1 - idx
    rev = torch.where(rev >= 0, rev, idx)
    out = torch.take_along_dim(x, rev.reshape(rev.shape + (1,) * (x.ndim - 2)), dim=1)
    return {"Y": [out]}


@register("sequence_conv", nondiff_inputs=("Length",))
def sequence_conv(ctx, ins):
    """Context-window convolution over time: X [B, T, D], Filter
    [context_length * D, F]; frames outside [0, length) are zero (the
    reference's zero-padded context). The window is ``context_length``
    shifted copies of X side by side, then one product."""
    x, f = ins["X"][0], ins["Filter"][0]
    lengths = ins.get("Length", [None])[0]
    clen = int(ctx.attr("context_length", 3))
    cstart = int(ctx.attr("context_start", -((clen - 1) // 2)))
    T = x.shape[1]
    if lengths is not None:
        x = x * _mask(lengths, T, x.dtype)[:, :, None]
    cols = []
    for o in range(cstart, cstart + clen):
        if o < 0:
            cols.append(F.pad(x, (0, 0, -o, 0))[:, :T])
        elif o > 0:
            cols.append(F.pad(x, (0, 0, 0, o))[:, o:])
        else:
            cols.append(x)
    return {"Out": [torch.cat(cols, dim=2) @ f]}


@register("sequence_unpad", nondiff_inputs=("Length",))
def sequence_unpad(ctx, ins):
    """The pad tail zeroed; the result stays padded, as the JAX package's
    (a static shape cannot hold the reference's ragged rows)."""
    x, lengths = ins["X"][0], ins["Length"][0]
    return {"Out": [x * _per_row(x, lengths)]}


@register("sequence_mask", grad=None, nondiff_inputs=("X",))
def sequence_mask(ctx, ins):
    """Y [..., maxlen] = arange(maxlen) < X, in ``out_dtype``. ``maxlen``
    (or ``maxlen_hint``) must be static: the output's width cannot come
    from X's values."""
    x = ins["X"][0].reshape(-1)
    maxlen = ctx.attr("maxlen", -1)
    if maxlen is None or maxlen < 0:
        maxlen = int(ctx.attr("maxlen_hint", 0)) or None
        if maxlen is None:
            raise ValueError("sequence_mask needs a static maxlen attr")
    out = torch.arange(maxlen, device=x.device)[None, :] < x[:, None]
    return {"Y": [out.to(torch_dtype(ctx.attr("out_dtype", "int64")))]}


@register("sequence_softmax", nondiff_inputs=("Length",))
def sequence_softmax(ctx, ins):
    """A softmax over each row's first ``length`` steps of X [B, T]; 0 past
    them."""
    x, lengths = ins["X"][0], ins["Length"][0]
    m = _mask(lengths, x.shape[1], x.dtype)
    neg = torch.full((), _NEG, dtype=x.dtype, device=x.device)
    return {"Out": [torch.softmax(torch.where(m > 0, x, neg), dim=1) * m]}


def _repeat_rows(x, ref):
    """Row i of x ``ref[i]`` times (static counts): a constant index on the
    device and a gather whose gradient adds in a fixed order."""
    idx = device_constant(("repeat_rows", tuple(int(v) for v in ref)), x.device,
                          lambda: torch.from_numpy(np.repeat(np.arange(len(ref)), ref)
                                                   .astype(np.int64)))
    return take_axis(x, idx, 0)


@register("sequence_expand", nondiff_inputs=("Length",))
def sequence_expand(ctx, ins):
    """Row i of X repeated ``ref_lengths[i]`` times, or every row
    ``expand_times`` times. The counts must be static, as in the JAX
    package: a Length tensor alone cannot set the output's row count."""
    x = ins["X"][0]
    ref = ctx.attr("ref_lengths", None)
    times = ctx.attr("expand_times", None)
    if ref is not None:
        return {"Out": [_repeat_rows(x, ref)]}
    if times is not None:
        return {"Out": [_repeat_rows(x, [int(times)] * x.shape[0])]}
    raise NotImplementedError(
        "sequence_expand needs static expansion counts: pass attr 'ref_lengths' "
        "(per-row repeat counts) or 'expand_times' (uniform); a Length tensor "
        "cannot set the output's shape")


@register("sequence_expand_as", nondiff_inputs=("Y",))
def sequence_expand_as(ctx, ins):
    """Row-wise repeats to Y's rows; the counts must be static (attr
    ``ref_lengths``), as for ``sequence_expand``."""
    ref = ctx.attr("ref_lengths", None)
    if ref is None:
        raise NotImplementedError(
            "sequence_expand_as needs static per-row counts: pass attr 'ref_lengths' "
            "(a Y tensor cannot set the output's shape)")
    return {"Out": [_repeat_rows(ins["X"][0], ref)]}


@register("sequence_concat")
def sequence_concat(ctx, ins):
    """The inputs side by side on the last axis."""
    return {"Out": [torch.cat([x for x in ins["X"] if x is not None], dim=-1)]}


@register("sequence_pad", nondiff_inputs=("Length", "PadValue"))
def sequence_pad(ctx, ins):
    """Positions past each row's length set to the pad value (the PadValue
    input, or the ``pad_value`` attr); Length is passed through."""
    x, lengths = ins["X"][0], ins["Length"][0]
    pv = ins.get("PadValue", [None])[0]
    v = (pv.reshape(()).to(x.dtype) if pv is not None
         else torch.full((), float(ctx.attr("pad_value", 0.0)), dtype=x.dtype, device=x.device))
    return {"Out": [torch.where(_per_row(x, lengths) > 0, x, v)], "Length": [lengths]}


def _seq_slice_infer(op, block):
    """Out is [X's batch, out_len, X's rest] (the Offset's concrete batch
    beside X's dynamic one would part the two inference runs)."""
    xv = block.find_var_recursive(op.inputs["X"][0])
    shape = (xv.shape[0], op.attr("out_len")) + tuple(xv.shape[2:])
    out = op.outputs["Out"][0]
    v = block.find_var_recursive(out)
    if v is None:
        block.create_var(out, shape, xv.dtype)
    else:
        v.shape = shape


@register("sequence_slice", nondiff_inputs=("Offset", "Length"), infer_shape=_seq_slice_infer)
def sequence_slice(ctx, ins):
    """x[b, offset[b] : offset[b] + out_len] for each row: the offsets are
    values, the slice length a static attr. The indices of a row are
    distinct, so the gradient adds each cotangent once."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1).long()
    out_len = int(ctx.attr("out_len"))
    idx = off[:, None] + torch.arange(out_len, device=x.device)[None, :]
    return {"Out": [torch.take_along_dim(x, idx.reshape(idx.shape + (1,) * (x.ndim - 2)),
                                         dim=1)]}


@register("sequence_enumerate", grad=None, nondiff_inputs=("X", "Length"))
def sequence_enumerate(ctx, ins):
    """Sliding windows of ids: X [B, T] -> Out [B, T, win_size], the
    positions at or past the row's length ``pad_value``."""
    x = ins["X"][0]
    lengths = ins.get("Length", [None])[0]
    win = int(ctx.attr("win_size"))
    pad = int(ctx.attr("pad_value", 0))
    B, T = x.shape
    padded = F.pad(x, (0, win - 1), value=pad)
    out = torch.stack([padded[:, k:k + T] for k in range(win)], dim=2)
    pos = (torch.arange(T, device=x.device)[None, :, None]
           + torch.arange(win, device=x.device)[None, None, :])
    lim = lengths.reshape(-1, 1, 1) if lengths is not None else T
    return {"Out": [torch.where(pos < lim, out, torch.full((), pad, dtype=x.dtype,
                                                           device=x.device))]}


@register("sequence_erase", grad=None, nondiff_inputs=("X", "Length"))
def sequence_erase(ctx, ins):
    """The ``tokens`` removed and the rest moved to the front in order: Out
    [B, T] (0 past each row's new length), OutLength [B] int64."""
    x = ins["X"][0]
    lengths = ins.get("Length", [None])[0]
    B, T = x.shape
    keep = (torch.arange(T, device=x.device)[None, :] < lengths.reshape(-1, 1)
            if lengths is not None else torch.ones((B, T), dtype=torch.bool, device=x.device))
    for t in ctx.attr("tokens", []):
        keep = keep & (x != t)
    out, n = compact_front(x, keep, 0)
    return {"Out": [out], "OutLength": [n.to(torch.int64)]}


@register("sequence_reshape")
def sequence_reshape(ctx, ins):
    x = ins["X"][0]
    return {"Out": [x.reshape(x.shape[0], -1, int(ctx.attr("new_dim")))]}


@register("sequence_scatter", nondiff_inputs=("Ids",))
def sequence_scatter(ctx, ins):
    """x[b, ids[b, k]] += updates[b, k], repeats added in a fixed order."""
    x, ids, upd = ins["X"][0], ins["Ids"][0].long(), ins["Updates"][0]
    B, T = x.shape[0], x.shape[1]
    row = (torch.arange(B, device=x.device)[:, None] * T + ids).reshape(-1)
    flat = x.reshape((B * T,) + tuple(x.shape[2:]))
    return {"Out": [_add_rows(flat, row, upd).reshape(x.shape)]}


@register("im2sequence")
def im2sequence(ctx, ins):
    """Each ``kernels`` window (no padding, ``strides``) of X [N, C, H, W]
    as one step: Out [N, OH * OW, C * kh * kw], the features ordered (c,
    kh, kw) as ``lax.conv_general_dilated_patches`` orders them, which is
    ``F.unfold``'s order."""
    x = ins["X"][0]
    kh, kw = ctx.attr("kernels", [1, 1])
    sh, sw = ctx.attr("strides", [1, 1])
    cols = F.unfold(x, (int(kh), int(kw)), stride=(int(sh), int(sw)))
    return {"Out": [cols.transpose(1, 2)]}
