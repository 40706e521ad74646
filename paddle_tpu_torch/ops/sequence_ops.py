"""Sequence ops over padded data plus lengths (the port's copy of
``sequence_pool``, ``sequence_reverse``, ``sequence_conv`` and
``sequence_unpad`` from ``paddle_tpu/ops/sequence_ops.py``).

The reference's LoD (ragged rows) is a dense padded [B, T, ...] tensor plus
a ``Length`` vector [B], which carries no gradient. Every loop and every
shape comes from the static padded T of the tensor's shape, never from a
length: nothing is read back to the host, so a captured step holds these
ops, and a length changes the values, never the work.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import register

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
