"""Tensor-manipulation ops (the port's copy of part of
``paddle_tpu/ops/tensor_ops.py``): reshape2, transpose2, unsqueeze2, split,
slice, gather, top_k and the lookup_table_v2 embedding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register


def _resolve_shape(shape, x):
    """Fluid reshape semantics: 0 copies the input dim, one -1 is inferred."""
    out = [x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape)]
    if -1 in out:
        known = math.prod(s for s in out if s != -1) or 1
        out[out.index(-1)] = x.numel() // known
    return tuple(out)


@register("reshape2")
def reshape2(ctx, ins):
    x = ins["X"][0]
    return {"Out": [x.reshape(_resolve_shape(ctx.attr("shape", []), x))]}


@register("transpose2")
def transpose2(ctx, ins):
    return {"Out": [ins["X"][0].permute(*ctx.attr("axis"))]}


@register("unsqueeze2")
def unsqueeze2(ctx, ins):
    x = ins["X"][0]
    for a in sorted(ctx.attr("axes", [])):
        x = x.unsqueeze(a)
    return {"Out": [x]}


@register("split")
def split(ctx, ins):
    x = ins["X"][0]
    axis = ctx.attr("axis", 0)
    sections = ctx.attr("sections", [])
    if not sections:
        num = ctx.attr("num", 0)
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of size {x.shape[axis]} does not "
                             f"divide into {num} equal parts")
        sections = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, list(sections), dim=axis))}


@register("lookup_table_v2", nondiff_inputs=("Ids",))
def lookup_table_v2(ctx, ins):
    """Embedding lookup; padding_idx rows produce zeros. Ids stay int64 for
    ``F.embedding`` (the JAX package computes them as int32 with x64 off:
    the values are the same)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long()
    out = F.embedding(ids, w)
    pad = ctx.attr("padding_idx", -1)
    if pad is not None and pad >= 0:
        out = out * (ids != pad).unsqueeze(-1).to(out.dtype)
    return {"Out": [out]}


@register("slice")
def slice_op(ctx, ins):
    x = ins["Input"][0]
    sl = [slice(None)] * x.ndim
    for a, s, e in zip(ctx.attr("axes", []), ctx.attr("starts", []), ctx.attr("ends", [])):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        sl[a] = slice(s, e)
    return {"Out": [x[tuple(sl)]]}


@register("gather", nondiff_inputs=("Index",))
def gather(ctx, ins):
    """``jnp.take`` along ``axis``: the output dims are x's with ``axis``
    replaced by Index's shape."""
    x, idx = ins["X"][0], ins["Index"][0]
    axis = ctx.attr("axis", 0) % x.ndim
    out = x.index_select(axis, idx.reshape(-1).long())
    return {"Out": [out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                                + tuple(x.shape[axis + 1:]))]}


@register("top_k", nondiff_outputs=("Indices",))
def top_k(ctx, ins):
    vals, idx = torch.topk(ins["X"][0], ctx.attr("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx]}
