"""Tensor-manipulation ops (the port's copy of part of
``paddle_tpu/ops/tensor_ops.py``): reshape2, transpose2, unsqueeze2, split,
slice, gather, top_k and the lookup_table_v2 embedding.

``gather`` and ``lookup_table_v2`` read rows by index. On the card their
gradient sums the cotangents of repeated indices in a fixed order
(``RowGather``), so a training step reproduces bit for bit, as the JAX
package's does; PyTorch's own gradients of ``index_select`` and
``F.embedding`` add them with atomics. On the CPU they keep PyTorch's
gradients, which sum in index order.
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


#: a table with at most 1/DENSE_RATIO as many rows as indices (each row
#: read ~DENSE_RATIO times or more, as BERT's two sentence embeddings are
#: by 16384 tokens) sums its gradient as one matmul: the sorted accumulation
#: walks each row's repeats in sequence, 5.6 ms for that table on an H100
#: (chip_smoke.py's row_grads phase)
DENSE_RATIO = 64


class RowGather(torch.autograd.Function):
    """``x.index_select(0, idx)`` whose gradient sums the cotangents of each
    row in an order that does not change from run to run
    (``index_select``'s own gradient, ``index_add_``, adds them with
    atomics on the card): ``index_put_(accumulate=True)``, PyTorch's
    sort-based accumulation, or for a table of few rows read many times
    the product of the one-hot matrix of ``idx`` with the cotangents."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        rows = ctx.shape[0]
        if rows * DENSE_RATIO <= idx.numel():
            onehot = idx == torch.arange(rows, device=idx.device).unsqueeze(1)
            gx = torch.matmul(onehot.to(g.dtype), g.reshape(idx.numel(), -1))
            return gx.reshape(ctx.shape), None
        gx = g.new_zeros(ctx.shape)
        gx.index_put_((idx,), g, accumulate=True)
        return gx, None


def take_rows(x, idx):
    """Rows ``idx`` (1-D int64) of ``x``: on the card through ``RowGather``
    when a gradient is asked for, else ``index_select``."""
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        return RowGather.apply(x, idx)
    return x.index_select(0, idx)


@register("lookup_table_v2", nondiff_inputs=("Ids",))
def lookup_table_v2(ctx, ins):
    """Embedding lookup; padding_idx rows produce zeros. Ids stay int64 for
    ``F.embedding`` (the JAX package computes them as int32 with x64 off:
    the values are the same)."""
    w, ids = ins["W"][0], ins["Ids"][0]
    if ids.ndim > 1 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    ids = ids.long()
    if w.is_cuda:
        out = take_rows(w, ids.reshape(-1)).reshape(tuple(ids.shape) + tuple(w.shape[1:]))
    else:
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
    if x.is_cuda:
        out = take_rows(x.movedim(axis, 0), idx.reshape(-1).long()).movedim(0, axis)
    else:
        out = x.index_select(axis, idx.reshape(-1).long())
    return {"Out": [out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                                + tuple(x.shape[axis + 1:]))]}


@register("top_k", nondiff_outputs=("Indices",))
def top_k(ctx, ins):
    vals, idx = torch.topk(ins["X"][0], ctx.attr("k", 1), dim=-1)
    return {"Out": [vals], "Indices": [idx]}
