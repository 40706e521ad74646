"""Tensor-manipulation ops (the port's copy of ``paddle_tpu/ops/tensor_ops.py``,
all 46 types): reshapes, transposes, squeezes, concat / split / stack, the
slices, the gathers and scatters, the embeddings, tiles, pads, flips and
rolls, the index choosers (``top_k``, ``arg_max``, ``arg_min``,
``argsort``), ``diag``, ``eye``, ``meshgrid`` and ``shard_index``. The v1
types (``reshape``, ``transpose``, ``flatten``, ``squeeze``, ``unsqueeze``)
share the v2 lowerings; neither fills ``XShape`` (the JAX package leaves
it None).

Where an index is chosen among equal values it is JAX's: ``top_k`` and
``argsort`` by a stable sort (the lower index first; ``argsort``
descending sorts ``-x``, as the JAX lowering), ``arg_max`` / ``arg_min``
the first index.

The ops that read rows by index (``gather``, ``index_select``,
``lookup_table``, ``lookup_table_v2``, ``embedding_bag``, ``gather_nd``,
``pad2d``'s reflect and edge modes) sum their gradient's repeated rows in
a fixed order on the card (``RowGather``), and the ops that add into rows
(``scatter`` with ``overwrite=False``, ``scatter_nd_add``) add with
``index_put_(accumulate=True)``: a training step reproduces bit for bit,
as the JAX package's does, where PyTorch's ``index_select`` /
``F.embedding`` gradients and ``index_add_`` add with atomics. On the CPU
they keep PyTorch's gradients, which sum in index order.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register, torch_dtype


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


register("reshape")(reshape2)


def _flatten(ctx, ins):
    """X as 2-D: the dims before ``axis``, then the rest."""
    x = ins["X"][0]
    axis = ctx.attr("axis", 1)
    return {"Out": [x.reshape(math.prod(x.shape[:axis]) if axis > 0 else 1, -1)]}


register("flatten")(_flatten)
register("flatten2")(_flatten)


@register("squeeze2")
def squeeze2(ctx, ins):
    """Drop the listed axes of size 1 (all size-1 axes when none are
    listed); an axis whose size is not 1 stays, as in the JAX lowering."""
    x = ins["X"][0]
    axes = ctx.attr("axes", [])
    if not axes:
        return {"Out": [x.squeeze()]}
    axes = sorted({a % x.ndim for a in axes if x.shape[a % x.ndim] == 1}, reverse=True)
    for a in axes:
        x = x.squeeze(a)
    return {"Out": [x]}


register("squeeze")(squeeze2)


def _tile(x, times):
    """``jnp.tile``: fewer times than dims repeat the trailing dims; more
    give x leading dims of 1."""
    times = [int(t) for t in times]
    return x.repeat(*([1] * (x.ndim - len(times)) + times))


@register("expand")
def expand(ctx, ins):
    """``jnp.tile`` with ``expand_times``."""
    return {"Out": [_tile(ins["X"][0], ctx.attr("expand_times", []))]}


@register("expand_as")
def expand_as(ctx, ins):
    """X tiled to target_tensor's shape (each of its dims a multiple of X's)."""
    x, target = ins["X"][0], ins["target_tensor"][0]
    return {"Out": [_tile(x, [t // s for t, s in zip(target.shape, x.shape)])]}


@register("tile")
def tile(ctx, ins):
    return {"Out": [_tile(ins["X"][0], ctx.attr("repeat_times", []))]}


@register("label_smooth", nondiff_inputs=("PriorDist",))
def label_smooth(ctx, ins):
    """(1 - eps) * X + eps * PriorDist, or + eps / K over the K classes of
    X's last dim when there is no prior."""
    x = ins["X"][0]
    eps = ctx.attr("epsilon", 0.0)
    prior = ins.get("PriorDist", [None])
    if prior and prior[0] is not None:
        return {"Out": [(1 - eps) * x + eps * prior[0]]}
    return {"Out": [(1 - eps) * x + eps / x.shape[-1]]}


@register("transpose2")
def transpose2(ctx, ins):
    return {"Out": [ins["X"][0].permute(*ctx.attr("axis"))]}


register("transpose")(transpose2)


@register("unsqueeze2")
def unsqueeze2(ctx, ins):
    x = ins["X"][0]
    for a in sorted(ctx.attr("axes", [])):
        x = x.unsqueeze(a)
    return {"Out": [x]}


register("unsqueeze")(unsqueeze2)


@register("concat")
def concat(ctx, ins):
    xs = [x for x in ins["X"] if x is not None]
    return {"Out": [torch.cat(xs, dim=ctx.attr("axis", 0))]}


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


@register("stack")
def stack(ctx, ins):
    return {"Y": [torch.stack([x for x in ins["X"] if x is not None],
                              dim=ctx.attr("axis", 0))]}


@register("unstack")
def unstack(ctx, ins):
    return {"Y": list(torch.unbind(ins["X"][0], dim=ctx.attr("axis", 0)))}


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


def take_axis(x, idx, axis):
    """``jnp.take(x, idx, axis)`` for a 1-D int64 ``idx``: on the card
    through ``take_rows`` (a gradient in a fixed order), else
    ``index_select``."""
    if x.is_cuda:
        return take_rows(x.movedim(axis, 0), idx).movedim(0, axis)
    return x.index_select(axis, idx)


def _take(x, idx, axis):
    """``jnp.take``: ``axis`` of x replaced by idx's dims."""
    axis %= x.ndim
    out = take_axis(x, idx.reshape(-1).long(), axis)
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape) + tuple(x.shape[axis + 1:]))


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


register("lookup_table", nondiff_inputs=("Ids",))(lookup_table_v2)


@register("embedding_bag", nondiff_inputs=("Ids",))
def embedding_bag(ctx, ins):
    """Rows ``Ids`` [B, L] of W, summed (``mode`` "sum") or averaged over L."""
    w, ids = ins["W"][0], ins["Ids"][0]
    rows = _take(w, ids, 0)
    return {"Out": [rows.sum(dim=1) if ctx.attr("mode", "sum") == "sum" else rows.mean(dim=1)]}


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
    return {"Out": [_take(ins["X"][0], ins["Index"][0], ctx.attr("axis", 0))]}


@register("index_select", nondiff_inputs=("Index",))
def index_select(ctx, ins):
    return {"Out": [_take(ins["X"][0], ins["Index"][0], ctx.attr("dim", 0))]}


def _rows_nd(x, idx):
    """(x as [rows, rest], the row of each index tuple in ``idx``'s last
    dim, flattened): the first ``nd`` dims of x folded into one, negative
    indices counted from the end as JAX's."""
    nd = idx.shape[-1]
    lead = tuple(x.shape[:nd])
    idx = idx.long().reshape(-1, nd)
    row = torch.zeros(idx.shape[:1], dtype=torch.int64, device=idx.device)
    for i, d in enumerate(lead):
        row = row * d + torch.remainder(idx[:, i], d)
    return x.reshape((math.prod(lead),) + tuple(x.shape[nd:])), row


@register("gather_nd", nondiff_inputs=("Index",))
def gather_nd(ctx, ins):
    """x at the index tuples of Index's last dim: [*Index.shape[:-1],
    *x.shape[nd:]]."""
    x, idx = ins["X"][0], ins["Index"][0]
    flat, row = _rows_nd(x, idx)
    return {"Out": [take_axis(flat, row, 0).reshape(tuple(idx.shape[:-1])
                                                   + tuple(x.shape[idx.shape[-1]:]))]}


def _add_rows(x, row, updates):
    """x with ``updates`` added at rows ``row``, repeats in a fixed order
    (``index_put_``'s sort-based accumulation; ``index_add_`` adds with
    atomics on the card)."""
    return x.index_put((row,), updates.reshape((row.numel(),) + tuple(x.shape[1:])),
                       accumulate=True)


@register("scatter", nondiff_inputs=("Ids",))
def scatter(ctx, ins):
    """Rows ``Ids`` of X set to (``overwrite``) or added by Updates. With
    ``overwrite`` and a repeated id which update lands is undefined, in
    both packages (``x.at[ids].set``)."""
    x, ids, updates = ins["X"][0], ins["Ids"][0], ins["Updates"][0]
    ids = ids.reshape(-1).long()
    if ctx.attr("overwrite", True):
        return {"Out": [x.index_copy(0, ids, updates.reshape((ids.numel(),)
                                                             + tuple(x.shape[1:])))]}
    return {"Out": [_add_rows(x, ids, updates)]}


@register("scatter_nd_add", nondiff_inputs=("Index",))
def scatter_nd_add(ctx, ins):
    """X plus Updates added at the index tuples of Index's last dim."""
    x, idx, updates = ins["X"][0], ins["Index"][0], ins["Updates"][0]
    flat, row = _rows_nd(x, idx)
    return {"Out": [_add_rows(flat, row, updates).reshape(x.shape)]}


@register("strided_slice")
def strided_slice(ctx, ins):
    """Python slices ``starts[i]:ends[i]:strides[i]`` on ``axes``; a
    negative stride reads the flipped axis (PyTorch slices take none)."""
    x = ins["Input"][0]
    for a, s, e, st in zip(ctx.attr("axes", []), ctx.attr("starts", []),
                           ctx.attr("ends", []), ctx.attr("strides", [])):
        dim = x.shape[a]
        start, stop, step = slice(s, e, st).indices(dim)
        n = len(range(start, stop, step))
        if step < 0:
            x, start, step = torch.flip(x, dims=(a,)), dim - 1 - start, -step
        sl = [slice(None)] * x.ndim
        sl[a] = slice(start, start + (n - 1) * step + 1 if n else start, step)
        x = x[tuple(sl)]
    return {"Out": [x]}


@register("pad")
def pad(ctx, ins):
    """``paddings`` [before_0, after_0, before_1, ...] with ``pad_value``."""
    x = ins["X"][0]
    p = ctx.attr("paddings", [])
    flat = [v for i in reversed(range(x.ndim)) for v in (p[2 * i], p[2 * i + 1])]
    return {"Out": [F.pad(x, flat, value=ctx.attr("pad_value", 0.0))]}


def _pad_index(n, before, after, mode, device):
    """The source index of each of the n + before + after positions:
    ``reflect`` mirrors about the edges without repeating them, ``edge``
    repeats them (``jnp.pad``'s modes)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    i = i.abs()
    return (n - 1) - (n - 1 - i).abs()


@register("pad2d")
def pad2d(ctx, ins):
    """Pad H and W by ``paddings`` [top, bottom, left, right] (NCHW or
    NHWC): ``constant`` with ``pad_value``, ``reflect`` or ``edge``, the
    last two as gathers (``take_axis``) so that their gradient adds in a
    fixed order on the card."""
    x = ins["X"][0]
    p = ctx.attr("paddings", [0, 0, 0, 0])
    mode = ctx.attr("mode", "constant")
    h, w = (2, 3) if ctx.attr("data_format", "NCHW") == "NCHW" else (1, 2)
    if mode == "constant":
        flat = [0, 0] * (x.ndim - 1 - w) + [p[2], p[3]] + [0, 0] * (w - h - 1) + [p[0], p[1]]
        return {"Out": [F.pad(x, flat, value=ctx.attr("pad_value", 0.0))]}
    if mode not in ("reflect", "edge"):
        raise KeyError(mode)
    for axis, (before, after) in ((h, p[:2]), (w, p[2:])):
        x = take_axis(x, _pad_index(x.shape[axis], before, after, mode, x.device), axis)
    return {"Out": [x]}


def top_k_lower_first(x, k):
    """(values, indices) of the ``k`` largest entries of each row of ``x``,
    the lower index first among equal values, as ``jax.lax.top_k``
    (``torch.topk`` promises no order among ties): the first ``k`` of a
    stable descending sort. Its gradient lands on the entries the indices
    name."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register("top_k", nondiff_outputs=("Indices",))
def top_k(ctx, ins):
    vals, idx = top_k_lower_first(ins["X"][0], ctx.attr("k", 1))
    return {"Out": [vals], "Indices": [idx]}


@register("arg_max", grad=None, nondiff_inputs=("X",))
def arg_max(ctx, ins):
    """The first index of the maximum along ``axis``."""
    return {"Out": [torch.argmax(ins["X"][0], dim=ctx.attr("axis", -1))
                    .to(torch_dtype(ctx.attr("dtype_str", "int64")))]}


@register("arg_min", grad=None, nondiff_inputs=("X",))
def arg_min(ctx, ins):
    return {"Out": [torch.argmin(ins["X"][0], dim=ctx.attr("axis", -1))]}


@register("argsort", nondiff_outputs=("Indices",))
def argsort(ctx, ins):
    """A stable sort along ``axis`` (of ``-x`` when ``descending``, as the
    JAX lowering): equal values keep their order. Out is x taken at the
    indices, so its gradient lands where they point."""
    x = ins["X"][0]
    axis = ctx.attr("axis", -1)
    _, idx = torch.sort(-x if ctx.attr("descending", False) else x, dim=axis, stable=True)
    return {"Out": [torch.take_along_dim(x, idx, dim=axis)], "Indices": [idx]}


@register("roll")
def roll(ctx, ins):
    return {"Out": [torch.roll(ins["X"][0], shifts=tuple(ctx.attr("shifts", [0])),
                               dims=tuple(ctx.attr("axis", [0])))]}


def _flip(ctx, ins):
    return {"Out": [torch.flip(ins["X"][0], dims=tuple(ctx.attr("axis", [0])))]}


register("flip")(_flip)
register("reverse")(_flip)


@register("diag", grad=None)
def diag(ctx, ins):
    """A 1-D Diagonal becomes a square matrix; a 2-D one gives its diagonal."""
    return {"Out": [torch.diag(ins["Diagonal"][0])]}


@register("eye", grad=None)
def eye(ctx, ins):
    return {"Out": [torch.eye(ctx.attr("num_rows"), ctx.attr("num_columns"),
                              dtype=torch_dtype(ctx.attr("dtype", "float32")),
                              device=ctx.device)]}


@register("meshgrid", grad=None)
def meshgrid(ctx, ins):
    return {"Out": [t.contiguous() for t in torch.meshgrid(*ins["X"], indexing="ij")]}


@register("shard_index", grad=None, nondiff_inputs=("X",))
def shard_index(ctx, ins):
    """An id of shard ``shard_id`` becomes its offset in the shard (ids in
    ``index_num`` split into ``nshards`` ranges); any other id becomes
    ``ignore_value``."""
    x = ins["X"][0]
    size = (ctx.attr("index_num") + ctx.attr("nshards") - 1) // ctx.attr("nshards")
    return {"Out": [torch.where(torch.div(x, size, rounding_mode="floor")
                                == ctx.attr("shard_id"), torch.remainder(x, size),
                                torch.full((), ctx.attr("ignore_value", -1), dtype=x.dtype,
                                           device=x.device))]}
