"""Collective communication ops over ``torch.distributed`` (the port's copy
of ``paddle_tpu/ops/collective.py``; reference
paddle/fluid/operators/collective/: c_allreduce_{sum,max,min,prod},
c_broadcast, c_allgather, c_reducescatter).

The JAX package lowers these to ``jax.lax`` collectives over a named mesh
axis bound by ``shard_map``. The port binds an axis name to a process group
instead (``bind``): the executor binds each axis of a ``CompiledProgram``'s
mesh larger than 1 (``dp`` or the strategy's data axis, ``pp``, ``sp``) to
this rank's group of it, and the ranks of one stage together under
``dp+sp`` (``core/executor.py::_run_compiled``, ``parallel/env.py::mesh_groups``),
and a caller may bind any axis it builds a group for. With no group bound for
the op's ``axis_name`` an op is the identity, as the JAX op is outside a
mesh, so the same program runs on one process.

Each op is a plain lowering on tensors. Where a gradient flows through it
(the generic grad op recomputes the forward under autograd), the
differentiable forms of ``torch.distributed.nn.functional`` carry it: the
transpose of an all-reduce is an all-reduce, of an all-gather a
reduce-scatter, of a broadcast a reduce to the root. ``prod`` is exact (an
all-gather and a product, as the JAX op); ``c_broadcast`` sends from
``root``; ``collective_permute`` shifts by ``offset`` around the ring; the
all-gather, reduce-scatter and all-to-all are the ``tiled`` forms. No op
copies through the host: a backend that refuses a collective on a tensor's
device raises.

Wire bytes (``comm_bytes_total`` and its kin, ``comm/compress.py``) are
recorded at each lowering call, which is an eager run or a CUDA-graph
capture (a replay runs no Python); telemetry never fails a run.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import torch

from ..core.registry import register

#: Communication metadata per op type, read by the static analyzer
#: (``analysis/dataflow.py``): the attr naming the mesh axis the op
#: communicates over, its default, and the kind. Every rank of the axis runs
#: the same sequence of these ops: they are synchronisation points, never
#: dead code. ``temporal_pipeline`` is listed as in the JAX package: its
#: lowering is the GPipe schedule over ``axis`` (``ops/pipeline_op.py``).
COLLECTIVE_OPS: Dict[str, dict] = {
    "c_allreduce_sum": {"comm": "allreduce", "axis_attr": "axis_name",
                        "default_axis": "dp"},
    "c_allreduce_max": {"comm": "allreduce", "axis_attr": "axis_name",
                        "default_axis": "dp"},
    "c_allreduce_min": {"comm": "allreduce", "axis_attr": "axis_name",
                        "default_axis": "dp"},
    "c_allreduce_prod": {"comm": "allreduce", "axis_attr": "axis_name",
                         "default_axis": "dp"},
    "c_allreduce_avg": {"comm": "allreduce", "axis_attr": "axis_name",
                        "default_axis": "dp"},
    "c_allgather": {"comm": "allgather", "axis_attr": "axis_name",
                    "default_axis": "dp"},
    "c_reducescatter": {"comm": "reducescatter", "axis_attr": "axis_name",
                        "default_axis": "dp"},
    "c_broadcast": {"comm": "broadcast", "axis_attr": "axis_name",
                    "default_axis": "dp"},
    "alltoall": {"comm": "alltoall", "axis_attr": "axis_name",
                 "default_axis": "dp"},
    "collective_permute": {"comm": "permute", "axis_attr": "axis_name",
                           "default_axis": "dp"},
    "temporal_pipeline": {"comm": "pipeline", "axis_attr": "axis",
                          "default_axis": "pp"},
    "reshard": {"comm": "reshard", "axis_attr": "axis_name",
                "default_axis": "dp"},
}


def is_collective(op_type: str) -> bool:
    return op_type in COLLECTIVE_OPS


def collective_axis(op) -> Optional[str]:
    """The mesh-axis name an Operator (or anything with ``.type``/``.attr``)
    communicates over, or None for non-collective ops."""
    meta = COLLECTIVE_OPS.get(op.type)
    if meta is None:
        return None
    return op.attr(meta["axis_attr"], meta["default_axis"])


# ------------------------------------------------------------------ groups --

class AxisGroup:
    """A mesh axis mapped onto processes: the ``torch.distributed`` group
    (None = the default, world group), its size, this process's index in
    it, and its backend (``nccl`` / ``gloo``)."""
    __slots__ = ("name", "group", "size", "rank", "backend")

    def __init__(self, name: str, group, size: int, rank: int, backend: str):
        self.name, self.group, self.size = name, group, int(size)
        self.rank, self.backend = int(rank), str(backend)

    def global_rank(self, r: int) -> int:
        """The world rank of index ``r`` of this group."""
        import torch.distributed as dist
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    def __repr__(self):
        return (f"AxisGroup({self.name!r}, size={self.size}, rank={self.rank}, "
                f"backend={self.backend!r})")


_BOUND: Dict[str, AxisGroup] = {}
_DATA_AXIS = ["dp"]   # the bound axis a batch's rows are split over


@contextlib.contextmanager
def bind(axes: Dict[str, AxisGroup], data_axis: str = "dp") -> Iterator[None]:
    """Bind axis names to process groups for the ops run inside, and name
    the data axis (the strategy's ``data_axis``) that batch statistics sum
    over. Nested bindings stack; the previous ones come back on exit."""
    prev, prev_data = dict(_BOUND), _DATA_AXIS[0]
    _BOUND.update(axes)
    _DATA_AXIS[0] = data_axis
    try:
        yield
    finally:
        _BOUND.clear()
        _BOUND.update(prev)
        _DATA_AXIS[0] = prev_data


def bound(name: str) -> Optional[AxisGroup]:
    """The group bound to axis ``name``, or None."""
    return _BOUND.get(name)


def axis_size(name: str) -> int:
    """The size of the group bound to ``name`` (1 when none is)."""
    g = _BOUND.get(name)
    return g.size if g is not None else 1


def bound_groups() -> Dict[str, AxisGroup]:
    """The axes bound now, by name (a copy)."""
    return dict(_BOUND)


def world_group(name: str = "dp") -> AxisGroup:
    """The default ``torch.distributed`` group as axis ``name`` (needs an
    initialised process group)."""
    import torch.distributed as dist
    return AxisGroup(name, None, dist.get_world_size(), dist.get_rank(),
                     str(dist.get_backend()))


def _axis(ctx):
    return ctx.attr("axis_name", "dp")


def _group(ctx) -> Optional[AxisGroup]:
    """The op's bound group, or None (the identity): never under shape
    inference."""
    if ctx.abstract:
        return None
    return _BOUND.get(_axis(ctx))


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _dnn():
    import torch.distributed.nn.functional as dnn
    return dnn


def _dist():
    import torch.distributed as dist
    return dist


def _refuse_capture(op) -> Optional[str]:
    """A collective over gloo is not captured into a CUDA graph: gloo's
    collectives are host calls. Under NCCL (or with no group bound) the op
    is captured with the step."""
    g = _BOUND.get(op.attr("axis_name", "dp"))
    if g is not None and g.backend == "gloo":
        return f"collective {op.type!r} runs over gloo, whose calls are on the host"
    return None


def _record(kind: str, x: torch.Tensor, g: AxisGroup, mode: str = "off") -> None:
    """Wire-byte accounting of one collective call (per device, by kind and
    on-wire dtype); never fails a run."""
    try:
        from ..comm import compress as _compress
        from ..comm import cost as _cost
        if g.size <= 1:
            return
        dtype = _dtype_name(x.dtype)
        raw = int(x.numel()) * _cost.dtype_wire_bytes(dtype)
        raw_wire = _cost.wire_bytes(kind, raw, g.size)
        if mode in ("bf16", "int8"):
            wire = _cost.wire_bytes(
                kind, _cost.compressed_bytes(raw, dtype, mode, g.size), g.size)
            dtype = mode if mode == "int8" else "bfloat16"
        else:
            wire = raw_wire
        _compress.record_collective(kind, dtype, raw_wire, wire)
    except Exception:
        pass   # telemetry must never fail a run


#: the wire-byte accounting of a collective made outside an op's lowering
#: (the pipeline's permutes, the ring's rotations)
record_collective = _record


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


# ------------------------------------------------------------ primitives --
# Each takes the local tensor and the bound group and returns a new tensor;
# under autograd (a recompute inside a grad op) the differentiable form.

def all_reduce_sum(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    if _differentiable(x):
        return _dnn().all_reduce(x, group=g.group or _dist().group.WORLD)
    out = x.clone()
    _dist().all_reduce(out, group=g.group)
    return out


def all_reduce_op(x: torch.Tensor, g: AxisGroup, op: str) -> torch.Tensor:
    """max / min: a plain all-reduce (no gradient flows through a max of
    ranks in the port; the JAX package gives none either)."""
    dist = _dist()
    out = x.detach().clone()
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()), group=g.group)
    return out


def all_gather(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The tiled all-gather: the ranks' blocks concatenated along ``dim``
    in rank order."""
    if _differentiable(x):
        parts = _dnn().all_gather(x.contiguous(), group=g.group or _dist().group.WORLD)
        return torch.cat(list(parts), dim=dim)
    xc = x.movedim(dim, 0).contiguous()
    out = xc.new_empty((g.size * xc.shape[0],) + tuple(xc.shape[1:]))
    # the list form, each block a view of ``out``: gloo gathers CUDA tensors
    # in this form only
    _dist().all_gather(list(out.chunk(g.size)), xc, group=g.group)
    return out.movedim(0, dim)


def stack_gather(x: torch.Tensor, g: AxisGroup) -> torch.Tensor:
    """The untiled all-gather: (size, *x.shape)."""
    return all_gather(x.unsqueeze(0), g, 0)


def reduce_scatter(x: torch.Tensor, g: AxisGroup, dim: int = 0) -> torch.Tensor:
    """The tiled reduce-scatter (sum): rank r keeps block r of ``dim``."""
    n = g.size
    if x.shape[dim] % n:
        raise ValueError(f"c_reducescatter: dim {dim} (={x.shape[dim]}) is not "
                         f"divisible by the axis size {n}")
    xc = x.movedim(dim, 0).contiguous()
    if _differentiable(x):
        out = xc.new_empty((xc.shape[0] // n,) + tuple(xc.shape[1:]))
        out = _dnn().reduce_scatter(out, list(xc.chunk(n)),
                                    group=g.group or _dist().group.WORLD)
    else:
        out = xc.new_empty((xc.shape[0] // n,) + tuple(xc.shape[1:]))
        _dist().reduce_scatter_tensor(out, xc, group=g.group)
    return out.movedim(0, dim)


def broadcast(x: torch.Tensor, g: AxisGroup, root: int = 0) -> torch.Tensor:
    src = g.global_rank(root)
    if _differentiable(x):
        return _dnn().broadcast(x.contiguous(), src, group=g.group or _dist().group.WORLD)
    out = x.contiguous().clone()
    _dist().broadcast(out, src, group=g.group)
    return out


def _a2a(out: torch.Tensor, inp: torch.Tensor, g: AxisGroup, out_splits=None,
         in_splits=None, grad: bool = False) -> torch.Tensor:
    if grad:
        return _dnn().all_to_all_single(out, inp, output_split_sizes=out_splits,
                                        input_split_sizes=in_splits,
                                        group=g.group or _dist().group.WORLD)
    _dist().all_to_all_single(out, inp, output_split_sizes=out_splits,
                              input_split_sizes=in_splits, group=g.group)
    return out


def all_to_all(x: torch.Tensor, g: AxisGroup, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """The tiled all-to-all: ``split_axis`` cut into ``size`` blocks, block
    j to rank j; the blocks received concatenated along ``concat_axis`` in
    rank order."""
    n = g.size
    if x.shape[split_axis] % n:
        raise ValueError(f"alltoall: dim {split_axis} (={x.shape[split_axis]}) is not "
                         f"divisible by the axis size {n}")
    xs = x.movedim(split_axis, 0)
    per = xs.shape[0] // n
    xs = xs.reshape((n, per) + tuple(xs.shape[1:])).contiguous()
    out = _a2a(torch.empty_like(xs), xs, g, grad=_differentiable(x))
    # out[j]: rank j's block for this rank, in the moved layout
    blocks = [out[j].movedim(0, split_axis) for j in range(n)]
    return torch.cat(blocks, dim=concat_axis)


def permute(x: torch.Tensor, g: AxisGroup, pairs) -> torch.Tensor:
    """``collective_permute``: ``pairs`` are (src, dst) indices; a rank that
    receives nothing gets zeros (the ``ppermute`` contract)."""
    n, me = g.size, g.rank
    dst = {s: d for s, d in pairs}
    src = {d: s for s, d in pairs}
    numel = x.numel()
    # a rank that sends nothing hands the all-to-all an empty input
    xf = x.contiguous().reshape(-1) if me in dst else x.new_empty((0,))
    in_splits = [numel if dst.get(me) == j else 0 for j in range(n)]
    out_splits = [numel if src.get(me) == j else 0 for j in range(n)]
    out = xf.new_empty((sum(out_splits),))
    out = _a2a(out, xf, g, out_splits, in_splits, grad=_differentiable(x))
    if me not in src:
        return torch.zeros_like(x)
    return out.reshape(x.shape)


def permute_packed(tensors, g: AxisGroup, pairs) -> list:
    """``tensors`` moved along ``pairs`` (``permute``) in one call a dtype,
    packed flat, their wire bytes recorded; None entries stay None. The
    pipeline's and the ring's hand-offs, outside any op's lowering."""
    out = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, list] = {}
    for i, t in enumerate(tensors):
        if t is not None:
            by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        _record("permute", flat, g)
        moved = permute(flat, g, pairs)
        for i, part in zip(idx, moved.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


def batch_stats_group(ctx) -> Optional[AxisGroup]:
    """The group a batch-statistics op (``batch_norm``, ``conv2d_bn_fused``)
    sums its statistics over: the bound data axis (``bind``'s ``data_axis``)
    when more than one rank is bound to it (the global batch's statistics,
    which GSPMD gives the JAX package for free, ``sync_batch_norm``), else
    None (local)."""
    if ctx.abstract:
        return None
    g = _BOUND.get(_DATA_AXIS[0])
    return g if g is not None and g.size > 1 else None


def stats_capture_refusal(op) -> Optional[str]:
    """A training batch-statistics op whose sums go over gloo is not
    captured (``_refuse_capture``)."""
    g = _BOUND.get(_DATA_AXIS[0])
    if g is not None and g.size > 1 and g.backend == "gloo" and \
            not (op.attr("is_test", False) or op.attr("use_global_stats", False)):
        return f"{op.type!r} sums its statistics over gloo, whose calls are on the host"
    return None


def sum_stats(g: AxisGroup, *stats: torch.Tensor):
    """Per-channel sums summed over the ranks of ``g`` in one all-reduce
    (differentiable under autograd)."""
    sizes = [t.numel() for t in stats]
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in stats]), g)
    return [p.reshape(t.shape) for p, t in zip(flat.split(sizes), stats)]


# -------------------------------------------------------------- lowerings --

def _coll(op_type, fn, kind):
    @register(op_type, grad="auto", capture_refusal=_refuse_capture)
    def lower(ctx, ins, fn=fn):
        x = ins["X"][0]
        g = _group(ctx)
        if g is None:
            return {"Out": [x]}
        _record(kind, x, g)
        return {"Out": [fn(x, g)]}
    return lower


def _allreduce_compressed(ctx, ins, g: AxisGroup, mean: bool):
    """The quantize -> all-reduce -> dequantize path of c_allreduce_sum/avg
    (``comm_compression`` through the rewrite's ``comm_compress`` attr), with
    the error-feedback residual threaded through ResidualIn / ResidualOut.
    The residual persistable is declared (ndp, *shape); each process holds
    its own (1, *shape) block of it."""
    from ..comm import compress as _compress
    x = ins["X"][0]
    mode = ctx.attr("comm_compress", "off")
    res_in = (ins.get("ResidualIn") or [None])[0]
    if mode in ("bf16", "int8") and _dtype_name(x.dtype) not in _compress.SUPPORTED_DTYPES:
        mode = "off"
    _record("allreduce", x, g, mode)
    if mode not in ("bf16", "int8") or g.size <= 1:
        out = all_reduce_sum(x, g)
        if mean:
            out = out / g.size
        outs = {"Out": [out]}
        if res_in is not None:
            outs["ResidualOut"] = [res_in]
        return outs
    res_local = res_in.squeeze(0) if res_in is not None else None
    out, err = _compress.compressed_allreduce(x, g, mode, residual=res_local, mean=mean)
    outs = {"Out": [out]}
    if res_in is not None:
        outs["ResidualOut"] = [err.unsqueeze(0)]
    return outs


def _coll_allreduce(op_type, mean):
    @register(op_type, grad="auto", capture_refusal=_refuse_capture)
    def lower(ctx, ins, mean=mean):
        x = ins["X"][0]
        g = _group(ctx)
        if g is None:
            outs = {"Out": [x]}
            res_in = (ins.get("ResidualIn") or [None])[0]
            if res_in is not None:
                outs["ResidualOut"] = [res_in]
            return outs
        if ctx.attr("comm_compress", "off") != "off" or "ResidualIn" in ins:
            return _allreduce_compressed(ctx, ins, g, mean)
        _record("allreduce", x, g)
        out = all_reduce_sum(x, g)
        return {"Out": [out / g.size if mean else out]}
    return lower


_coll_allreduce("c_allreduce_sum", mean=False)
_coll_allreduce("c_allreduce_avg", mean=True)
_coll("c_allreduce_max", lambda x, g: all_reduce_op(x, g, "max"), "allreduce")
_coll("c_allreduce_min", lambda x, g: all_reduce_op(x, g, "min"), "allreduce")
# exact product: gather every rank's tensor and multiply in rank order (no
# product all-reduce is exact on every backend; the JAX op does the same)
_coll("c_allreduce_prod", lambda x, g: torch.prod(stack_gather(x, g), dim=0), "allreduce")
_coll("c_allgather", lambda x, g: all_gather(x, g, 0), "allgather")
_coll("c_reducescatter", lambda x, g: reduce_scatter(x, g, 0), "reducescatter")


@register("c_broadcast", grad="auto", capture_refusal=_refuse_capture)
def c_broadcast(ctx, ins):
    """Broadcast from index ``root`` of the axis."""
    x = ins["X"][0]
    g = _group(ctx)
    if g is None:
        return {"Out": [x]}
    _record("broadcast", x, g)
    return {"Out": [broadcast(x, g, int(ctx.attr("root", 0)))]}


@register("alltoall", grad="auto", capture_refusal=_refuse_capture)
def alltoall(ctx, ins):
    """Ulysses-style all-to-all: split ``split_axis``, concat on ``concat_axis``."""
    x = ins["X"][0]
    g = _group(ctx)
    if g is None:
        return {"Out": [x]}
    _record("alltoall", x, g)
    return {"Out": [all_to_all(x, g, int(ctx.attr("split_axis", 0)),
                               int(ctx.attr("concat_axis", 0)))]}


@register("collective_permute", grad="auto", capture_refusal=_refuse_capture)
def collective_permute(ctx, ins):
    """Ring shift by ``offset`` along the axis: rank i sends to i + offset."""
    x = ins["X"][0]
    g = _group(ctx)
    if g is None:
        return {"Out": [x]}
    _record("permute", x, g)
    n, off = g.size, int(ctx.attr("offset", 1))
    return {"Out": [permute(x, g, [(i, (i + off) % n) for i in range(n)])]}


@register("reshard", grad="auto", capture_refusal=_refuse_capture)
def reshard_op(ctx, ins):
    """Spec-to-spec redistribution of a local block through the comm.reshard
    planner's collective sequence. Attrs ``src_dim`` / ``dst_dim`` (-1 =
    replicated) and ``axis_name``: src_dim=k, dst_dim=-1 is the ZeRO
    re-gather; src_dim=-1, dst_dim=k the local slice."""
    from ..comm import compress as _compress
    from ..comm import reshard as _reshard
    x = ins["X"][0]
    g = _group(ctx)
    if g is None:
        return {"Out": [x]}
    n = g.size
    src_dim = int(ctx.attr("src_dim", -1))
    dst_dim = int(ctx.attr("dst_dim", -1))
    src = _reshard.ShardSpec(None if src_dim < 0 else src_dim, n, g.name)
    dst = _reshard.ShardSpec(None if dst_dim < 0 else dst_dim, n, g.name)
    gshape = list(x.shape)
    if src.sharded:
        gshape[src.dim] *= n   # x is the local block of the source spec
    plan = _reshard.plan_transfer(gshape, _dtype_name(x.dtype), src, dst, axis=g.name)
    for s in plan.steps:
        if s.wire_bytes:
            try:
                _compress.record_collective(s.collective, _dtype_name(x.dtype),
                                            s.wire_bytes, s.wire_bytes)
            except Exception:
                pass   # telemetry must never fail a run
    return {"Out": [_reshard.apply_transfer(x, plan, g)]}


@register("c_sync_calc_stream", grad="auto")
def c_sync_calc_stream(ctx, ins):
    # the identity: a collective's result is ordered on the compute stream
    # already (the reference needed an explicit stream sync)
    return {"Out": [ins["X"][0]]}


@register("c_sync_comm_stream", grad="auto")
def c_sync_comm_stream(ctx, ins):
    return {"Out": [ins["X"][0]]}
