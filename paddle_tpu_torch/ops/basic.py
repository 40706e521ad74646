"""Creation (``fill_constant``, ``fill_constant_batch_size_like``,
``fill_any_like``, ``fill_zeros_like``, the random fills, ``assign_value``,
``range``, ``linspace``, ``shape``), casting, copy, sum, ``increment``,
clip, one-hot, comparison, logical, ``isfinite`` and ``where`` ops (the
port's copy of ``paddle_tpu/ops/basic.py``, all 39 types).

New tensors go on ``ctx.device`` (the meta device under shape inference).
Random ops draw from the op's ``torch.Generator``, seeded on the host; the
numbers differ from the JAX package's, so tests hold them by mean and std,
not by bits. They run in startup programs, once: they are registered
``host_rng``, and the executor does not capture a program that holds one as
a CUDA graph (a replay would draw the numbers of the captured run again).
"""
from __future__ import annotations

import collections
import math
import threading

import torch

from ..core.registry import register, simple_op, torch_dtype


def _shape(ctx):
    return tuple(int(s) for s in ctx.attr("shape", []))


@register("fill_constant", grad=None)
def fill_constant(ctx, ins):
    return {"Out": [torch.full(_shape(ctx), ctx.attr("value", 0.0),
                               dtype=torch_dtype(ctx.attr("dtype", "float32")),
                               device=ctx.device)]}


@register("fill_constant_batch_size_like", grad=None, nondiff_inputs=("Input",))
def fill_constant_batch_size_like(ctx, ins):
    """A constant of ``shape`` whose dim ``output_dim_idx`` is Input's dim
    ``input_dim_idx`` (the batch): filled on the device, nothing read."""
    x = ins["Input"][0]
    shape = [int(s) for s in ctx.attr("shape", [])]
    shape[ctx.attr("output_dim_idx", 0)] = x.shape[ctx.attr("input_dim_idx", 0)]
    return {"Out": [torch.full(tuple(shape), ctx.attr("value", 0.0),
                               dtype=torch_dtype(ctx.attr("dtype", "float32")),
                               device=ctx.device)]}


@register("fill_any_like", grad=None, nondiff_inputs=("X",))
def fill_any_like(ctx, ins):
    """X's shape filled with ``value``, in ``dtype`` (X's when none)."""
    x = ins["X"][0]
    dtype = ctx.attr("dtype")
    return {"Out": [torch.full(tuple(x.shape), ctx.attr("value", 0.0),
                               dtype=torch_dtype(dtype) if dtype else x.dtype,
                               device=ctx.device)]}


@register("fill_zeros_like", grad=None)
def fill_zeros_like(ctx, ins):
    return {"Out": [torch.zeros_like(ins["X"][0])]}


@register("gaussian_random", grad=None, host_rng=True)
def gaussian_random(ctx, ins):
    x = torch.randn(_shape(ctx), generator=ctx.rng(ctx.attr("seed", 0)),
                    dtype=torch.float32, device=ctx.device)
    x = x * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)
    return {"Out": [x.to(torch_dtype(ctx.attr("dtype", "float32")))]}


@register("uniform_random", grad=None, host_rng=True)
def uniform_random(ctx, ins):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    x = torch.rand(_shape(ctx), generator=ctx.rng(ctx.attr("seed", 0)),
                   dtype=torch.float32, device=ctx.device)
    return {"Out": [(x * (hi - lo) + lo).to(torch_dtype(ctx.attr("dtype", "float32")))]}


@register("truncated_gaussian_random", grad=None, host_rng=True)
def truncated_gaussian_random(ctx, ins):
    """A normal truncated to [-2, 2] standard deviations (``jax.random.
    truncated_normal``'s bounds), by the inverse CDF of a uniform draw
    between the CDF's values at the bounds, then ``* std + mean``."""
    u = torch.rand(_shape(ctx), generator=ctx.rng(ctx.attr("seed", 0)),
                   dtype=torch.float32, device=ctx.device)
    lo, hi = (0.5 * math.erfc(b / math.sqrt(2)) for b in (2.0, -2.0))   # Phi(-2), Phi(2)
    x = math.sqrt(2) * torch.special.erfinv(2 * (lo + u * (hi - lo)) - 1)
    x = torch.clamp(x, -2.0, 2.0) * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)
    return {"Out": [x.to(torch_dtype(ctx.attr("dtype", "float32")))]}


@register("randint", grad=None, host_rng=True)
def randint(ctx, ins):
    """Integers uniform in [low, high)."""
    return {"Out": [torch.randint(ctx.attr("low", 0), ctx.attr("high", 100), _shape(ctx),
                                  generator=ctx.rng(ctx.attr("seed", 0)),
                                  dtype=torch_dtype(ctx.attr("dtype", "int64")),
                                  device=ctx.device)]}


#: (id of an op's ``values`` list, dtype, device) -> (the list, its tensor):
#: the constant is uploaded once, outside any CUDA-graph capture (the first,
#: eager run of a step makes it), and reused while the op holds that list
_CONSTANTS: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_CONSTANTS_CAP = 256
_CONSTANTS_LOCK = threading.Lock()


@register("assign_value", grad=None)
def assign_value(ctx, ins):
    """A constant from the op's attrs (``values``, flat; ``shape``;
    ``dtype``), converted as the JAX lowering converts it: through float64
    or int64. On the card the tensor is made once per op and device and
    then reused, so a captured step copies nothing from the host."""
    values = ctx.attr("values")
    shape = _shape(ctx)
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if ctx.abstract or ctx.device.type == "meta":
        return {"Out": [torch.empty(shape, dtype=dtype, device=ctx.device)]}
    key = (id(values), dtype, ctx.device)
    with _CONSTANTS_LOCK:
        hit = _CONSTANTS.get(key)
        if hit is not None and hit[0] is values:
            _CONSTANTS.move_to_end(key)
            return {"Out": [hit[1]]}
    if ctx.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("assign_value: its constant was not made before the CUDA "
                           "graph capture (the step's eager run makes it)")
    wide = torch.float64 if dtype.is_floating_point else torch.int64
    t = torch.tensor(list(values), dtype=wide).reshape(shape).to(dtype).to(ctx.device)
    if ctx.device.type == "cuda":
        with _CONSTANTS_LOCK:
            _CONSTANTS[key] = (values, t)
            while len(_CONSTANTS) > _CONSTANTS_CAP:
                _CONSTANTS.popitem(last=False)
    return {"Out": [t]}


#: (shape, device) -> its int32 tensor, made outside any capture as
#: ``assign_value``'s constants are
_SHAPES: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()


@register("shape", grad=None, nondiff_inputs=("Input",))
def shape_op(ctx, ins):
    """Input's shape as an int32 [ndim] tensor. On the card it is uploaded
    once per (shape, device), outside any CUDA-graph capture."""
    shape = tuple(int(d) for d in ins["Input"][0].shape)
    if ctx.device.type == "meta":
        return {"Out": [torch.empty((len(shape),), dtype=torch.int32, device=ctx.device)]}
    if ctx.device.type != "cuda":
        return {"Out": [torch.tensor(shape, dtype=torch.int32).reshape(len(shape))]}
    key = (shape, ctx.device)
    with _CONSTANTS_LOCK:
        t = _SHAPES.get(key)
        if t is not None:
            _SHAPES.move_to_end(key)
            return {"Out": [t]}
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("shape: its tensor was not made before the CUDA graph capture "
                           "(the step's eager run makes it)")
    t = torch.tensor(shape, dtype=torch.int32).reshape(len(shape)).to(ctx.device)
    with _CONSTANTS_LOCK:
        _SHAPES[key] = t
        while len(_SHAPES) > _CONSTANTS_CAP:
            _SHAPES.popitem(last=False)
    return {"Out": [t]}


def _static_bounds(ctx, ins, op, slots):
    """The values of ``slots``' one-element inputs, read on the host: as in
    the JAX lowering, tensor bounds cannot set a shape where the values are
    not known (shape inference, a capture)."""
    if ctx.abstract or ctx.device.type == "meta" or any(
            ins[s][0].device.type == "meta" for s in slots):
        raise ValueError(f"{op} needs static bounds: pass attrs (tensor inputs cannot "
                         f"set the output shape)")
    return [ins[s][0].reshape(-1)[0].item() for s in slots]


@register("range", grad=None)
def range_op(ctx, ins):
    """``arange(start, end, step)`` from the attrs, or from one-element
    inputs whose values are on hand."""
    if ctx.attr("start") is not None:
        start, end, step = ctx.attr("start"), ctx.attr("end"), ctx.attr("step", 1)
        dtype = torch_dtype(ctx.attr("dtype", "int64"))
    else:
        start, end, step = _static_bounds(ctx, ins, "range", ("Start", "End", "Step"))
        dtype = ins["Start"][0].dtype
    return {"Out": [torch.arange(start, end, step, dtype=dtype, device=ctx.device)]}


@register("linspace", grad=None)
def linspace(ctx, ins):
    """``num`` evenly spaced f32 values from ``start`` to ``stop``."""
    if ctx.attr("num") is not None:
        start, stop, num = ctx.attr("start"), ctx.attr("stop"), ctx.attr("num")
    else:
        start, stop, num = _static_bounds(ctx, ins, "linspace", ("Start", "Stop", "Num"))
    return {"Out": [torch.linspace(float(start), float(stop), int(num),
                                   dtype=torch.float32, device=ctx.device)]}


@simple_op("assign")
def assign(ctx, x):
    return x


@simple_op("cast")
def cast(ctx, x):
    return x.to(torch_dtype(ctx.attr("out_dtype", "float32")))


@simple_op("scale")
def scale(ctx, x):
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    if ctx.attr("bias_after_scale", True):
        return (x * s + b).to(x.dtype)
    return ((x + b) * s).to(x.dtype)


@simple_op("increment")
def increment(ctx, x):
    """x + step in x's dtype (the schedules' counter is int64 here, int32
    in the JAX package with x64 off: the values are the same)."""
    return x + torch.full((), ctx.attr("step", 1.0), dtype=x.dtype, device=x.device)


@register("sum")
def sum_op(ctx, ins):
    xs = [x for x in ins["X"] if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": [out]}


def _full(x, value):
    """A 0-d constant of x's dtype filled on x's device (no host copy)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def jnp_clip(x, lo, hi):
    """min(max(x, lo), hi), as ``jnp.clip`` computes it: at a bound the
    gradient is split as ``jnp.maximum`` / ``jnp.minimum`` split it
    (``torch.clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, _full(x, lo)), _full(x, hi))


@simple_op("clip")
def clip(ctx, x):
    return jnp_clip(x, ctx.attr("min"), ctx.attr("max"))


@simple_op("clip_by_norm")
def clip_by_norm(ctx, x):
    """x scaled to L2 norm ``max_norm`` where its norm exceeds it."""
    max_norm = ctx.attr("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


@simple_op("squared_l2_norm")
def squared_l2_norm(ctx, x):
    return torch.sum(x * x).reshape((1,))


@register("one_hot", grad=None, nondiff_inputs=("X",))
def one_hot(ctx, ins):
    """f32 one-hot rows of depth ``depth``; a trailing dim of 1 on X is
    dropped, as the JAX lowering drops it. An id outside [0, depth) gives a
    row of zeros, as ``jax.nn.one_hot``'s."""
    x = ins["X"][0]
    if x.ndim > 1 and x.shape[-1] == 1:
        x = x.squeeze(-1)
    depth = int(ctx.attr("depth"))
    classes = torch.arange(depth, dtype=x.dtype, device=x.device)
    return {"Out": [(x.unsqueeze(-1) == classes).to(torch.float32)]}


@register("one_hot_v2", grad=None, nondiff_inputs=("X",))
def one_hot_v2(ctx, ins):
    """``one_hot`` without dropping a trailing dim of 1."""
    x = ins["X"][0]
    classes = torch.arange(int(ctx.attr("depth")), dtype=x.dtype, device=x.device)
    return {"Out": [(x.unsqueeze(-1) == classes).to(torch.float32)]}


def _cmp(name, fn):
    @register(name, grad=None)
    def lower(ctx, ins):
        return {"Out": [fn(ins["X"][0], ins["Y"][0])]}

    return lower


# numpy broadcasting, as the JAX lowerings (not Fluid's ``axis`` rule)
less_than = _cmp("less_than", lambda x, y: x < y)
less_equal = _cmp("less_equal", lambda x, y: x <= y)
greater_than = _cmp("greater_than", lambda x, y: x > y)
greater_equal = _cmp("greater_equal", lambda x, y: x >= y)
equal = _cmp("equal", lambda x, y: x == y)
not_equal = _cmp("not_equal", lambda x, y: x != y)


def _logical(name, fn):
    @register(name, grad=None)
    def lower(ctx, ins):
        return {"Out": [fn(*(ins[s][0] for s in ("X", "Y") if s in ins))]}

    return lower


logical_and = _logical("logical_and", torch.logical_and)
logical_or = _logical("logical_or", torch.logical_or)
logical_xor = _logical("logical_xor", torch.logical_xor)
logical_not = _logical("logical_not", torch.logical_not)


@register("isfinite", grad=None)
def isfinite(ctx, ins):
    """Whether every element of X is finite, as a bool [1]."""
    return {"Out": [torch.all(torch.isfinite(ins["X"][0])).reshape((1,))]}


@register("where", nondiff_inputs=("Condition",))
def where_op(ctx, ins):
    return {"Out": [torch.where(ins["Condition"][0].bool(), ins["X"][0], ins["Y"][0])]}
