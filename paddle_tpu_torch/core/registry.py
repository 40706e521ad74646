"""Op registry: type -> (lowering, shape inference, grad maker).

The port's copy of ``paddle_tpu/core/registry.py``. A lowering is a plain
function on torch tensors, ``lower(ctx, ins) -> outs``, where ins/outs map
slot name -> list of tensors. Kernel choice happens inside the lowering,
by the device of the tensors it is given.

Shape inference runs the lowering itself on ``torch.device("meta")`` tensors
(no data, no memory), with each -1 dim replaced by a sentinel. Inference runs
twice with two coprime sentinels; an output dim is dynamic iff it differs
between the runs. A lowering therefore makes every new tensor on
``ctx.device`` and never reads values (no ``.item()``, no numpy).

Grad ops are derived from the forward lowering, as in the JAX package: every
differentiable op type T has a generic ``T_grad`` whose lowering takes
``torch.autograd.grad`` of T's outputs against the cotangents. In the JAX
package the grad op recomputes T under ``jax.vjp`` and XLA's CSE merges the
recompute with the forward. The port's counterpart: the executor runs a
forward op whose generic grad op is in the same block under autograd
(``lower_keeping_graph``) and keeps its graph in a per-run table keyed by
the op's first output name; the grad op takes that graph when every forward
input it reads is the very tensor the forward consumed (or, for a running
state such as a batch norm's Mean, what the forward wrote back to it), and
otherwise reruns T's lowering on ``detach().requires_grad_()`` copies of its float
inputs, as the reference's semantics say. An op declares itself
non-differentiable with ``grad=None``; ``nondiff_inputs`` /
``nondiff_outputs`` name the slots that carry no gradient.

Second order, as in the JAX package: a grad op is differentiable through
the same machinery, so ``T_grad_grad`` is the generic grad of ``T_grad``
(double-gradient checks, gradient penalties). A grad op whose outputs feed
a later grad op runs under autograd with its inputs' graph kept
(``lower_keeping_graph``): it recomputes T from those inputs and calls
``torch.autograd.grad`` with ``create_graph=True``, and only then, so a
first-order step keeps its memory and time. Third order is the JAX
package's ceiling too: a ``T_grad_grad`` names slots on both sides, and
its grad maker refuses it.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..framework import Block, Operator, convert_dtype, grad_var_name

_DYN = 7919
_DYN2 = 7927
EMPTY_VAR = "@EMPTY@"

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """Canonical dtype name (or alias) -> torch dtype."""
    return _TORCH_DTYPES[convert_dtype(dtype)]


def _mix(h: int, v: int) -> int:
    """One splitmix64 round folding ``v`` into ``h``."""
    h = (h ^ (v & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15
    h &= 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return h ^ (h >> 31)


_U64 = 0xFFFFFFFFFFFFFFFF


def seed_int(seed: int, counter: int, salt: int) -> int:
    """The dropout seed of one op in one run: three splitmix64 rounds over
    (program seed, run counter, salt), cut to 63 bits."""
    s = _mix(_mix(_mix(0, seed), counter), salt & 0x7FFFFFFF)
    return s & 0x7FFFFFFFFFFFFFFF


class DeviceSeed:
    """A dropout seed that a kernel derives on the card: ``seed_int``'s three
    ``_mix`` rounds over (program seed, the run counter read from the
    one-element int64 tensor ``counter``, ``salt``), computed in the kernel
    (``run_seed`` in csrc/philox.cuh). A CUDA graph that captures the launch
    reads whatever counter the executor wrote before the replay."""
    __slots__ = ("counter", "seed", "salt")

    def __init__(self, counter: torch.Tensor, seed: int, salt: int):
        self.counter, self.seed, self.salt = counter, seed, salt

    def args(self):
        """(counter pointer, program seed, salt) as a kernel's C interface
        takes them."""
        return (self.counter.data_ptr(), self.seed & _U64, self.salt & 0x7FFFFFFF)


class LowerCtx:
    """Per-op lowering context: attrs, the device new tensors go on (the CPU
    unless given), and RNG.

    ``seed_int(offset)`` is a host integer mixed from (program seed, run
    counter, this op's salt + offset): each run of a program draws fresh
    numbers, and two runs with the same counter draw the same ones. A grad
    op is given its forward op's salt, so a stochastic op recomputed inside
    its grad op draws the same mask. ``rng(offset)`` is a ``torch.Generator``
    on ``device`` seeded with it. Under shape inference (``abstract``) there
    are no numbers to draw: ``rng`` returns None and ``seed_int`` 0.

    ``counter_t`` is the run counter on the card, a one-element int64 tensor
    that the executor owns and writes before each run (None off the card and
    outside an executor). ``kernel_seed(offset)`` is what a kernel wrapper
    takes: a ``DeviceSeed`` over it when there is one, else ``seed_int``. The
    two give the same seed for the same counter.
    ``graphs`` is the run's table of kept forward graphs, which a generic
    grad op reads.
    ``block_runner(idx, sub_env, keep=None)`` runs block ``idx`` of the
    program over the enclosing env with ``sub_env`` on top and returns the
    env it ends with (``keep`` as ``trace_block``'s); a control-flow op runs
    its body through it. None outside an executor.
    """

    def __init__(self, attrs: dict, device=None, seed: int = 0, counter: int = 0,
                 salt: int = 0, abstract: bool = False, graphs: Optional[dict] = None,
                 counter_t: Optional[torch.Tensor] = None,
                 block_runner: Optional[Callable] = None):
        self.attrs = attrs
        self.device = torch.device(device if device is not None else "cpu")
        self.seed = seed
        self.counter = counter
        self.counter_t = counter_t
        self._salt = salt
        self.abstract = abstract
        #: the run's kept forward graphs (``lower_keeping_graph``), or None
        self.graphs = graphs
        self.block_runner = block_runner

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def seed_int(self, offset: int = 0) -> int:
        if self.abstract:
            return 0
        return seed_int(self.seed, self.counter, self._salt + offset)

    def kernel_seed(self, offset: int = 0):
        if self.counter_t is None or self.abstract:
            return self.seed_int(offset)
        return DeviceSeed(self.counter_t, self.seed, self._salt + offset)

    def rng(self, offset: int = 0) -> Optional[torch.Generator]:
        if self.abstract:
            return None
        g = torch.Generator(device=self.device)
        g.manual_seed(self.seed_int(offset))
        return g


def stable_salt(name: str) -> int:
    """Deterministic salt from a var name (Python hash() is randomized per process)."""
    h = 2166136261
    for c in name.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


class OpDef:
    def __init__(self, type: str, lower: Callable, infer_shape: Optional[Callable] = None,
                 grad: Any = "auto", nondiff_inputs: Sequence[str] = (),
                 nondiff_outputs: Sequence[str] = (), state_inputs: Sequence[str] = (),
                 host_rng: bool = False, remat: bool = False):
        self.type = type
        self.lower = lower
        self.custom_infer_shape = infer_shape
        self.grad = grad  # "auto" | None (non-differentiable) | callable custom maker
        self.nondiff_inputs = frozenset(nondiff_inputs)
        self.nondiff_outputs = frozenset(nondiff_outputs)
        # running state the op reads and writes back under the same names (a
        # batch norm's Mean / Variance): its differentiable outputs do not
        # read it in train mode, and in test mode it is written back unchanged
        self.state_inputs = frozenset(state_inputs)
        # draws from a host-seeded torch.Generator (the run counter baked in
        # at launch): a program holding such an op is not captured as a graph
        self.host_rng = host_rng
        # never keeps its forward graph (``forwards_with_grads``): its generic
        # grad op recomputes it under autograd (``remat_segment``)
        self.remat = remat


_REGISTRY: Dict[str, OpDef] = {}


def register(type: str, *, grad="auto", nondiff_inputs=(), nondiff_outputs=(),
             infer_shape=None, state_inputs=(), host_rng=False, remat=False):
    """Decorator: register ``fn(ctx, ins) -> outs`` as the lowering for ``type``
    (``infer_shape(op, block)`` replaces the meta-tensor inference)."""

    def deco(fn):
        if type in _REGISTRY:
            raise ValueError(f"op type {type!r} already registered")
        _REGISTRY[type] = OpDef(type, fn, infer_shape, grad, nondiff_inputs,
                                nondiff_outputs, state_inputs, host_rng, remat)
        return fn

    return deco


def simple_op(type: str, *, grad="auto", nondiff_inputs=()):
    """Register an op with input slots consumed in sorted-slot order -> single 'Out'.

    The wrapped fn receives ``(ctx, *tensors)`` -- one tensor per input slot
    entry, in sorted slot order -- and returns the single output tensor.
    """

    def deco(fn):
        @functools.wraps(fn)
        def lower(ctx, ins):
            args = [v for s in sorted(ins) for v in ins[s]]
            return {"Out": [fn(ctx, *args)]}

        register(type, grad=grad, nondiff_inputs=nondiff_inputs)(lower)
        return fn

    return deco


def get(type: str) -> OpDef:
    d = _REGISTRY.get(type)
    if d is not None:
        return d
    if type.endswith("_grad"):
        base = type[:-5]
        if base in _REGISTRY or base.endswith("_grad"):
            return _grad_opdef(base)
    raise KeyError(
        f"op type {type!r} is not registered in paddle_tpu_torch "
        f"({len(_REGISTRY)} ops registered); the port does not have it yet")


# --------------------------------------------------------------------------------------
# Generic autograd-based grad op
# --------------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _grad_opdef(fwd_type: str) -> OpDef:
    fwd = _REGISTRY.get(fwd_type)
    if fwd is None:
        if fwd_type.endswith("_grad"):   # higher order: tanh_grad_grad etc.
            fwd = _grad_opdef(fwd_type[:-5])
        else:
            raise KeyError(f"op type {fwd_type!r} is not registered")
    if fwd.grad is None:
        raise KeyError(f"op {fwd_type!r} is non-differentiable; no {fwd_type}_grad")

    def lower(ctx, ins):
        return _generic_grad_lower(fwd, ctx, ins)

    # a grad op is differentiable through the same machinery (second order);
    # a *_grad_grad op names slots on both sides, which make_grad_op_descs
    # refuses (third order), as the JAX package does
    return OpDef(fwd_type + "_grad", lower, infer_shape=_grad_infer_shape)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.dtype.is_floating_point


def generic_grad_forward(type: str) -> Optional[str]:
    """The forward op type whose generic grad op ``type`` is, or None (not a
    grad op, or a grad op type registered with its own lowering). The
    forward of a ``T_grad_grad`` is ``T_grad``."""
    if type in _REGISTRY or not type.endswith("_grad"):
        return None
    base = type[:-5]
    fwd = _REGISTRY.get(base)
    if fwd is None:
        return base if generic_grad_forward(base) is not None else None
    return base if fwd.grad == "auto" else None


def first_output(op: Operator) -> str:
    """The name a grad op carries as ``__fwd_out0__``: its forward op's
    first output, which also salts both ops' random draws."""
    return next((ns[0] for ns in op.outputs.values() if ns), "")


def forwards_with_grads(ops: Sequence[Operator]) -> frozenset:
    """(forward type, first output) of each forward op whose generic grad op
    is among ``ops``: the ops whose graphs a run keeps. A ``remat`` op's is
    never kept: its grad op recomputes it. A grad op that is itself the
    forward of a grad op among ``ops`` (second order) is kept, and it reads
    no kept graph of its own forward (it recomputes it with the graph to its
    inputs, ``_generic_grad_lower``): that forward's graph is kept only for
    a grad op that is not differentiated again."""
    grads = [(f, op) for op in ops if (f := generic_grad_forward(op.type)) is not None]
    differentiated = {(f, op.attr("__fwd_out0__")) for f, op in grads}
    return frozenset((f, op.attr("__fwd_out0__")) for f, op in grads
                     if (op.type, first_output(op)) not in differentiated
                     and not get(f).remat)


def _differentiable(fwd: OpDef, ins, slots, keep_graph: bool = False):
    """``ins`` with each float input of a differentiable slot replaced by a
    ``detach().requires_grad_()`` view (same storage and strides, so a
    kernel wrapper can hand its ``data_ptr()`` to CUDA); with
    ``keep_graph`` an input that already requires grad stays itself, so
    the graph runs on through it. Returns (inputs, [(slot, index)],
    views)."""
    full = {s: list(ins[s]) for s in slots}
    diff_keys, primals = [], []
    for s in slots:
        if s in fwd.nondiff_inputs:
            continue
        for i, v in enumerate(ins[s]):
            if _is_float(v):
                p = v if keep_graph and v.requires_grad else v.detach().requires_grad_()
                full[s][i] = p
                diff_keys.append((s, i))
                primals.append(p)
    return full, diff_keys, primals


class _ForwardGraph:
    """A forward op's outputs with their autograd graph, kept for its grad op."""
    __slots__ = ("type", "attrs", "ins", "diff_keys", "primals", "outs")

    def __init__(self, type, attrs, ins, diff_keys, primals, outs):
        self.type, self.attrs, self.ins = type, attrs, ins
        self.diff_keys, self.primals, self.outs = diff_keys, primals, outs

    def serves(self, fwd: OpDef, attrs: dict, ins, slots) -> bool:
        """The identity guard: the same op type and attrs, over the very
        tensors the forward consumed, so autograd over this graph is what a
        recompute would give (XLA's CSE merges only equal inputs too). A
        state input may instead hold what the forward op itself wrote back
        to it: a recompute from that gives the same differentiable outputs."""
        if self.type != fwd.type or self.attrs != attrs or sorted(self.ins) != list(slots):
            return False
        own = [o for vs in self.outs.values() for o in vs if o is not None]
        for s in slots:
            if len(self.ins[s]) != len(ins[s]):
                return False
            for a, b in zip(self.ins[s], ins[s]):
                if a is not b and not (s in fwd.state_inputs and any(b is o for o in own)):
                    return False
        return True


def lower_keeping_graph(d: OpDef, ctx: LowerCtx, ins, key: str):
    """Run forward op ``d`` under autograd, on ``detach().requires_grad_()``
    views of its float inputs, and keep its graph in ``ctx.graphs[key]``
    for its generic grad op. The views cut the graph at the op's inputs, so
    the graphs of different ops never chain."""
    slots = sorted(ins)
    full, diff_keys, primals = _differentiable(d, ins, slots)
    with torch.enable_grad():
        outs = d.lower(ctx, full)
    ctx.graphs[key] = _ForwardGraph(d.type, ctx.attrs, {s: list(ins[s]) for s in slots},
                                    diff_keys, primals, outs)
    return outs


def _generic_grad_lower(fwd: OpDef, ctx, ins):
    """Compute input grads of ``fwd`` by autograd through its lowering.

    Grad-op input slots: forward input slots verbatim, forward output slots
    verbatim (listed in attr __fwd_out_slots__), plus "<OutSlot>@GRAD"
    cotangent slots. Output slots: "<InSlot>@GRAD". A missing cotangent
    (None via @EMPTY@) counts as zeros; an input the outputs do not depend
    on gets a zero grad.

    The graph comes from the run's table when the executor kept the
    forward's (``lower_keeping_graph``) and it serves these inputs; the
    entry is taken either way, so a second grad op of the same forward
    recomputes. Otherwise the forward lowering reruns here, with the
    forward's salt, so it draws the forward's random masks.

    Under autograd with inputs that carry a graph (this grad op is the
    forward of a second-order grad op) the grads must be differentiable
    too: the forward reruns on those very inputs, not on detached copies
    and not from the table (whose graph starts at other copies of them),
    and ``torch.autograd.grad`` runs with ``create_graph=True``.
    """
    fwd_out_slots = set(ctx.attr("__fwd_out_slots__", []))

    def _is_cot(s):
        return s.endswith("@GRAD") and s[:-5] in fwd_out_slots

    fwd_in_slots = sorted(s for s in ins if s not in fwd_out_slots and not _is_cot(s))
    grad_by_slot = {s[:-5]: ins[s] for s in ins if _is_cot(s)}

    fwd_attrs = ctx.attr("__fwd_attrs__", None)
    if fwd_attrs is None:
        fwd_attrs = {k: v for k, v in ctx.attrs.items() if not k.startswith("__fwd_")}
    create_graph = torch.is_grad_enabled() and any(
        _is_float(v) and v.requires_grad for vs in ins.values() for v in vs)
    kept = (ctx.graphs.pop(ctx.attr("__fwd_out0__"), None)
            if ctx.graphs is not None and not create_graph else None)
    if kept is not None and kept.serves(fwd, fwd_attrs, ins, fwd_in_slots):
        diff_keys, primals, outs = kept.diff_keys, kept.primals, kept.outs
    else:
        full, diff_keys, primals = _differentiable(fwd, ins, fwd_in_slots, create_graph)
        # a grad op recomputed here draws with its own forward's salt (the
        # one the executor gave it), as the forward itself did
        inner = fwd_attrs.get("__fwd_out0__")
        salt = stable_salt(inner) if inner else ctx._salt
        fwd_ctx = LowerCtx(fwd_attrs, ctx.device, ctx.seed, ctx.counter, salt,
                           ctx.abstract, counter_t=ctx.counter_t,
                           block_runner=ctx.block_runner)
        with torch.enable_grad():
            outs = fwd.lower(fwd_ctx, full)
    del kept
    ys, cots = [], []
    for s, vals in outs.items():
        if s in fwd.nondiff_outputs:
            continue
        provided = grad_by_slot.get(s) or []
        for i, o in enumerate(vals):
            g = provided[i] if i < len(provided) else None
            if g is None or not _is_float(o) or not o.requires_grad:
                continue   # a zero cotangent adds nothing
            ys.append(o)
            cots.append(g.to(o.dtype))
    grads = [None] * len(primals)
    if ys and primals:
        grads = torch.autograd.grad(ys, primals, cots, allow_unused=True,
                                    create_graph=create_graph)

    result: Dict[str, List] = {}
    for s in fwd_in_slots:
        if s not in fwd.nondiff_inputs:
            result[s + "@GRAD"] = [None] * len(ins[s])
    for (s, i), g in zip(diff_keys, grads):
        result[s + "@GRAD"][i] = g
    for gs in list(result):
        base = gs[:-5]
        result[gs] = [v if v is not None else
                      (torch.zeros_like(ins[base][i]) if ins[base][i] is not None else None)
                      for i, v in enumerate(result[gs])]
    return result


def make_grad_op_descs(op: Operator, grad_out_map: Dict[str, str]) -> List[dict]:
    """Generic GradOpDescMaker: one '<type>_grad' op desc for ``op``.

    ``grad_out_map``: forward output var name -> grad var name (only for
    outputs with gradient flow; others get @EMPTY@). Returns op-desc dicts
    {type, inputs, outputs, attrs}; the caller (backward.py) appends them and
    prunes unwanted grad outputs.
    """
    fwd = get(op.type)
    if fwd.grad is None:
        return []
    if callable(fwd.grad):
        return fwd.grad(op, grad_out_map)
    clash = set(op.inputs) & set(op.outputs)
    if clash:
        # a *_grad_grad op names slots on both sides: its grad op's slots
        # would clobber the primal inputs. Second order is the ceiling, as
        # in the JAX package
        raise NotImplementedError(
            f"gradients of {op.type!r}: third-order gradients are not "
            f"supported (input/output slot collision on {sorted(clash)})")

    inputs: Dict[str, List[str]] = {s: list(n) for s, n in op.inputs.items()}
    for s, names in op.outputs.items():
        inputs[s] = list(names)
        gnames = [grad_out_map.get(n) for n in names]
        if any(g is not None for g in gnames):
            inputs[s + "@GRAD"] = [g if g is not None else EMPTY_VAR for g in gnames]
    outputs = {}
    for s, names in op.inputs.items():
        if s in fwd.nondiff_inputs:
            continue
        outputs[s + "@GRAD"] = [grad_var_name(n) for n in names]
    attrs = dict(op.attrs)
    # the op's own attrs, before this level's bookkeeping overwrites the flat
    # __fwd_* keys: a grad op differentiated again needs its own back
    attrs["__fwd_attrs__"] = dict(op.attrs)
    attrs["__fwd_out_slots__"] = sorted(op.outputs)
    attrs["__fwd_out0__"] = first_output(op)
    return [{"type": op.type + "_grad", "inputs": inputs, "outputs": outputs,
             "attrs": attrs}]


# --------------------------------------------------------------------------------------
# Shape inference
# --------------------------------------------------------------------------------------

def infer_shape(op: Operator, block: Block):
    """Infer and create the output variables of ``op``: the op's own
    inference where it has one (grad ops), else its lowering run on meta
    tensors."""
    d = get(op.type)
    if d.custom_infer_shape is not None:
        d.custom_infer_shape(op, block)
        return
    _meta_infer(d, op, block)


def _grad_infer_shape(op: Operator, block: Block):
    """Grad var shapes and dtypes mirror the forward input vars'."""
    for slot, names in op.outputs.items():
        if not slot.endswith("@GRAD"):
            continue
        src = op.inputs.get(slot[:-5], [])
        for i, n in enumerate(names):
            if n == EMPTY_VAR:
                continue
            sv = block.find_var_recursive(src[i]) if i < len(src) else None
            if sv is not None:
                v = block.create_var(n, sv.shape, sv.dtype)
            else:
                v = block.create_var(n, (), "float32")
            v.stop_gradient = False


def _meta_infer(d: OpDef, op: Operator, block: Block):
    meta = torch.device("meta")

    def build(sentinel):
        has_dyn = False
        ins: Dict[str, List] = {}
        for slot, names in op.inputs.items():
            vals = []
            for n in names:
                if n == EMPTY_VAR:
                    vals.append(None)
                    continue
                v = block.find_var_recursive(n)
                if v is None:
                    raise KeyError(f"op {op.type}: input var {n!r} not found")
                has_dyn |= any(dim == -1 for dim in v.shape)
                shape = tuple(sentinel if dim == -1 else dim for dim in v.shape)
                vals.append(torch.empty(shape, dtype=torch_dtype(v.dtype), device=meta))
            ins[slot] = vals
        return ins, has_dyn

    def run(ins):
        ctx = LowerCtx(op.attrs, device=meta, abstract=True)
        try:
            with torch.no_grad():
                return d.lower(ctx, ins)
        except Exception as e:
            shapes = {s: [None if v is None else (tuple(v.shape), str(v.dtype))
                          for v in vs] for s, vs in ins.items()}
            raise RuntimeError(f"shape inference failed for op {op.type!r} "
                               f"(inputs: {shapes}): {e}") from e

    ins1, has_dyn = build(_DYN)
    outs = run(ins1)
    outs2 = run(build(_DYN2)[0]) if has_dyn else outs

    for slot, names in op.outputs.items():
        ts, ts2 = outs.get(slot, []), outs2.get(slot, [])
        for i, n in enumerate(names):
            if i >= len(ts) or n == EMPTY_VAR or ts[i] is None:
                continue
            shape = tuple(-1 if d1 != d2 else d1
                          for d1, d2 in zip(ts[i].shape, ts2[i].shape))
            dtype = convert_dtype(ts[i].dtype)
            existing = block.find_var_recursive(n)
            if existing is not None and not existing.is_data:
                existing.shape = shape
                existing.dtype = dtype
            elif existing is None:
                block.create_var(n, shape, dtype)
