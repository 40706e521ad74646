"""Imperative (dygraph) core: VarBase, the tape tracer and eager autograd.

The port's copy of ``paddle_tpu/dygraph/base.py``. Dygraph ops run the
registry's lowerings at once on ``torch.Tensor``s; the tape records (op
type, attrs, salt, inputs, outputs) and ``backward()`` replays it in reverse
through the ``<type>_grad`` lowerings the static executor uses: one op
library, two modes.

The tape, not torch, tracks gradients: a ``VarBase`` holds a tensor that
does not require grad, and ``no_grad`` is the tape's switch. A forward op
whose grad op is the registry's generic one keeps its autograd graph
(``registry.lower_keeping_graph``) on a table the tape owns, and its grad
op differentiates that graph, as the static executor's ``reuse_forward``
does: each forward lowering runs once a step (BERT's 12 ``fused_attention``
ops launch the forward kernel 12 times a step, not 24). The table is
emptied by ``backward`` and by ``guard``.

Each op's ``LowerCtx`` has a fresh salt; its grad op is given the salt on
its tape entry. Off an executor ``LowerCtx.kernel_seed`` is the host integer
``seed_int(seed, 0, salt)``, so the forward and the backward kernels (and a
recompute) draw the same dropout mask.

Device: ``guard()`` puts new ``VarBase``s on the card (``cuda``) and raises
without one; ``guard(CPUPlace())`` puts them on the CPU. An op's new tensors
go on its inputs' device.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import registry
from ..core.executor import resolve_device, tensor_from_numpy, to_numpy
from ..core.registry import LowerCtx
from ..framework import convert_dtype

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.float16: "float16", torch.bfloat16: "bfloat16",
                torch.int8: "int8", torch.uint8: "uint8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64", torch.bool: "bool"}


class _State(threading.local):
    def __init__(self):
        self.enabled = False
        self.tape: List[dict] = []
        self.taping = True
        self.trace_all = False   # TracedLayer: record even non-diff ops
        self.op_counter = 0
        self.seed = 0
        self.device: Optional[torch.device] = None   # None: the card
        # kept forward graphs, keyed by the tape entry's ``graph_key``
        self.graphs: Dict[str, object] = {}


_state = _State()


def enabled() -> bool:
    return _state.enabled


def _device() -> torch.device:
    """The device new VarBases go on: the guard's, else the card."""
    if _state.device is None:
        _state.device = resolve_device(None)
    return _state.device


@contextlib.contextmanager
def guard(place=None):
    """``with fluid.dygraph.guard():`` (reference dygraph/base.py). ``place``
    None is the card and raises without one; ``CPUPlace()`` the CPU."""
    device = resolve_device(place)
    old = _state.enabled, _state.device
    _state.enabled = True
    _state.device = device
    _state.tape = []
    _state.graphs.clear()
    try:
        yield
    finally:
        _state.enabled, _state.device = old


@contextlib.contextmanager
def no_grad():
    old = _state.taping
    _state.taping = False
    try:
        yield
    finally:
        _state.taping = old


def dtype_name(t: torch.Tensor) -> str:
    return _DTYPE_NAMES[t.dtype]


class VarBase:
    """Eager tensor with an autograd slot (reference imperative/layer.h:55).

    ``value`` is a ``torch.Tensor``; numpy input goes to the guard's device
    with its dtype kept. ``numpy()`` returns a bfloat16 tensor widened to
    float32 (numpy has no bfloat16 here): the values are exact."""

    def __init__(self, value, stop_gradient=False, name=None):
        if isinstance(value, VarBase):
            value = value.value
        if not isinstance(value, torch.Tensor):
            value = tensor_from_numpy(np.asarray(value)).to(_device())
        self.value = value
        self.stop_gradient = stop_gradient
        self.name = name
        self.grad: Optional[torch.Tensor] = None

    # -- info --------------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return dtype_name(self.value)

    def numpy(self):
        return to_numpy(self.value)

    def gradient(self):
        return None if self.grad is None else to_numpy(self.grad)

    def clear_gradient(self):
        self.grad = None

    def detach(self):
        return VarBase(self.value, stop_gradient=True, name=self.name)

    def astype(self, dtype):
        return trace_op("cast", {"X": [self]},
                        {"out_dtype": convert_dtype(dtype)}, ["Out"])["Out"][0]

    def backward(self):
        backward(self)

    def __repr__(self):
        return f"VarBase({self.numpy()!r})"

    # -- arithmetic --------------------------------------------------------------------
    def _bin(self, other, op, reverse=False):
        # the constant in this tensor's dtype, made on its device: no copy
        # from the card to read the dtype
        o = other if isinstance(other, VarBase) else VarBase(
            torch.as_tensor(np.asarray(other), device=self.value.device).to(self.value.dtype),
            stop_gradient=True)
        x, y = (o, self) if reverse else (self, o)
        return trace_op(op, {"X": [x], "Y": [y]}, {"axis": -1}, ["Out"])["Out"][0]

    def __add__(self, o):
        return self._bin(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._bin(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._bin(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._bin(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._bin(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._bin(o, "elementwise_div", reverse=True)

    def __neg__(self):
        return trace_op("scale", {"X": [self]}, {"scale": -1.0}, ["Out"])["Out"][0]


def to_variable(value, name=None, zero_copy=None) -> VarBase:
    """Reference dygraph/base.py:to_variable."""
    return VarBase(value, name=name)


def _ctx(attrs, salt=None, device=None) -> LowerCtx:
    """A LowerCtx on ``device`` (the guard's when None); ``salt`` replays a
    recorded forward salt so a grad lowering of a stochastic op (dropout,
    attention dropout) sees the forward's mask -- the dygraph analog of the
    static executor's ``__fwd_out0__`` mechanism."""
    if salt is None:
        _state.op_counter += 1
        salt = _state.op_counter
    return LowerCtx(attrs, device if device is not None else _device(), seed=_state.seed,
                    salt=salt, graphs=_state.graphs)


def _ins_device(raw_ins):
    return next((v.device for vs in raw_ins.values() for v in vs
                 if isinstance(v, torch.Tensor)), None)


def _keeps_graph(op_type: str, d) -> bool:
    """Whether the op's grad op is the generic one, which can differentiate
    a kept graph (``registry.forwards_with_grads``)."""
    return registry.generic_grad_forward(op_type + "_grad") == op_type and not d.remat


def trace_op(op_type: str, ins: Dict[str, List[VarBase]], attrs: dict,
             out_slots: List[str]) -> Dict[str, List[VarBase]]:
    """Run an op eagerly and record it on the tape (reference Tracer::TraceOp)."""
    d = registry.get(op_type)
    raw_ins = {s: [v.value if v is not None else None for v in vs]
               for s, vs in ins.items()}
    stop_all = all(v is None or v.stop_gradient
                   for vs in ins.values() for v in vs)
    normal = _state.taping and not stop_all and d.grad is not None
    ctx = _ctx(attrs, device=_ins_device(raw_ins))
    graph_key = f"dygraph:{ctx._salt}" if normal and _keeps_graph(op_type, d) else None
    if graph_key is not None:
        outs = registry.lower_keeping_graph(d, ctx, raw_ins, graph_key)
    else:
        with torch.no_grad():
            outs = d.lower(ctx, raw_ins)
    out_vars: Dict[str, List[VarBase]] = {}
    for s in out_slots:
        vals = outs.get(s, [])
        # the tape tracks gradients: what a VarBase holds requires none
        out_vars[s] = [VarBase(v.detach(), stop_gradient=stop_all or d.grad is None)
                       if v is not None else None for v in vals]
    if normal or _state.trace_all:
        _state.tape.append({"type": op_type, "attrs": dict(attrs),
                            "salt": ctx._salt, "graph_key": graph_key,
                            # recorded ONLY for TracedLayer, not autograd:
                            # trace() strips these afterwards
                            "_trace_only": not normal,
                            "ins": {s: list(vs) for s, vs in ins.items()},
                            "outs": {s: list(vs)
                                     for s, vs in out_vars.items()}})
    return out_vars


def backward(loss: VarBase):
    """Reverse tape walk through the registry's grad lowerings (reference
    imperative::BasicEngine). A generic grad op differentiates its forward's
    kept graph when it serves the same input tensors, and otherwise reruns
    the forward lowering with the forward's salt."""
    grads: Dict[int, torch.Tensor] = {id(loss): torch.ones_like(loss.value)}
    try:
        for entry in reversed(_state.tape):
            out_grads_present = False
            grad_ins = {}
            for s, vs in entry["ins"].items():
                grad_ins[s] = [v.value if v is not None else None for v in vs]
            for s, vs in entry["outs"].items():
                grad_ins[s] = [v.value if v is not None else None for v in vs]
                g = [grads.get(id(v)) if v is not None else None for v in vs]
                if any(x is not None for x in g):
                    out_grads_present = True
                    grad_ins[s + "@GRAD"] = g
            if not out_grads_present:
                _state.graphs.pop(entry["graph_key"], None)
                continue
            d = registry.get(entry["type"] + "_grad")
            attrs = dict(entry["attrs"])
            attrs["__fwd_out_slots__"] = sorted(entry["outs"])
            if entry["graph_key"] is not None:
                attrs["__fwd_out0__"] = entry["graph_key"]
            ctx = _ctx(attrs, salt=entry["salt"], device=_ins_device(grad_ins))
            with torch.no_grad():
                result = d.lower(ctx, grad_ins)
            for s, vs in entry["ins"].items():
                gvals = result.get(s + "@GRAD")
                if gvals is None:
                    continue
                for v, g in zip(vs, gvals):
                    if v is None or g is None or v.stop_gradient:
                        continue
                    prev = grads.get(id(v))
                    grads[id(v)] = g if prev is None else prev + g

        # deposit into .grad on the VarBases the tape read (params too)
        seen = set()
        for entry in _state.tape:
            for vs in entry["ins"].values():
                for v in vs:
                    if v is None or id(v) in seen:
                        continue
                    seen.add(id(v))
                    g = grads.get(id(v))
                    if g is not None and not v.stop_gradient:
                        v.grad = g if v.grad is None else v.grad + g
    finally:
        _state.tape = []
        _state.graphs.clear()
