"""Op registry: type -> (lowering, shape inference).

The port's copy of ``paddle_tpu/core/registry.py``. A lowering is a plain
function on torch tensors, ``lower(ctx, ins) -> outs``, where ins/outs map
slot name -> list of tensors. Kernel choice happens inside the lowering,
by the device of the tensors it is given.

Shape inference runs the lowering itself on ``torch.device("meta")`` tensors
(no data, no memory), with each -1 dim replaced by a sentinel. Inference runs
twice with two coprime sentinels; an output dim is dynamic iff it differs
between the runs. A lowering therefore makes every new tensor on
``ctx.device`` and never reads values (no ``.item()``, no numpy).

The generic ``<op>_grad`` of the JAX package waits for the training slice.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import torch

from ..framework import Block, Operator, convert_dtype

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


class LowerCtx:
    """Per-op lowering context: attrs, the device new tensors go on (the CPU
    unless given), and RNG.

    ``rng(offset)`` returns a ``torch.Generator`` on ``device`` seeded from
    (program seed, run counter, this op's salt + offset): each run of a
    program draws fresh numbers, and two runs with the same counter draw the
    same ones. Under shape inference (``abstract``) it returns None, since a
    meta tensor draws no numbers.
    """

    def __init__(self, attrs: dict, device=None, seed: int = 0, counter: int = 0,
                 salt: int = 0, abstract: bool = False):
        self.attrs = attrs
        self.device = torch.device(device if device is not None else "cpu")
        self.seed = seed
        self.counter = counter
        self._salt = salt
        self.abstract = abstract

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rng(self, offset: int = 0) -> Optional[torch.Generator]:
        if self.abstract:
            return None
        g = torch.Generator(device=self.device)
        s = _mix(_mix(_mix(0, self.seed), self.counter),
                 (self._salt + offset) & 0x7FFFFFFF)
        g.manual_seed(s & 0x7FFFFFFFFFFFFFFF)
        return g


def stable_salt(name: str) -> int:
    """Deterministic salt from a var name (Python hash() is randomized per process)."""
    h = 2166136261
    for c in name.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h & 0x7FFFFFFF


class OpDef:
    def __init__(self, type: str, lower: Callable):
        self.type = type
        self.lower = lower


_REGISTRY: Dict[str, OpDef] = {}


def register(type: str):
    """Decorator: register ``fn(ctx, ins) -> outs`` as the lowering for ``type``."""

    def deco(fn):
        if type in _REGISTRY:
            raise ValueError(f"op type {type!r} already registered")
        _REGISTRY[type] = OpDef(type, fn)
        return fn

    return deco


def simple_op(type: str):
    """Register an op with input slots consumed in sorted-slot order -> single 'Out'.

    The wrapped fn receives ``(ctx, *tensors)`` -- one tensor per input slot
    entry, in sorted slot order -- and returns the single output tensor.
    """

    def deco(fn):
        @functools.wraps(fn)
        def lower(ctx, ins):
            args = [v for s in sorted(ins) for v in ins[s]]
            return {"Out": [fn(ctx, *args)]}

        register(type)(lower)
        return fn

    return deco


def get(type: str) -> OpDef:
    d = _REGISTRY.get(type)
    if d is not None:
        return d
    raise KeyError(
        f"op type {type!r} is not registered in paddle_tpu_torch "
        f"({len(_REGISTRY)} ops registered); the port has this slice's ops only")


# --------------------------------------------------------------------------------------
# Shape inference
# --------------------------------------------------------------------------------------

def infer_shape(op: Operator, block: Block):
    """Infer and create the output variables of ``op`` by running its
    lowering on meta tensors."""
    d = get(op.type)
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
