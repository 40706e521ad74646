"""Scope, places, ``trace_block`` and an eager ``Executor``.

The port's counterpart of ``paddle_tpu/core/executor.py``. The JAX package
traces a whole Program into one jitted XLA step; the port runs each op's
lowering eagerly, in program order, on the executor's device, with the
counterparts of two things XLA does to that step:

- a forward op whose generic grad op is in the same block runs once, under
  autograd, and its grad op differentiates the kept graph (XLA's CSE of the
  grad op's ``jax.vjp`` recompute; ``registry.lower_keeping_graph``);
- each run of consecutive ``adam`` (or ``momentum``) ops with equal attrs is
  one multi-tensor update (``fuse_all_optimizer_ops``;
  ``ops/multi_tensor.py``).

No jit, megastep, warm store or telemetry yet.

The device is explicit: ``Executor()`` runs on ``cuda`` and raises when there
is no card. Pass ``CPUPlace()`` (or ``"cpu"``) to run on the CPU. On the
card, float32 matmuls and convolutions run in full float32, not TF32
(``resolve_device``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework import Block, Program, Variable, default_main_program
from ..ops import multi_tensor
from . import registry
from .registry import EMPTY_VAR, LowerCtx, stable_salt


class CPUPlace:
    """Run on the host CPU."""


class CUDAPlace:
    """Run on CUDA device ``id``."""

    def __init__(self, id=0):
        self.id = id


def resolve_device(place=None) -> torch.device:
    """Place / device spec -> torch.device. ``None`` means the card (``cuda``);
    with no card that raises instead of running on the CPU.

    On the card it also pins float32 precision: cuBLAS and cuDNN compute
    float32 products and convolutions in full float32 (TF32 off for both;
    cuDNN's own default is TF32), as the JAX package computes them on the
    CPU. The flags are PyTorch's process-wide ones."""
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    if isinstance(place, CUDAPlace):
        dev = torch.device("cuda", place.id)
    elif place is None:
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device(place)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested (the default) but torch sees no CUDA "
            f"device; pass CPUPlace() or device='cpu' to run on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class Scope:
    """name -> tensor store."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def var(self, name: str):
        if name not in self._vars:
            self._vars[name] = None
        return self._vars[name]

    def find_var(self, name: str):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        s = self
        while s is not None:
            if name in s._vars:
                return True
            s = s.parent
        return False

    def set_var(self, name: str, value):
        self._vars[name] = value

    def erase(self, name: str):
        self._vars.pop(name, None)

    def var_names(self) -> List[str]:
        return list(self._vars)

    def new_scope(self) -> "Scope":
        return Scope(self)


_global_scope = Scope()
_tls = threading.local()


def global_scope() -> Scope:
    return getattr(_tls, "scope", None) or _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    old = getattr(_tls, "scope", None)
    _tls.scope = scope
    try:
        yield
    finally:
        _tls.scope = old


def tensor_from_numpy(a, dtype_tag=None) -> torch.Tensor:
    """numpy array (or scalar) -> CPU tensor of the same dtype. bfloat16
    arrives either as numpy's ``ml_dtypes`` bfloat16 or as uint16 bits with
    ``dtype_tag="bfloat16"``; both are reinterpreted bit for bit, without
    importing ml_dtypes."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:   # e.g. a view of a JAX array: torch wants its own copy
        a = a.copy()
    if str(a.dtype) == "bfloat16" or dtype_tag == "bfloat16":
        if a.itemsize != 2:
            raise TypeError(f"bfloat16 data must be 2 bytes per element, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def as_tensor(value, device: torch.device) -> torch.Tensor:
    """numpy / tensor / scalar -> tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return tensor_from_numpy(value).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy. numpy has no bfloat16, so bf16 is widened to
    float32: the values are exact, only the dtype differs."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _op_inputs(op, env) -> Dict[str, List[Any]]:
    ins: Dict[str, List[Any]] = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n == EMPTY_VAR:
                vals.append(None)
            elif n in env:
                vals.append(env[n])
            else:
                raise KeyError(
                    f"op {op.type!r}: input variable {n!r} has no value. "
                    f"Feed it, or run the startup program to initialize it.")
        ins[slot] = vals
    return ins


def _store(op, outs, env):
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for i, n in enumerate(names):
            if n == EMPTY_VAR or i >= len(vals) or vals[i] is None:
                continue
            env[n] = vals[i]


def _lowering_failed(op, e):
    stack = op.creation_stack_str()
    where = f"\nop created at (most recent call last):\n{stack}" if stack else ""
    return RuntimeError(f"lowering failed for op {op!r}: {e}{where}")


def trace_block(block: Block, env: Dict[str, Any], device, seed: int = 0,
                counter: int = 0, *, reuse_forward: bool = True,
                group_updates: bool = True):
    """Run the ops of ``block`` over ``env`` (name -> tensor), in order, with
    new tensors made on ``device``.

    The single place op lowerings are invoked with real tensors (shape
    inference calls them on meta tensors). ``seed``/``counter`` key each op's
    generator together with its salt, as the JAX package folds its step key.

    ``reuse_forward``: a forward op whose generic grad op is in the block
    keeps its autograd graph in a table for this run (``LowerCtx.graphs``,
    emptied when the run ends, however it ends) and its grad op
    differentiates it.
    ``group_updates``: each maximal run of consecutive update ops of one
    kind with equal attrs is one multi-tensor update. Either False gives
    the eager reference path (the grad op recomputes its forward; one
    update op at a time), which the tests and ``chip_smoke.py`` compare
    against.
    """
    device = torch.device(device)
    ops = block.ops
    keep = registry.forwards_with_grads(ops) if reuse_forward else frozenset()
    graphs: Dict[str, Any] = {}
    try:
        i = 0
        while i < len(ops):
            op = ops[i]
            if group_updates and op.type in multi_tensor.GROUPED:
                end = multi_tensor.run_end(ops, i)
                ins_list = [_op_inputs(o, env) for o in ops[i:end]]
                try:
                    outs = multi_tensor.update(op.type, op.attrs, ins_list)
                except NotImplementedError:
                    raise
                except Exception as e:
                    raise _lowering_failed(op, e) from e
                for o, out in zip(ops[i:end], outs):
                    _store(o, out, env)
                i = end
                continue
            d = registry.get(op.type)
            ins = _op_inputs(op, env)
            # a grad op takes its forward op's salt, so the forward's recompute
            # inside it draws the forward's dropout masks
            out0 = registry.first_output(op)
            salt_name = op.attr("__fwd_out0__") or next(
                (ns[0] for ns in op.outputs.values() if ns and ns[0] != EMPTY_VAR), op.type)
            ctx = LowerCtx(op.attrs, device, seed, counter, stable_salt(salt_name),
                           graphs=graphs)
            try:
                if (op.type, out0) in keep:
                    outs = registry.lower_keeping_graph(d, ctx, ins, out0)
                else:
                    outs = d.lower(ctx, ins)
            except NotImplementedError:
                raise
            except Exception as e:
                raise _lowering_failed(op, e) from e
            _store(op, outs, env)
            i += 1
    finally:
        graphs.clear()
    return env


class Executor:
    """Runs Programs eagerly on one device (``place`` None = the card)."""

    # False selects the eager reference path (each grad op recomputes its
    # forward; one update op at a time) that tests and chip_smoke.py compare with
    _reuse_forward = True
    _group_updates = True

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)

    @staticmethod
    def _state_names(program: Program, feed: dict, fetch_names=()):
        """Persistable vars read (state_in) / written (state_out) by the program."""
        block = program.global_block()
        persistable = {n for n, v in block.vars.items() if v.persistable}
        read, written = [], []
        produced = set(feed)
        for op in block.ops:
            for n in op.input_arg_names():
                if n in persistable and n not in produced and n not in read:
                    read.append(n)
            for n in op.output_arg_names():
                if n in persistable and n not in written:
                    written.append(n)
                produced.add(n)
        for n in fetch_names:
            if n in persistable and n not in produced and n not in read:
                read.append(n)
        return read, written

    def run(self, program: Optional[Program] = None, feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True):
        """Run ``program`` once: persistable state comes from ``scope`` and
        the state it writes goes back there. Fetches come back as numpy
        (bf16 widened to float32, see ``to_numpy``) or, with
        ``return_numpy=False``, as tensors on the device."""
        program = program or default_main_program()
        fetch_names = [v.name if isinstance(v, Variable) else str(v)
                       for v in (fetch_list or [])]
        scope = scope or global_scope()
        feed = dict(feed or {})

        state_in, state_out = self._state_names(program, feed, fetch_names)
        missing = [n for n in state_in if scope.find_var(n) is None]
        if missing:
            raise RuntimeError(
                f"persistable variables {missing[:8]} are uninitialized; run the "
                f"startup program first (exe.run(default_startup_program())).")
        env = {n: as_tensor(scope.find_var(n), self.device) for n in state_in}
        env.update({k: as_tensor(v, self.device) for k, v in feed.items()})

        # run k of a program draws from (random_seed, k): results are
        # deterministic per program regardless of what else ran
        counter = getattr(program, "_rng_run_counter", 0)
        program._rng_run_counter = counter + 1
        seed = program.random_seed if program.random_seed is not None else 0
        with torch.no_grad():
            trace_block(program.global_block(), env, self.device, seed, counter,
                        reuse_forward=self._reuse_forward,
                        group_updates=self._group_updates)
        # detached, so that no kept forward graph outlives the run through the
        # scope (a batch norm's MeanOut made under autograd) or a fetch
        for n in state_out:
            if n in env:
                scope.set_var(n, env[n].detach())
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch variable {n!r} was not produced by the "
                               f"program and is not in the feed/scope")
            fetches.append(env[n].detach())
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches
