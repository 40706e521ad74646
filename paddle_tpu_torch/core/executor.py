"""Scope, places, ``trace_block`` and an eager ``Executor``.

The port's counterpart of ``paddle_tpu/core/executor.py``. The JAX package
traces a whole Program into one jitted XLA step; the port runs each op's
lowering eagerly, in program order, on the executor's device. A training
program's grad and optimizer ops are ops like any other. No jit, megastep,
warm store or telemetry yet.

The device is explicit: ``Executor()`` runs on ``cuda`` and raises when there
is no card. Pass ``CPUPlace()`` (or ``"cpu"``) to run on the CPU.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..framework import Block, Program, Variable, default_main_program
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
    with no card that raises instead of running on the CPU."""
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


def trace_block(block: Block, env: Dict[str, Any], device, seed: int = 0,
                counter: int = 0):
    """Run the ops of ``block`` over ``env`` (name -> tensor), in order, with
    new tensors made on ``device``.

    The single place op lowerings are invoked with real tensors (shape
    inference calls them on meta tensors). ``seed``/``counter`` key each op's
    generator together with its salt, as the JAX package folds its step key.
    """
    device = torch.device(device)
    for op in block.ops:
        d = registry.get(op.type)
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
        # a grad op takes its forward op's salt, so the forward's recompute
        # inside it draws the forward's dropout masks
        salt_name = op.attr("__fwd_out0__") or next(
            (ns[0] for ns in op.outputs.values() if ns and ns[0] != EMPTY_VAR), op.type)
        ctx = LowerCtx(op.attrs, device, seed, counter, stable_salt(salt_name))
        try:
            outs = d.lower(ctx, ins)
        except NotImplementedError:
            raise
        except Exception as e:
            stack = op.creation_stack_str()
            where = f"\nop created at (most recent call last):\n{stack}" if stack else ""
            raise RuntimeError(f"lowering failed for op {op!r}: {e}{where}") from e
        for slot, names in op.outputs.items():
            vals = outs.get(slot, [])
            for i, n in enumerate(names):
                if n == EMPTY_VAR or i >= len(vals) or vals[i] is None:
                    continue
                env[n] = vals[i]
    return env


class Executor:
    """Runs Programs eagerly on one device (``place`` None = the card)."""

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
            trace_block(program.global_block(), env, self.device, seed, counter)
        for n in state_out:
            if n in env:
                scope.set_var(n, env[n])
        fetches = []
        for n in fetch_names:
            if n not in env:
                raise KeyError(f"fetch variable {n!r} was not produced by the "
                               f"program and is not in the feed/scope")
            fetches.append(env[n])
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return fetches
