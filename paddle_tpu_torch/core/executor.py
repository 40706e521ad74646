"""Scope, places, ``trace_block`` and the ``Executor``.

The port's counterpart of ``paddle_tpu/core/executor.py``. The JAX package
traces a whole Program into one jitted XLA step per signature; the port runs
each op's lowering eagerly, in program order, on the executor's device, with
the counterparts of what XLA does to that step:

- a forward op whose generic grad op is in the same block runs once, under
  autograd, and its grad op differentiates the kept graph (XLA's CSE of the
  grad op's ``jax.vjp`` recompute; ``registry.lower_keeping_graph``);
- each run of consecutive ``adam`` (or ``momentum``, ``sgd``, ``lamb``,
  ``lars_momentum``) ops with equal attrs is one multi-tensor update, in
  place (``fuse_all_optimizer_ops`` and the donated state;
  ``ops/multi_tensor.py``);
- each variable is dropped after its last reader (XLA's buffer liveness),
  except the fetches, the feeds and the persistable state.

``run(use_prune=True)`` runs only the ops its fetches need (the JAX
``run``'s prune cache). ``train_from_dataset`` / ``infer_from_dataset`` run
an epoch of a dataset (``dataset_factory.py``): a worker thread parses,
slices and stacks the batches ahead of the steps through a bounded queue
(``_prefetch_batches``: host work only, every copy to the card and every
run on the calling thread), and the steps are ``run`` or, with
``fuse_steps=K``, ``run_fused``.

A control-flow op (``scan``) runs its body, a sub-block of the program,
through ``LowerCtx.block_runner`` (``SubBlockRunner``, the JAX executor's
``block_runner``): the enclosing env with the body's inputs on top, the
run's device, seed and counter. On the card the whole loop is part of the
step's CUDA graph.

On the card, ``Executor.run`` keeps a cache of compiled steps as the JAX
``Executor.run`` does, keyed by (program id, ``_version``, feed signature,
fetch names, seed, scope), each one CUDA graph (``core/graphs.py``): the
first run of a key runs eagerly on a side stream (the warm-up), the second
captures the step and replays it, later runs replay it. The graph's state
tensors are the scope's: the update writes them in place, a state whose
output is a new tensor (a batch norm's MeanOut) is copied back at the end of
the captured step, and a persistable that is only written comes back as a
copy. Before each replay an identity guard copies in any state tensor the
scope rebinds, the feeds are copied into the graph's buffers and the run
counter is written into the graph's counter on the card, from which the
dropout kernels derive their seeds. A program that holds a ``host_rng`` op
(``gaussian_random``, ``uniform_random``: startup programs; ``dpsgd``'s
noise) is not captured;
it runs eagerly on the card, and its first run warns why
(``capture_refusal``). A failed capture or replay raises.
``run_fused`` runs K steps as K replays. ``close()`` drops the graphs.

The device is explicit: ``Executor()`` runs on ``cuda`` and raises when there
is no card. Pass ``CPUPlace()`` (or ``"cpu"``) to run on the CPU, where there
are no graphs. On the card, float32 matmuls and convolutions run in full
float32, not TF32 (``resolve_device``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import queue
import threading
import warnings
import weakref
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework import Block, Program, Variable, default_main_program
from ..ops import multi_tensor
from . import graphs as cuda_graphs
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
    CPU. And cuDNN picks deterministic algorithms: some of its convolution
    gradients add partial sums with atomics, in no fixed order, and a
    training step would not reproduce bit for bit as the JAX package's
    does (VGG-16's f32 step, run twice from one state, parted from
    itself). The flags are PyTorch's process-wide ones."""
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
        torch.backends.cudnn.deterministic = True
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


def owned_tensor(value, device: torch.device) -> torch.Tensor:
    """A tensor on ``device`` that shares no memory with a numpy ``value``
    (the state a program updates in place must not write a caller's array);
    a tensor already on ``device`` is returned as it is."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return tensor_from_numpy(value).to(device, copy=True)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy, a copy (the tensor may be updated in place
    later). numpy has no bfloat16, so bf16 is widened to float32: the values
    are exact, only the dtype differs."""
    if t.dtype == torch.bfloat16:
        return t.detach().float().cpu().numpy()
    a = t.detach().cpu().numpy()
    return a.copy() if t.device.type == "cpu" else a


def materialize_fetches(fetches) -> List[np.ndarray]:
    """Fetches -> numpy: the one place the dataset loops wait for the card
    (a debug print boundary, the epoch's return)."""
    return [to_numpy(f) for f in fetches]


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


#: per block, its last-use tables by (program version, names kept)
_LAST_USES: "weakref.WeakKeyDictionary[Block, dict]" = weakref.WeakKeyDictionary()
_LAST_USES_CAP = 16


def dead_after(block: Block, keep: FrozenSet[str]) -> List[Tuple[str, ...]]:
    """For each op of ``block``, the variables whose last reader or writer
    it is, except those in ``keep``: what ``trace_block`` drops after it.
    Computed once per (program version, ``keep``)."""
    key = (block.program._version, keep)
    tables = _LAST_USES.setdefault(block, {})
    dead = tables.get(key)
    if dead is None:
        last: Dict[str, int] = {}
        for i, op in enumerate(block.ops):
            for n in op.input_arg_names() + op.output_arg_names():
                last[n] = i
        by_op: List[List[str]] = [[] for _ in block.ops]
        for n, i in last.items():
            if n not in keep and n != EMPTY_VAR:
                by_op[i].append(n)
        dead = [tuple(names) for names in by_op]
        if len(tables) >= _LAST_USES_CAP:
            tables.clear()
        tables[key] = dead
    return dead


def trace_block(block: Block, env: Dict[str, Any], device, seed: int = 0,
                counter: int = 0, *, reuse_forward: bool = True,
                group_updates: bool = True, counter_t: Optional[torch.Tensor] = None,
                keep: Optional[FrozenSet[str]] = None, block_runner=None):
    """Run the ops of ``block`` over ``env`` (name -> tensor), in order, with
    new tensors made on ``device``.

    The single place op lowerings are invoked with real tensors (shape
    inference calls them on meta tensors). ``seed``/``counter`` key each op's
    random draws together with its salt, as the JAX package folds its step
    key; ``counter_t`` is the same counter on the card (a one-element int64
    tensor), from which the kernels derive their seeds (``kernel_seed``).

    ``reuse_forward``: a forward op whose generic grad op is in the block
    keeps its autograd graph in a table for this run (``LowerCtx.graphs``,
    emptied when the run ends, however it ends) and its grad op
    differentiates it.
    ``group_updates``: each maximal run of consecutive update ops of one
    kind with equal attrs is one multi-tensor update. Either False gives
    the eager reference path (the grad op recomputes its forward; one
    update op at a time), which the tests and ``chip_smoke.py`` compare
    against.
    ``keep``: when given, each variable not in it is dropped from ``env``
    after its last reader (``dead_after``), so its memory goes back to the
    allocator; the caller keeps its fetches, feeds and persistable state.
    ``block_runner``: what a control-flow op runs its sub-block with
    (``SubBlockRunner``; ``LowerCtx.block_runner``). Without one, a
    program holding such an op raises.
    """
    device = torch.device(device)
    ops = block.ops
    kept = registry.forwards_with_grads(ops) if reuse_forward else frozenset()
    dead = dead_after(block, keep) if keep is not None else None
    graphs: Dict[str, Any] = {}
    try:
        i = 0
        while i < len(ops):
            op = ops[i]
            if group_updates and op.type in multi_tensor.GROUPED:
                end = multi_tensor.run_end(ops, i)
                ins_list = [_op_inputs(o, env) for o in ops[i:end]]
                try:
                    outs = multi_tensor.update(op.type, [o.attrs for o in ops[i:end]],
                                               ins_list)
                except NotImplementedError:
                    raise
                except Exception as e:
                    raise _lowering_failed(op, e) from e
                for o, out in zip(ops[i:end], outs):
                    _store(o, out, env)
            else:
                end = i + 1
                d = registry.get(op.type)
                ins = _op_inputs(op, env)
                # a grad op takes its forward op's salt, so the forward's recompute
                # inside it draws the forward's dropout masks
                out0 = registry.first_output(op)
                salt_name = op.attr("__fwd_out0__") or next(
                    (ns[0] for ns in op.outputs.values() if ns and ns[0] != EMPTY_VAR),
                    op.type)
                ctx = LowerCtx(op.attrs, device, seed, counter, stable_salt(salt_name),
                               graphs=graphs, counter_t=counter_t,
                               block_runner=block_runner)
                try:
                    if (op.type, out0) in kept:
                        outs = registry.lower_keeping_graph(d, ctx, ins, out0)
                    else:
                        outs = d.lower(ctx, ins)
                except NotImplementedError:
                    raise
                except Exception as e:
                    raise _lowering_failed(op, e) from e
                del ins
                _store(op, outs, env)
                del outs
            if dead is not None:
                for j in range(i, end):
                    for n in dead[j]:
                        env.pop(n, None)
            i = end
    finally:
        graphs.clear()
    return env


class SubBlockRunner:
    """The ``block_runner`` of a run of ``program`` over ``env``, as the JAX
    executor's: block ``idx`` runs over the enclosing ``env`` with the
    sub-env on top, on the run's device with its seed, counter and
    ``counter_t``. An op's draws are keyed by its salt, so a body draws the
    same numbers in every iteration (the JAX body's one key: ``lax.scan``
    traces it once; a microbatch scan's dropout masks are the same in every
    microbatch, as there). A body runs with no grouped updates (the update
    ops of a microbatch pipeline sit outside its scan). A body that holds
    generic grad ops (a ``PipelineOptimizer``'s microbatch scan) keeps its
    forward graphs within each run of the body, as ``trace_block`` keeps
    the outer block's (``reuse_forward``, the executor's flag): each
    forward runs once a microbatch. A body without grad ops (an RNN's cell:
    the control-flow op's own grad differentiates through the whole loop)
    keeps none. ``keep`` names what the caller reads from the env it
    returns, and every other variable is dropped after its last reader, so
    only the carries outlive an iteration. The outer env is not written.
    (An object, not a closure that passes itself on: such a closure is a
    reference cycle, which would keep the run's env alive until the
    garbage collector runs.)"""
    __slots__ = ("program", "env", "device", "seed", "counter", "counter_t", "reuse_forward")

    def __init__(self, program: Program, env: Dict[str, Any], device, seed: int = 0,
                 counter: int = 0, counter_t: Optional[torch.Tensor] = None,
                 reuse_forward: bool = True):
        self.program, self.env, self.device = program, env, device
        self.seed, self.counter, self.counter_t = seed, counter, counter_t
        self.reuse_forward = reuse_forward

    def __call__(self, idx: int, sub_env: Dict[str, Any],
                 keep: Optional[FrozenSet[str]] = None):
        merged = dict(self.env)
        merged.update(sub_env)
        return trace_block(self.program.blocks[idx], merged, self.device, self.seed,
                           self.counter, reuse_forward=self.reuse_forward,
                           group_updates=False, counter_t=self.counter_t, keep=keep,
                           block_runner=self)


def capture_refusal(program: Program) -> Optional[str]:
    """Why ``program`` is not captured as a CUDA graph (None: it is),
    decided by op type before it runs: an op that draws from a host-seeded
    generator would replay the captured run's numbers."""
    for blk in program.blocks:
        for op in blk.ops:
            if registry.get(op.type).host_rng:
                return f"op {op.type!r} draws from a host-seeded generator"
    return None


def _debug_line(loop: str, batch: int, names, values) -> None:
    msg = ", ".join(f"{n}={np.asarray(v).reshape(-1)[0]:.6g}" for n, v in zip(names, values))
    print(f"[{loop}] batch {batch}: {msg}")


class _Step:
    """An entry of the executor's cache: one (program, signature) on the
    card. ``refusal`` says why it is not captured (None: it is); ``graph``
    is its CUDA graph once captured, over ``state`` (the scope's tensors it
    reads and updates), ``feeds`` (static buffers) and ``counter`` (the run
    counter on the card); its outputs are the fetches and the persistables
    it only writes."""

    def __init__(self, refusal: Optional[str]):
        self.refusal = refusal
        self.warmed = False
        self.graph: Optional[cuda_graphs.Graph] = None
        self.state: Dict[str, torch.Tensor] = {}
        self.feeds: Dict[str, torch.Tensor] = {}
        self.counter: Optional[torch.Tensor] = None


class Executor:
    """Runs Programs on one device (``place`` None = the card); on the card
    each (program, signature) becomes a replayed CUDA graph. Not thread-safe:
    one thread drives an executor."""

    # False selects the eager reference path (each grad op recomputes its
    # forward; one update op at a time) that tests and chip_smoke.py compare with
    _reuse_forward = True
    _group_updates = True
    # False: no CUDA graphs; every run executes the lowerings eagerly on the card
    _use_graphs = True
    # False: keep every intermediate until the step ends (chip_smoke.py measures
    # the peak memory and the graph pools both ways)
    _free_dead = True
    #: LRU bound on the cached steps (the JAX Executor's _CACHE_CAP)
    _CACHE_CAP = 64

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        self._cache: "collections.OrderedDict[tuple, _Step]" = collections.OrderedDict()
        # (program id, _version, fetches) -> (program, its pruned copy)
        self._prune_cache: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        # the run counter on the card for eager runs (graphs have their own)
        self._counter = (torch.zeros((1,), dtype=torch.int64, device=self.device)
                         if self.device.type == "cuda" else None)

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
        # sub-blocks (scan bodies) read outer persistables too; one written
        # only inside a sub-block would be lost, as in the JAX executor
        top_writes = set(written)
        for sub in program.blocks[1:]:
            for op in sub.ops:
                for n in op.input_arg_names():
                    if n in persistable and n not in produced and n not in read:
                        read.append(n)
                for n in op.output_arg_names():
                    if n in persistable and n not in top_writes:
                        raise RuntimeError(
                            f"persistable var {n!r} is written inside sub-block {sub.idx} "
                            f"but the enclosing control-flow op does not output it; add "
                            f"it to the op's out_names/Out so the write persists")
        for n in fetch_names:
            if n in persistable and n not in produced and n not in read:
                read.append(n)
        return read, written

    def _state(self, program, feeds, fetch_names, scope):
        """(state_in, state_out, name -> state tensor on the device). A state
        value the scope does not hold as a tensor on the device is converted
        to one it owns."""
        state_in, state_out = self._state_names(program, feeds, fetch_names)
        missing = [n for n in state_in if scope.find_var(n) is None]
        if missing:
            raise RuntimeError(
                f"persistable variables {missing[:8]} are uninitialized; run the "
                f"startup program first (exe.run(default_startup_program())).")
        return state_in, state_out, {n: owned_tensor(scope.find_var(n), self.device)
                                     for n in state_in}

    @staticmethod
    def _advance(program: Program, k: int) -> int:
        """The program's run counter before ``k`` runs, advanced by ``k``:
        run c of a program draws from (random_seed, c), whatever else ran."""
        counter = getattr(program, "_rng_run_counter", 0)
        program._rng_run_counter = counter + k
        return counter

    @staticmethod
    def _fetch_names(fetch_list) -> List[str]:
        return [v.name if isinstance(v, Variable) else str(v) for v in (fetch_list or [])]

    def run(self, program: Optional[Program] = None, feed: Optional[dict] = None,
            fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
            return_numpy: bool = True, use_prune: bool = False):
        """Run ``program`` once: persistable state comes from ``scope`` and
        the state it writes goes back there (updated in place where the
        program names one variable for both, as ``ParamOut = Param``: a
        tensor the caller holds changes). Fetches come back as numpy (bf16
        widened to float32, see ``to_numpy``) or, with
        ``return_numpy=False``, as tensors on the device. ``use_prune`` runs
        only the ops the fetches need (``Program._prune``; an eval-style
        fetch runs no update op), from a cache of pruned copies."""
        program = program or default_main_program()
        fetch_names = self._fetch_names(fetch_list)
        scope = scope or global_scope()
        if use_prune and fetch_names:
            program = self._pruned(program, list(feed or {}), fetch_names)
        feeds = {k: as_tensor(v, self.device) for k, v in (feed or {}).items()}
        counter = self._advance(program, 1)
        fetches, replayed = self._run_step(program, feeds, fetch_names, scope, counter)
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return [f.clone() for f in fetches] if replayed else fetches

    def _pruned(self, program: Program, feed_names, fetch_names) -> Program:
        """``program`` pruned to ``fetch_names``, cached by (id, version,
        fetches). The entry keeps the source program: a collected program's
        id can be reused by a new one, which must not get its pruned copy."""
        key = (id(program), program._version, tuple(fetch_names))
        entry = self._prune_cache.get(key)
        if entry is None or entry[0] is not program:
            entry = (program, program._prune(feed_names, fetch_names))
            self._prune_cache[key] = entry
            while len(self._prune_cache) > self._CACHE_CAP:
                self._prune_cache.popitem(last=False)
        else:
            self._prune_cache.move_to_end(key)
        return entry[1]

    def run_fused(self, program: Optional[Program] = None, feeds=None,
                  fetch_list: Optional[Sequence] = None, scope: Optional[Scope] = None,
                  return_numpy: bool = False, stacked_feed: Optional[dict] = None):
        """K training steps in one call, the JAX ``run_fused`` contract:
        ``feeds`` is a list of K per-step feed dicts, or ``stacked_feed`` maps
        each name to a (K, ...) array. The program's run counter advances by
        K (step i draws from counter0 + i, exactly the unfused sequence) and
        each fetch comes back stacked as (K, ...): tensors on the device by
        default, numpy with ``return_numpy``. K = 1 delegates to ``run``.
        On the card step i is a replay of the signature's graph (after its
        warm-up and capture, as ``run``), with step i's feed copied in and
        counter0 + i written first; on the CPU the steps run eagerly.

        Raises ValueError for a program that cannot be captured (why, as the
        JAX ``_fuse_ineligible``), TypeError for anything but a ``Program``
        (``CompiledProgram`` is not ported)."""
        program = program or default_main_program()
        if not isinstance(program, Program):
            raise TypeError(f"run_fused takes a Program, got {type(program).__name__} "
                            f"(CompiledProgram is not ported)")
        reason = capture_refusal(program)
        if reason is not None:
            raise ValueError(f"run_fused: program cannot run fused ({reason}); run it "
                             f"unfused (Executor.run)")
        fetch_names = self._fetch_names(fetch_list)
        scope = scope or global_scope()
        if stacked_feed is not None:
            if not stacked_feed:
                raise ValueError("run_fused needs a non-empty feed")
            k = int(np.shape(next(iter(stacked_feed.values())))[0])
            steps = [{n: v[i] for n, v in stacked_feed.items()} for i in range(k)]
        else:
            steps = list(feeds or [])
            if not steps:
                raise ValueError("run_fused needs a non-empty feeds list")
            k = len(steps)
        if k == 1:
            vals = self.run(program, feed=steps[0], fetch_list=fetch_list, scope=scope,
                            return_numpy=return_numpy)
            return [v[None] for v in vals]
        counter0 = self._advance(program, k)
        stacked: List[torch.Tensor] = []
        for i, step in enumerate(steps):
            feeds_t = {n: as_tensor(v, self.device) for n, v in step.items()}
            fetches, _ = self._run_step(program, feeds_t, fetch_names, scope, counter0 + i)
            if i == 0:
                stacked = [f.new_empty((k,) + tuple(f.shape)) for f in fetches]
            for out, f in zip(stacked, fetches):
                out[i].copy_(f)
        if return_numpy:
            return [to_numpy(t) for t in stacked]
        return stacked

    def close(self):
        """Drop the cached steps: their CUDA graphs and the memory pools they
        hold. The scope keeps its state."""
        self._cache.clear()
        self._prune_cache.clear()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------ datasets

    @staticmethod
    def _prefetch_batches(batches, depth: int, fuse: int = 1, abort=None):
        """Yield the items of ``batches`` in order, produced ahead by one
        worker thread through a queue of ``depth``: the dataset's parse,
        slice and stack overlap the steps. The worker does host work only;
        the consumer (the calling thread) copies to the card and runs.

        ``fuse`` > 1 also stacks every ``fuse`` consecutive batches in the
        worker into ``("mega", {name: (K, ...) array}, K)``; a group whose
        shapes differ, and the trailing partial group, go out as ``("one",
        feed)`` singles. A worker's error is raised in the consumer. When
        the consumer stops early (a step raised), the worker's bounded puts
        give up, and ``abort`` (else the iterator's own ``abort``) and the
        iterator's ``close`` run, so no thread stays parked on a full queue."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def stacked(group):
            shapes = [{n: np.shape(v) for n, v in g.items()} for g in group]
            if len(group) > 1 and all(sh == shapes[0] for sh in shapes[1:]):
                return [("mega", {n: np.stack([np.asarray(g[n]) for g in group])
                                  for n in group[0]}, len(group))]
            return [("one", g) for g in group]

        def worker():
            try:
                if fuse <= 1:
                    for item in batches:
                        if not put(item):
                            return
                else:
                    group = []
                    for item in batches:
                        group.append(item)
                        if len(group) == fuse:
                            for it in stacked(group):
                                if not put(it):
                                    return
                            group = []
                    for g in group:           # the trailing partial group: singles
                        if not put(("one", g)):
                            return
                put(done)
            except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
                put(e)
            finally:
                close = getattr(batches, "close", None)
                if close is not None:
                    close()

        t = threading.Thread(target=worker, daemon=True, name="dataset-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            cb = abort if abort is not None else getattr(batches, "abort", None)
            if cb is not None:
                cb()

    @staticmethod
    def _prefetch_depth(thread, dataset) -> int:
        """The prefetch queue's depth: ``thread``, else the dataset's
        ``thread_num``, at least 2 (double buffering)."""
        return max(2, int(thread) or int(getattr(dataset, "thread_num", 0) or 0))

    def train_from_dataset(self, program=None, dataset=None, scope=None, thread=0,
                           debug=False, fetch_list=None, fetch_info=None, print_period=100,
                           fuse_steps: int = 1, return_numpy: bool = True,
                           skip_batches: int = 0):
        """One epoch over ``dataset`` (``DatasetFactory().create_dataset(...)``),
        its batches produced by the prefetch thread (``_prefetch_batches``,
        queue depth ``thread``, else the dataset's ``thread_num``, at least 2)
        and each run as a step of ``program``.

        ``fuse_steps=K`` > 1 runs each K batches as one ``run_fused`` call
        (stacked in the worker); the trailing partial group runs unfused. A
        program that cannot be captured (``capture_refusal``) warns and runs
        unfused. ``fuse_steps=0`` (the JAX package's autotuner) is not
        ported. Fetches stay on the device: they are read to the host only
        at the ``debug`` print boundaries (every ``print_period`` batches,
        one read per chunk that crosses one) and at the return. Returns the
        last step's fetches (numpy, or tensors with ``return_numpy=False``),
        None when the epoch had no batch. ``skip_batches=N`` passes over the
        first N batches without running them: with the state saved after N
        steps (``io.save_persistables``), the rest of an epoch resumes on
        the exact next batch."""
        if dataset is None:
            raise ValueError("train_from_dataset needs a dataset (use "
                             "DatasetFactory().create_dataset(...))")
        fetch_list = fetch_list or []
        fetch_info = fetch_info or self._fetch_names(fetch_list)
        k = int(fuse_steps)
        if k < 0:
            raise ValueError("fuse_steps must be >= 0 (0 = autotune)")
        if k == 0:
            raise NotImplementedError(
                "fuse_steps=0 consults the JAX package's autotuner (tuning/), which is "
                "not ported yet (ROADMAP queue 1, item 5); pass fuse_steps=K")
        prog = program or default_main_program()
        if k > 1:
            reason = capture_refusal(prog)
            if reason is not None:
                warnings.warn(f"train_from_dataset(fuse_steps={k}): program cannot run "
                              f"fused ({reason}); running unfused", stacklevel=2)
                k = 1
        depth = self._prefetch_depth(thread, dataset)
        batches = dataset._iter_batches()
        abort_cb = getattr(batches, "abort", None)   # before islice hides it
        if skip_batches:
            batches = itertools.islice(batches, int(skip_batches), None)
        period = max(print_period, 1)
        last, last_fused, i = None, False, 0
        loop = self._prefetch_batches(batches, depth, fuse=k, abort=abort_cb)
        with contextlib.closing(loop):     # a step that raises ends the worker now
            for item in loop:
                kind, feed = (item[0], item[1]) if k > 1 else ("one", item)
                if kind == "mega":
                    vals = self.run_fused(prog, stacked_feed=feed, fetch_list=fetch_list,
                                          scope=scope)
                    kk = item[2]
                else:
                    vals = self.run(prog, feed=feed, fetch_list=fetch_list, scope=scope,
                                    return_numpy=False)
                    kk = 1
                hits = [j for j in range(i, i + kk) if j % period == 0] \
                    if debug and fetch_list else []
                if hits:     # one read to the host per chunk that crosses a boundary
                    vals_np = materialize_fetches(vals)
                    for j in hits:
                        _debug_line("train_from_dataset", j, fetch_info,
                                    [v[j - i] for v in vals_np] if kind == "mega"
                                    else vals_np)
                last, last_fused, i = vals, kind == "mega", i + kk
        if last is None:
            return None
        if last_fused:
            last = [v[-1] for v in last]      # the last step's fetches
        return materialize_fetches(last) if return_numpy else list(last)

    def infer_from_dataset(self, program=None, dataset=None, scope=None, thread=0,
                           debug=False, fetch_list=None, fetch_info=None, print_period=100,
                           return_numpy: bool = True):
        """One epoch over ``dataset`` with ``program`` pruned to
        ``fetch_list`` (``run(use_prune=True)``), so no update op runs: the
        fetch list is required. Returns the last batch's fetches; nothing is
        kept of the others (``debug`` prints every ``print_period``)."""
        if dataset is None:
            raise ValueError("infer_from_dataset needs a dataset")
        if not fetch_list:
            raise ValueError(
                "infer_from_dataset needs a non-empty fetch_list: inference prunes the "
                "program to the fetches; without them the full program (including any "
                "optimizer ops) would run")
        fetch_info = fetch_info or self._fetch_names(fetch_list)
        depth = self._prefetch_depth(thread, dataset)
        last = None
        loop = self._prefetch_batches(dataset._iter_batches(), depth)
        with contextlib.closing(loop):
            for i, feed in enumerate(loop):
                last = self.run(program, feed=feed, fetch_list=fetch_list, scope=scope,
                                use_prune=True, return_numpy=False)
                if debug and i % max(print_period, 1) == 0:
                    _debug_line("infer_from_dataset", i, fetch_info, materialize_fetches(last))
        if last is None:
            return None
        return materialize_fetches(last) if return_numpy else list(last)

    # ---------------------------------------------------------------- one step

    def _run_step(self, program, feeds, fetch_names, scope, counter):
        """One step: (fetches, whether they are a graph's outputs, which the
        next replay overwrites)."""
        if not self._captures():
            return self._eager(program, feeds, fetch_names, scope, counter, self._counter), False
        seed = program.random_seed if program.random_seed is not None else 0
        key = (id(program), program._version,
               tuple(sorted((k, tuple(t.shape), str(t.dtype)) for k, t in feeds.items())),
               tuple(fetch_names), seed, id(scope))
        step = self._cache.get(key)
        if step is None:
            step = self._cache[key] = _Step(capture_refusal(program))
            if step.refusal is not None:
                warnings.warn(f"Executor.run: the program is not captured as a CUDA graph "
                              f"({step.refusal}); its runs are eager", stacklevel=3)
            while len(self._cache) > self._CACHE_CAP:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(key)
        if step.refusal is not None:
            return self._eager(program, feeds, fetch_names, scope, counter, self._counter), False
        if not step.warmed:
            step.warmed = True
            return cuda_graphs.warm_up(self.device, lambda: self._eager(
                program, feeds, fetch_names, scope, counter, self._counter)), False
        if step.graph is None:
            self._capture(step, program, feeds, fetch_names, scope)
        elif not self._guard(step, scope):
            # the scope's state changed shape or dtype: a new executable
            del self._cache[key]
            return self._run_step(program, feeds, fetch_names, scope, counter)
        for k, t in feeds.items():
            step.feeds[k].copy_(t)
        step.counter.fill_(counter)
        step.graph.replay()
        fetches, written = step.graph.outputs
        for n, t in written.items():
            scope.set_var(n, t.clone())
        return fetches, True

    def _captures(self) -> bool:
        """Whether runs go through the cache of CUDA graphs: on the card,
        unless ``_use_graphs`` is off."""
        return self._use_graphs and self.device.type == "cuda"

    def _trace(self, program, env, fetch_names, state_in, state_out, counter, counter_t):
        """The program's ops over ``env``, freeing what no later op reads."""
        seed = program.random_seed if program.random_seed is not None else 0
        keep = frozenset(env) | frozenset(fetch_names) | frozenset(state_out) \
            | frozenset(state_in)
        runner = SubBlockRunner(program, env, self.device, seed, counter, counter_t,
                                self._reuse_forward)
        with torch.no_grad():
            trace_block(program.global_block(), env, self.device, seed, counter,
                        reuse_forward=self._reuse_forward, group_updates=self._group_updates,
                        counter_t=counter_t, keep=keep if self._free_dead else None,
                        block_runner=runner)
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch variable {missing[0]!r} was not produced by the "
                           f"program and is not in the feed/scope")

    def _eager(self, program, feeds, fetch_names, scope, counter, counter_t):
        """The step run op by op; the state it writes goes to ``scope``."""
        state_in, state_out, state = self._state(program, feeds, fetch_names, scope)
        env = dict(state)
        env.update(feeds)
        if counter_t is not None:
            counter_t.fill_(counter)
        self._trace(program, env, fetch_names, state_in, state_out, counter, counter_t)
        # detached, so that no kept forward graph outlives the run through the
        # scope (a batch norm's MeanOut made under autograd) or a fetch; a
        # state updated in place is the scope's own tensor already
        for n in state_out:
            if n in env and env[n] is not scope.find_var(n):
                scope.set_var(n, env[n].detach())
        return [env[n].detach() for n in fetch_names]

    def _capture(self, step: _Step, program, feeds, fetch_names, scope):
        """Capture the step as ``step.graph``, over the scope's state tensors
        (rebound in the scope where they were not yet tensors on the card)."""
        state_in, state_out, step.state = self._state(program, feeds, fetch_names, scope)
        for n, t in step.state.items():
            if scope.find_var(n) is not t:
                scope.set_var(n, t)
        step.feeds = {k: t.clone() for k, t in feeds.items()}
        step.counter = torch.zeros((1,), dtype=torch.int64, device=self.device)
        write_only = [n for n in state_out if n not in step.state]

        def body():
            env = dict(step.state)
            env.update(step.feeds)
            self._trace(program, env, fetch_names, state_in, state_out, 0, step.counter)
            with torch.no_grad():
                for n, t in step.state.items():   # the donated state
                    if n in state_out and n in env and env[n] is not t:
                        t.copy_(env[n])
            return [env[n].detach() for n in fetch_names], \
                {n: env[n].detach() for n in write_only if n in env}

        step.graph = cuda_graphs.Graph(self.device, body)

    def _guard(self, step: _Step, scope) -> bool:
        """The identity guard before a replay: a state tensor the scope has
        rebound (``set_var``, a load) is copied into the graph's and the
        scope is rebound to it. False when one changed shape or dtype."""
        for n, t in step.state.items():
            cur = scope.find_var(n)
            if cur is t:
                continue
            if cur is None:
                raise RuntimeError(f"persistable variable {n!r} was erased from the scope")
            src = owned_tensor(cur, self.device)
            if src.shape != t.shape or src.dtype != t.dtype:
                return False
            t.copy_(src)
            scope.set_var(n, t)
        return True
