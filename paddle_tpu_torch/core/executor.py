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
fetch names, seed, scope, the autotuner's ``state_token``), each one CUDA
graph (``core/graphs.py``): the
first run of a key runs eagerly on a side stream (the warm-up), the second
captures the step and replays it, later runs replay it. The lowerings'
autotuner decisions (``tuning/``) are made in the warm-up, so a search
never runs inside a capture; an entry whose warm-up made one moves to the
new token, and a decision that changes later gives a new key, so the step
is captured again rather than replayed on a stale route. The graph's state
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

A program with host-table lookups (``ops/host_table.py``) runs the
parameter-server schedule around its step, as the JAX executor's hoisting
does (``_hoisted``): the pulls are host gathers whose rows enter the step as
feeds, the row gradients are extra fetches pushed to the tables on the host
after it. Such a program runs unfused (``_fuse_ineligible``). An eval run
with ``use_prune=True`` pulls only what the pruned program reads and pushes
nothing.

Fault sites (``resilience/faults.py``): ``dispatch`` before a step,
``fetch`` after it, ``compile`` before a graph's capture; disarmed, each
costs one attribute read. The tensor-health watchdog
(``observability/health.py``) checks a step's fetches when
``PADDLE_TPU_OBS_HEALTH`` is on.

Telemetry, as the JAX ``Executor.run`` records it: the flight-recorder
spans ``feed_prep``, ``dispatch``, ``fetch_sync`` and ``journal`` (and
``megastep`` around ``run_fused``), and ``compile`` for the time of a
CUDA-graph capture, the port's compile miss; ``executor_run_seconds`` and
``executor_runs_total``. At a step's first run (its warm-up on the card),
``program_flops`` and the step's argument and output bytes; at its capture,
its graph pool's bytes; the first run is attributed op by op when
attribution is armed (``observability/attribution.py``). Under
``PADDLE_TPU_OBS`` or the ``benchmark`` flag (``flags.py``) a step is timed
synchronously (the ``fetch_sync`` span waits for the card), warm steps feed
the step-time anomaly detector (one window per cache entry, retired with
it) and set the MFU gauges; under ``PADDLE_TPU_OBS`` a ``run`` (or
``megastep``) journal event follows each call and memory is sampled every
``PADDLE_TPU_OBS_MEM_INTERVAL`` steps. With nothing armed a step pays no
synchronisation and no file I/O.

The device is explicit: ``Executor()`` runs on ``cuda`` and raises when there
is no card. Pass ``CPUPlace()`` (or ``"cpu"``) to run on the CPU, where there
are no graphs. On the card, float32 matmuls and convolutions run in full
float32, not TF32 (``resolve_device``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import queue
import threading
import time
import warnings
import weakref
from typing import Any, Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags as _flags
from ..framework import Block, Program, Variable, default_main_program
from ..observability import anomaly as _anomaly
from ..observability import attribution as _attrib
from ..observability import cost as _cost
from ..observability import health as _health
from ..observability import journal as _journal
from ..observability import memory as _memory
from ..observability import timeline as _timeline
from ..observability.metrics import REGISTRY as _OBS
from ..ops import host_table, multi_tensor
from ..resilience import faults as _faults
from .. import tuning as _tuning
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


def tensor_from_numpy(a, dtype_tag=None, share_readonly: bool = False) -> torch.Tensor:
    """numpy array (or scalar) -> CPU tensor of the same dtype. bfloat16
    arrives either as numpy's ``ml_dtypes`` bfloat16 or as uint16 bits with
    ``dtype_tag="bfloat16"``; both are reinterpreted bit for bit, without
    importing ml_dtypes. A read-only array is copied (a tensor over it could
    be written), unless ``share_readonly``: the caller only reads it."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable and not share_readonly:   # e.g. a view of a JAX array
        a = a.copy()
    if str(a.dtype) == "bfloat16" or dtype_tag == "bfloat16":
        if a.itemsize != 2:
            raise TypeError(f"bfloat16 data must be 2 bytes per element, got {a.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def assign_state(scope: Scope, name: str, value, copy: bool = True) -> None:
    """Put ``value`` (tensor or numpy) under ``name``: into the tensor the
    scope already holds, in place, when shape and dtype match -- a captured
    CUDA graph reads that tensor at its address, so nothing is rebound and
    nothing recaptured -- else bind it (a copy of it with ``copy``, so that
    a later in-place update does not write the caller's value)."""
    src = value if isinstance(value, torch.Tensor) else tensor_from_numpy(value)
    cur = scope.find_var(name)
    if isinstance(cur, torch.Tensor) and cur.shape == src.shape and cur.dtype == src.dtype:
        with torch.no_grad():
            cur.copy_(src)
        return
    scope.set_var(name, src.clone() if copy else src)


def host_copy(value) -> torch.Tensor:
    """A CPU tensor holding ``value`` (tensor or numpy), dtype kept, sharing
    no memory with it: taken after the work queued on its device."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    return tensor_from_numpy(np.array(value, copy=True))


def as_tensor(value, device: torch.device) -> torch.Tensor:
    """numpy / tensor / scalar -> tensor on ``device``. A read-only array
    bound for the card (the C serving ABI's feed is a view of the caller's
    buffer) is read in place by the copy to the card: a host copy first
    would cost a fresh allocation's page faults, tens of milliseconds for a
    batch of 128 ImageNet images."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if device.type != "cpu" and isinstance(value, np.ndarray) and not value.flags.writeable:
        with warnings.catch_warnings():
            # torch has no read-only tensors; this one is only copied from
            warnings.simplefilter("ignore", UserWarning)
            return tensor_from_numpy(value, share_readonly=True).to(device)
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
    # under attribution (observability/attribution.py) each op runs in a
    # profiler range of its IR key, and its tensor bytes are counted
    op_bytes = _attrib.annotation()
    check_dtype = _flags.get_flag("check_dtype")
    try:
        i = 0
        while i < len(ops):
            op = ops[i]
            if op_bytes is None:
                end = _run_ops(block, ops, i, env, device, seed, counter, kept, graphs,
                               group_updates, counter_t, block_runner)
            else:
                ir = _attrib.ir_key(op.type, block.idx, i)
                with torch.profiler.record_function(ir):
                    end = _run_ops(block, ops, i, env, device, seed, counter, kept, graphs,
                                   group_updates, counter_t, block_runner)
                names = {n for o in ops[i:end]
                         for n in o.input_arg_names() + o.output_arg_names()}
                op_bytes[ir] = op_bytes.get(ir, 0) + _memory.tensor_bytes(
                    env.get(n) for n in names)
            if check_dtype:
                for o in ops[i:end]:
                    _check_dtypes(block, o, env)
            if dead is not None:
                for j in range(i, end):
                    for n in dead[j]:
                        env.pop(n, None)
            i = end
    finally:
        graphs.clear()
    return env


def _check_dtypes(block: Block, op, env) -> None:
    """``FLAGS_check_dtype``: each output of ``op`` in its declared dtype."""
    for n in op.output_arg_names():
        v, t = block.find_var_recursive(n), env.get(n)
        if v is None or not isinstance(t, torch.Tensor) or n == EMPTY_VAR:
            continue
        if t.dtype != registry.torch_dtype(v.dtype):
            raise TypeError(f"op {op.type!r} wrote {n!r} as {t.dtype} but the program "
                            f"declares {v.dtype} (FLAGS_check_dtype)")


def _run_ops(block, ops, i, env, device, seed, counter, kept, graphs, group_updates,
             counter_t, block_runner) -> int:
    """Run op ``i`` of ``ops`` (with the run of update ops it starts, when
    they are grouped) over ``env``; returns the index after them."""
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
        _store(op, outs, env)
    return end


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
    decided from its ops and their attrs before it runs: an op that draws
    from a host-seeded generator would replay the captured run's numbers,
    one that reads or writes host memory (a host table's in-step pull or
    push) would not run on a replay at all, and an op's own
    ``capture_refusal`` names what it does on the host at each run (a
    ``while`` without ``max_iters`` reads its condition there every
    iteration; a ``print`` prints there), in any block."""
    for blk in program.blocks:
        for op in blk.ops:
            d = registry.get(op.type)
            if d.host_rng:
                return f"op {op.type!r} draws from a host-seeded generator"
            if d.host_io:
                return f"op {op.type!r} reads or writes host memory"
            why = d.capture_refusal(op) if d.capture_refusal is not None else None
            if why is not None:
                return why
    return None


def _debug_line(loop: str, batch: int, names, values) -> None:
    msg = ", ".join(f"{n}={np.asarray(v).reshape(-1)[0]:.6g}" for n, v in zip(names, values))
    print(f"[{loop}] batch {batch}: {msg}")


class _Step:
    """An entry of the executor's cache: one (program, signature). On the
    CPU, and on the card for a program that is not captured, it only marks
    the signature as seen (its first run is the miss); ``refusal`` says why
    it is not captured (None: it is). ``graph`` is its CUDA graph once
    captured, over ``state`` (the scope's tensors it reads and updates),
    ``feeds`` (static buffers) and ``counter`` (the run counter on the
    card); its outputs are the fetches and the persistables it only writes.
    ``cost`` is its FLOPs, counted at the first run."""

    def __init__(self, refusal: Optional[str]):
        self.refusal = refusal
        self.warmed = False
        self.graph: Optional[cuda_graphs.Graph] = None
        self.state: Dict[str, torch.Tensor] = {}
        self.feeds: Dict[str, torch.Tensor] = {}
        self.counter: Optional[torch.Tensor] = None
        self.cost: Optional[_cost.StepCost] = None
        #: the anomaly detector's windows of this entry (retired with it)
        self.windows: set = set()
        #: the warm store's handle until the step's record is offered
        self.ws = None


class _StepRun(collections.namedtuple("_StepRun", "fetches replayed key miss capture end")):
    """What ``_run_step`` did: the fetches, whether they are a graph's
    outputs (which the next replay overwrites), the cache key, whether the
    run was a miss (the signature's first run, or its capture), the
    capture's (start, seconds) when it captured (else None), and, at a
    first run, when the step's own work ended (its telemetry follows: the
    cost count, an attribution's processing)."""

    @property
    def dispatch_start(self) -> Optional[float]:
        """Where the step's own dispatch began: after its capture, if any."""
        return None if self.capture is None else sum(self.capture)


#: per-program gauges, retired with the last cache entry of their label
_PROGRAM_GAUGES = ("program_flops", "program_flops_per_sec", "program_mfu",
                   "program_peak_bytes", "program_argument_bytes", "program_output_bytes",
                   "program_static_peak_bytes", "program_static_peak_ratio")


def _retire_program_gauges_if_dead(prog_id, version) -> None:
    """Retire a program label's gauges unless a live executor still caches a
    step of it: the gauges are process-wide, and a reused CPython id must
    not inherit a dead program's numbers."""
    for exe in list(Executor._instances):
        if any(k[0] == prog_id and k[1] == version
               for k in exe._cache):
            return
    label = f"{prog_id}:v{version}"
    for g in _PROGRAM_GAUGES:
        _OBS.remove_labeled(g, program=label)
    _attrib.retire_program(label)


#: whether this process made the warm store's one startup scan
_WS_PREFETCHED = False

#: the salt a rank's index is mixed into the program seed with (``_seed``)
_RANK_SALT = 0x5EED


def _is_compiled(program) -> bool:
    """A ``CompiledProgram`` (duck-typed: the executor does not import
    ``compiler``)."""
    return program is not None and hasattr(program, "dist_strategy") \
        and hasattr(program, "build_strategy")


class _DataParallel:
    """The data-parallel run in progress: the bound group of the data axis
    (None at a world of 1 without a process group) and its size."""
    __slots__ = ("group", "size", "rank", "key")

    def __init__(self, group, size: int):
        self.group, self.size = group, int(size)
        self.rank = group.rank if group is not None else 0
        self.key = (self.size, self.rank, group.backend if group is not None else None)

    def reduce_fetch(self, name, t, block):
        """A fetch as the JAX explicit path returns it: a batch-carrying one
        (declared dim 0 -1, or the local rows 1/size of the declared ones)
        all-gathered along dim 0, any other float averaged over the ranks
        (a fetched loss is the global-batch mean on every rank), the rest
        and the persistable state as they are."""
        if self.group is None or not isinstance(t, torch.Tensor):
            return t
        from ..ops import collective as _coll
        v = block.find_var_recursive(name)
        if v is not None and v.persistable:
            return t
        d0 = v.shape[0] if v is not None and len(v.shape) else None
        local0 = t.shape[0] if t.dim() else None
        if local0 is not None and (d0 == -1 or (isinstance(d0, int) and d0 > 0
                                                and local0 * self.size == d0)):
            return _coll.all_gather(t, self.group, 0)
        if t.is_floating_point():
            return _coll.all_reduce_sum(t, self.group) / self.size
        return t


def _warmstore_armed() -> bool:
    """``PADDLE_TPU_WARMSTORE`` set: read before any import of ``warmstore``,
    so a disarmed process never loads the package."""
    return bool(os.environ.get("PADDLE_TPU_WARMSTORE"))


def _feed_batch(program: Program, feeds: Dict[str, torch.Tensor]) -> int:
    """The batch a run's -1 dims stand for: dim 0 of the first feed whose
    variable declares it -1 (1 when none does)."""
    block = program.global_block()
    for n, t in feeds.items():
        v = block.find_var_recursive(n)
        if v is not None and v.shape and v.shape[0] == -1 and t.dim() > 0:
            return int(t.shape[0])
    return 1


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

    #: the live executors (the black box's ``executors`` section, and whether
    #: a program label's gauges still have an owner)
    _instances: "weakref.WeakSet[Executor]" = weakref.WeakSet()

    def __init__(self, place=None):
        self.place = place
        self.device = resolve_device(place)
        from ..observability import slo as _slo
        _slo.maybe_arm()    # one env read when PADDLE_TPU_OBS_SLO is unset
        Executor._instances.add(self)
        self._obs_steps = 0
        # what the last miss saw, for the black box
        self._last_miss: Optional[dict] = None
        # the steps by (program, signature); one run without CUDA graphs (the
        # CPU, or _use_graphs off) is an entry too, refused, so that its
        # first run is the miss
        self._cache: "collections.OrderedDict[tuple, _Step]" = collections.OrderedDict()
        # (program id, _version, fetches) -> (program, its pruned copy)
        self._prune_cache: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        # (program id, _version) -> (program, hoisted copy, pulls, pushes)
        self._hoist_cache: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        # the run counter on the card for eager runs (graphs have their own)
        self._counter = (torch.zeros((1,), dtype=torch.int64, device=self.device)
                         if self.device.type == "cuda" else None)
        # (program id, version, run intent) -> (program, findings) of the gate
        self._verified: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        # the data-parallel run in progress (``_run_compiled``), else None
        self._dp: Optional[_DataParallel] = None
        # the process groups whose first collective this executor made
        self._dp_warm: set = set()

    def _maybe_verify(self, program: Program, feed_names, fetch_names, feed_shapes=None,
                      fuse_k=None) -> None:
        """The ``PADDLE_TPU_VALIDATE=off|warn|raise`` gate, called only at a
        signature's miss, before its warm-up and its capture (default off:
        unset costs one environment read a miss, nothing a replay).
        Findings go to the journal and the metrics either way; ``warn``
        warns of them, ``raise`` raises on errors before any kernel is
        launched. ``PADDLE_TPU_MEM_BUDGET`` (bytes, K/M/G/T suffixes) adds
        the static peak-memory planner (PT05x) with the batch read off the
        feed shapes; a budget alone arms the gate in warn mode, and a typo
        in either variable raises. A program is verified once per version
        and intent; a retry of a failing program (which never reaches the
        cache of steps) re-raises from the memo."""
        import os
        mode = _journal.mode_env("PADDLE_TPU_VALIDATE")
        budget_raw = os.environ.get("PADDLE_TPU_MEM_BUDGET")
        if mode == "off" and not budget_raw:
            return
        from .. import analysis
        mem_budget = None
        if budget_raw:
            try:
                mem_budget = analysis.parse_bytes(budget_raw)
            except ValueError:
                raise ValueError(
                    f"PADDLE_TPU_MEM_BUDGET={budget_raw!r} is not a byte count (use an "
                    f"int or a K/M/G/T suffix)") from None
        if mode == "off":
            # an exported budget must never be silently inert
            mode = "warn"
        # the batch matters only to the memory planner: without a budget a
        # new feed shape must not re-verify
        batch = (analysis.infer_batch(program, feed_shapes)
                 if feed_shapes and mem_budget is not None else None)
        vkey = (id(program), program._version, tuple(sorted(feed_names)),
                tuple(fetch_names), mem_budget, batch, fuse_k)
        prev = self._verified.get(vkey)
        if prev is not None and prev[0] is program:
            diags = prev[1]
            counts = analysis.count_by_severity(diags)
        else:
            t0 = time.perf_counter()
            diags = analysis.verify(program, feed_names=feed_names, fetch_names=fetch_names,
                                    mem_budget=mem_budget, batch=batch, fuse_k=fuse_k)
            # a miss-path span (never per step): the goodput ledger's verify cause
            _timeline.record_span("verify", t0, time.perf_counter() - t0,
                                  program=id(program))
            self._verified[vkey] = (program, diags)
            while len(self._verified) > self._CACHE_CAP:
                self._verified.popitem(last=False)
            counts = analysis.count_by_severity(diags)
            for sev, n in counts.items():
                if n:
                    _OBS.counter("verifier_findings_total",
                                 "static-analysis findings by severity", severity=sev).inc(n)
            _journal.emit({"event": "verify", "program": id(program),
                           "version": program._version, "mode": mode, **counts,
                           "findings": [d.to_dict() for d in diags[:50]]})
        errors = [d for d in diags if d.severity == analysis.Severity.ERROR]
        if mode == "raise" and errors:
            raise analysis.VerificationError(
                "program verification failed (PADDLE_TPU_VALIDATE=raise):\n"
                + analysis.format_diagnostics(errors, with_stack=True), diags)
        if counts["error"] or counts["warn"]:   # info stays in the journal
            warnings.warn(f"paddle_tpu_torch verifier: {counts['error']} error(s), "
                          f"{counts['warn']} warning(s) in program "
                          f"{id(program)}:v{program._version}:\n"
                          + analysis.format_diagnostics(diags, with_stack=False),
                          stacklevel=4)

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

    def _undo_point(self, program, feed, fetch_names, scope, steps) -> Optional[dict]:
        """Copies of the state the step writes, taken only while an ``exc``
        fault may fire at ``fetch`` for one of ``steps`` (else None). The
        step updates the scope in place, so a fault raised after it puts
        this state back (``_fire_fetch``): the guardian's retry then starts
        from the state before the step and applies its update once."""
        if not any(_faults.may_raise("fetch", s) for s in steps):
            return None
        written = self._state_names(program, feed, fetch_names)[1]
        return {n: (v.clone() if isinstance(v, torch.Tensor) else v)
                for n in written for v in [scope.find_var(n)]}

    @staticmethod
    def _fire_fetch(steps, label, undo, scope) -> None:
        """The ``fetch`` fault site of each of ``steps``; a fault it raises
        first restores ``undo`` into the scope's tensors (in place: a
        captured graph keeps reading them)."""
        try:
            for s in steps:
                _faults.fire("fetch", s, program=label)
        except BaseException:
            for n, v in (undo or {}).items():
                if v is None:
                    scope.erase(n)
                else:
                    assign_state(scope, n, v, copy=False)
            raise

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
        if _is_compiled(program):
            return self._run_compiled(
                program, [feed or {}], scope,
                lambda p: self.run(p, feed, fetch_list, scope, return_numpy, use_prune))
        t_feed = time.perf_counter()
        program = program or default_main_program()
        fetch_names = self._fetch_names(fetch_list)
        scope = scope or global_scope()
        label = f"{id(program)}:v{program._version}"
        feed = dict(feed or {})
        # the run counter stays the caller's program's across the hoisted
        # copy (a restore or a retry sets that one); a pruned copy keeps its own
        counted = program
        _, hoisted, pulls, pushes = self._hoisted(program)
        if pulls:
            program = hoisted
        if use_prune and fetch_names:
            program = counted = self._pruned(program, list(feed), fetch_names)
        host_pushes = []
        if pulls:
            # only the pulls the (possibly pruned) program reads: an eval of
            # an unrelated branch neither needs the ids nor pays the gather
            consumed = set(fetch_names)
            for op in program.global_block().ops:
                consumed.update(op.input_arg_names())
            feed = host_table.run_pulls([p for p in pulls if p[2] in consumed], feed)
            # pushes train the tables: never on a pruned (eval) run
            host_pushes = [] if use_prune else pushes
        n_user = len(fetch_names)
        if host_pushes:
            fetch_names = fetch_names + [g for _, _, g, _ in host_pushes
                                         if g not in fetch_names]
        feeds = {k: as_tensor(v, self.device) for k, v in feed.items()}
        counter = self._advance(counted, 1)
        _timeline.record_span("feed_prep", t_feed, time.perf_counter() - t_feed,
                              step=counter, program=label)
        timed = _journal.enabled() or _flags.get_flag("benchmark")
        # a stall at the dispatch fault site is part of the step's time (the
        # anomaly detector's), though not of its dispatch span
        t_run = time.perf_counter()
        undo = None
        if _faults._active:
            # before the launch: nothing ran, a retry is clean
            _faults.fire("dispatch", counter, program=label)
            undo = self._undo_point(program, feeds, fetch_names, scope, [counter])
        with self._run_event(program):
            # read inside the record event: its entry is the profiler's, not the step's
            t_launch = time.perf_counter()
            r = self._run_step(program, feeds, fetch_names, scope, counter)
            t_disp = r.dispatch_start or t_launch
            t_end = r.end or time.perf_counter()
            _timeline.record_span("dispatch", t_disp, t_end - t_disp, step=counter,
                                  program=label)
            if timed:
                # journaled and benchmarked timings are step wall time, not
                # the time to enqueue it
                with _timeline.phase("fetch_sync", step=counter, program=label):
                    self._sync()
        run_s = (t_end if r.end else time.perf_counter()) - (r.dispatch_start or t_run)
        fetches, replayed = r.fetches, r.replayed
        self._step_telemetry(program, label, r, run_s, timed, counter, 1, feeds,
                             fetch_names[:n_user], scope)
        if _faults._active:
            self._fire_fetch([counter], label, undo, scope)
            written = self._state_names(program, feeds, fetch_names)[1]
            fetches = _faults.corrupt_step(counter, fetch_names, fetches,
                                           {n: scope.find_var(n) for n in written},
                                           program=label)
        hmode = _health.mode()
        if hmode != "off":
            named = list(zip(fetch_names, fetches))[:n_user]
            if _health.include_state():
                written = self._state_names(program, feeds, fetch_names)[1]
                named += [(n, scope.find_var(n)) for n in written]
            _health.check(named, label, where="executor", health_mode=hmode)
        if _flags.get_flag("check_nan_inf"):
            self._check_nan_inf(program, feeds, fetch_names, scope)
        if host_pushes:
            fetched = dict(feed)
            fetched.update(zip(fetch_names, fetches))
            host_table.run_pushes(host_pushes, fetched)
            fetches = fetches[:n_user]
        if return_numpy:
            return [to_numpy(f) for f in fetches]
        return [f.clone() for f in fetches] if replayed else fetches

    def _hoisted(self, program: Program):
        """``(program, hoisted copy, pulls, pushes)`` of ``hoist_host_pulls``,
        cached by (id, version): the step path, ``_fuse_ineligible`` and the
        graph cache (keyed by the hoisted copy) share one hoist a version."""
        key = (id(program), program._version)
        entry = self._hoist_cache.get(key)
        if entry is None or entry[0] is not program:
            entry = (program,) + host_table.hoist_host_pulls(program)
            self._hoist_cache[key] = entry
            while len(self._hoist_cache) > self._CACHE_CAP:
                self._hoist_cache.popitem(last=False)
        else:
            self._hoist_cache.move_to_end(key)
        return entry

    def _fuse_ineligible(self, program: Program) -> Optional[str]:
        """Why ``program`` cannot run fused (None: it can): a host-table
        program keeps its pull, step, push schedule a step (the JAX reason),
        and a program that is not captured has no graph to replay."""
        _, _, pulls, pushes = self._hoisted(program)
        if pulls or pushes:
            return "host-table pulls/pushes (PS schedule)"
        return capture_refusal(program)

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
        counter0 + i written first; on the CPU the steps run eagerly. A
        ``CompiledProgram`` runs its data-parallel step K times (each rank
        feeding its rows of each step).

        Raises ValueError for a program that cannot run fused (why:
        ``_fuse_ineligible``, the JAX reasons; a collective over gloo is
        not captured), TypeError for anything but a ``Program`` or a
        ``CompiledProgram``."""
        if _is_compiled(program):
            first = (list(feeds or [])[:1] if stacked_feed is None else
                     [{n: v[0] for n, v in stacked_feed.items()}])
            return self._run_compiled(
                program, first, scope,
                lambda p: self.run_fused(p, feeds, fetch_list, scope, return_numpy,
                                         stacked_feed))
        program = program or default_main_program()
        if not isinstance(program, Program):
            raise TypeError(f"run_fused takes a Program or a CompiledProgram, got "
                            f"{type(program).__name__}")
        reason = self._fuse_ineligible(program)
        if reason is not None:
            raise ValueError(f"run_fused: program cannot run fused ({reason}); run it "
                             f"unfused (fuse_steps=1 / Executor.run)")
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
        label = f"{id(program)}:v{program._version}"
        substeps = [counter0 + i for i in range(k)]
        t_run = time.perf_counter()
        undo = None
        if _faults._active:
            _faults.fire("dispatch", counter0, program=label)
            undo = self._undo_point(program, steps[0], fetch_names, scope, substeps)
        stacked: List[torch.Tensor] = []
        timed = _journal.enabled() or _flags.get_flag("benchmark")
        miss, capture, feeds0 = False, None, None
        with self._run_event(program):
            t_launch = time.perf_counter()
            for i, step in enumerate(steps):
                feeds_t = {n: as_tensor(v, self.device) for n, v in step.items()}
                r = self._run_step(program, feeds_t, fetch_names, scope, counter0 + i, k)
                miss, capture = miss or r.miss, r.capture or capture
                if i == 0:
                    stacked = [f.new_empty((k,) + tuple(f.shape)) for f in r.fetches]
                    feeds0 = feeds_t
                for out, f in zip(stacked, r.fetches):
                    out[i].copy_(f)
            # a capture in the first call is the compile span's, not the dispatch's
            t_disp = t_launch if capture is None else sum(capture)
            _timeline.record_span("dispatch", t_disp, time.perf_counter() - t_disp,
                                  step=counter0, program=label, k=k)
            if timed:
                with _timeline.phase("fetch_sync", step=counter0, program=label):
                    self._sync()
        # the container of the call's dispatch and wait (never summed by the ledger)
        _timeline.record_span("megastep", t_disp, time.perf_counter() - t_disp,
                              step=counter0, program=label, k=k)
        run_s = time.perf_counter() - (t_run if capture is None else t_disp)
        self._step_telemetry(program, label, _StepRun(None, True, r.key, miss, capture, None),
                             run_s, timed, counter0, k, feeds0, fetch_names, scope)
        if _faults._active:
            # as the JAX run_fused: each substep's fetch site, then its
            # corruption, on its own row of the stacked fetches
            self._fire_fetch(substeps, label, undo, scope)
            written = self._state_names(program, steps[0], fetch_names)[1]
            state = {n: scope.find_var(n) for n in written}
            for i, c in enumerate(substeps):
                rows = [t[i] for t in stacked]
                for t, old, new in zip(stacked, rows,
                                       _faults.corrupt_step(c, fetch_names, rows, state,
                                                            program=label)):
                    if new is not old:
                        t[i].copy_(new)
        hmode = _health.mode()
        if hmode != "off":
            _health.check(list(zip(fetch_names, stacked)), label, where="executor",
                          health_mode=hmode)
        if _flags.get_flag("check_nan_inf"):
            self._check_nan_inf(program, steps[0], fetch_names, scope)
        if return_numpy:
            return [to_numpy(t) for t in stacked]
        return stacked

    def _run_compiled(self, cp, feeds: List[dict], scope, call):
        """Run a ``CompiledProgram``: ``call(program)`` on the program to run
        (the ``run`` or ``run_fused`` of the caller) under the strategy.

        Without a strategy it is the wrapped program's run. With one, as the
        JAX explicit data-parallel path: the strategy checked
        (``check_supported``), the gradient sync inserted
        (``comm.sync_program(..., explicit=True)``), under
        ``ReduceStrategy.Reduce`` the ZeRO copy (``compiler.zero_program``)
        and the state split into this rank's blocks, the residuals zeroed,
        the feeds checked at a new signature (each rank feeds its rows of
        dim 0, the same count on every rank), the data axis bound to the
        world group, the seed folded with the rank and the fetches reduced
        (``_DataParallel``). Under NCCL the step is captured with its
        collectives, after one warm-up collective makes the communicator;
        over gloo ``capture_refusal`` keeps it eager."""
        from .. import comm as _comm
        from .. import compiler as _compiler
        from ..ops import collective as _coll
        from ..parallel import env as _penv
        ds = cp.dist_strategy
        program = cp.program
        if ds is None:
            return call(program)
        ds.check_supported()
        size = int(cp.mesh.get(ds.data_axis, 1))
        group = None
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            group = _coll.world_group(ds.data_axis)
            if group.backend == "nccl" and self.device != _penv.device():
                raise RuntimeError(
                    f"data parallel over NCCL: this rank's device is {_penv.device()}, "
                    f"the executor's {self.device}")
            if group.backend == "nccl" and id(dist.group.WORLD) not in self._dp_warm:
                # the communicator exists before a step is captured
                dist.all_reduce(torch.zeros((1,), device=self.device))
                torch.cuda.synchronize(self.device)
                self._dp_warm.add(id(dist.group.WORLD))
        _comm.sync_program(program, cp, explicit=True)
        run_prog = _compiler.zero_program(cp, program) if cp.zero_mode() else program
        scope = scope or global_scope()
        dp = _DataParallel(group, size)
        self._shard_state(cp, run_prog, scope, dp)
        self._check_dp_feeds(cp, run_prog, feeds, dp)
        prev = self._dp
        self._dp = dp
        try:
            with _coll.bind({ds.data_axis: group} if group is not None else {},
                            data_axis=ds.data_axis):
                if run_prog is program:
                    return call(run_prog)
                run_prog._rng_run_counter = getattr(program, "_rng_run_counter", 0)
                try:
                    return call(run_prog)
                finally:
                    program._rng_run_counter = run_prog._rng_run_counter
        finally:
            self._dp = prev

    def _shard_state(self, cp, program, scope, dp: _DataParallel) -> None:
        """This rank's blocks of the state ``cp.state_sharding`` splits: a
        ZeRO-sharded variable the scope holds whole (from the startup program
        or a single-process load) is replaced by block ``rank`` of its shard
        dim; an error-feedback residual the scope lacks, or holds at another
        shape, becomes zeros of (1, *grad shape)."""
        from ..comm.compress import is_residual
        gb = program.global_block()
        key = (id(program), program._version, cp.strategy_signature(), dp.size)
        if cp._split is None or cp._split[0] != key:
            cp._split = (key, [(n, sh) for n, v in gb.vars.items() if v.persistable
                               for sh in [cp.state_sharding(n)] if sh])
        for n, (dim, ndp) in cp._split[1]:
            v = gb.vars[n]
            cur = scope.find_var(n)
            if is_residual(n):
                want = (1,) + tuple(v.shape[1:])
                if cur is None or tuple(cur.shape) != want:
                    scope.set_var(n, torch.zeros(want, dtype=registry.torch_dtype(v.dtype),
                                                 device=self.device))
                continue
            if cur is None or ndp <= 1 or tuple(cur.shape) != tuple(v.shape):
                continue
            t = owned_tensor(cur, self.device)
            per = t.shape[dim] // ndp
            scope.set_var(n, t.narrow(dim, dp.rank * per, per).clone())

    def _check_dp_feeds(self, cp, program, feeds: List[dict], dp: _DataParallel) -> None:
        """The feed check of the JAX ``Executor.run``: a feed whose spec
        splits dim 0 over the data axis has one on every rank, and (at a
        signature not seen before, one small all-gather) the same rows on
        every rank: each rank feeds its slice, global / size rows."""
        if not feeds or not feeds[0]:
            return
        ds = cp.dist_strategy
        gb = program.global_block()
        rows = []
        for k, v in sorted(feeds[0].items()):
            var = gb.find_var_recursive(k)
            ndim = len(np.shape(v))
            spec = ds.data_spec(k, len(var.shape) if var is not None else ndim)
            if not spec or spec[0] != ds.data_axis:
                continue
            if ndim == 0:
                raise ValueError(f"feed {k!r} is a scalar but its spec splits dim 0 over "
                                 f"{ds.data_axis!r}")
            rows.append(int(np.shape(v)[0]))
        if dp.group is None or dp.size <= 1 or not rows:
            return
        sig = (id(cp), tuple(rows))
        seen = getattr(self, "_dp_feed_sigs", None)
        if seen is None:
            seen = self._dp_feed_sigs = set()
        if sig in seen:
            return
        from ..ops import collective as _coll
        dev = self.device if dp.group.backend == "nccl" else torch.device("cpu")
        mine = torch.tensor(rows, dtype=torch.int64, device=dev)
        allr = _coll.stack_gather(mine, dp.group).cpu()
        if not bool((allr == allr[0]).all()):
            raise ValueError(
                f"data parallel: the ranks feed different row counts "
                f"{allr[:, 0].tolist()} -- each rank feeds its slice of the global batch "
                f"(global / {dp.size} rows of a dp-split dim 0)")
        seen.add(sig)

    def _run_event(self, program):
        """``FLAGS_profile_executor``: a ``fluid.profiler`` event around a run."""
        if not _flags.get_flag("profile_executor"):
            return contextlib.nullcontext()
        from .. import profiler as _profiler
        return _profiler.record_event(f"executor_run_v{program._version}")

    def _step_telemetry(self, program, label, r: _StepRun, run_s, timed, step0, k, feeds,
                        fetch_names, scope) -> None:
        """After a call of ``k`` steps that took ``run_s`` from its dispatch:
        the run histogram and counter; when ``timed``, the anomaly detector
        (warm calls only) and the cost gauges; under ``PADDLE_TPU_OBS`` the
        interval memory sample and the ``run`` / ``megastep`` event."""
        _OBS.histogram("executor_run_seconds",
                       "Executor.run step wall time from its dispatch").observe(run_s)
        _OBS.counter("executor_runs_total", "Executor.run calls").inc(k)
        per_step = run_s / k
        step = self._cache.get(r.key) if timed else None
        if step is not None:
            if not r.miss:
                # a K-step call's amortized time has a window of its own
                window = r.key if k == 1 else r.key + (("fused", k),)
                step.windows.add(window)
                _anomaly.DETECTOR.observe(label, per_step, key=window)
            if step.cost is not None:
                _cost.update_cost_gauges(step.cost, per_step, label)
        if not _journal.enabled():
            return
        self._obs_steps += 1
        if self._obs_steps % _memory.sample_interval() == 0:
            _memory.sample_device_memory("interval", self.device, scope)
        with _timeline.phase("journal", step=step0, program=label):
            ev = {"event": "run" if k == 1 else "megastep", "program": id(program),
                  "version": program._version, "cache": "miss" if r.miss else "hit",
                  "compile_ms": (round(r.capture[1] * 1e3, 3) if r.capture is not None
                                 else None),
                  "run_ms": round(run_s * 1e3, 3),
                  "feed": {n: [list(t.shape), str(t.dtype)[len("torch."):]]
                           for n, t in (feeds or {}).items()},
                  "fetch": list(fetch_names)}
            if k > 1:
                ev.update(k=k, step0=step0, amortized_ms=round(per_step * 1e3, 3))
            _journal.emit(ev)

    def _check_nan_inf(self, program, feed, fetch_names, scope) -> None:
        """``FLAGS_check_nan_inf``: raise if the run left a NaN or Inf in a
        floating state tensor it wrote."""
        written = self._state_names(program, feed, fetch_names)[1]
        vals = {n: scope.find_var(n) for n in written}
        bad = [n for n, v in vals.items() if isinstance(v, torch.Tensor)
               and v.is_floating_point() and not bool(torch.isfinite(v).all())]
        if bad:
            raise FloatingPointError(f"NaN/Inf detected in state vars {bad[:5]} after run "
                                     f"(FLAGS_check_nan_inf)")

    def debug_snapshot(self) -> dict:
        """The black box's view: the cached steps' keys, and what the last
        miss saw (feeds, fetches, the capture's time and pool)."""
        steps = list(self._cache.items())
        info = {"place": self.device.type if self.place is None else str(self.place),
                "cached_steps": len(steps),
                "programs": [{"program": f"{k[0]}:v{k[1]}", "key": repr(k)[:400],
                              "captured": st.graph is not None} for k, st in steps]}
        if self._last_miss is not None:
            info["last_miss"] = dict(self._last_miss)
        return info

    def close(self):
        """Drop the cached steps: their CUDA graphs and the memory pools they
        hold, their anomaly windows and, when no live executor still caches
        their program, their gauges. The scope keeps its state."""
        for key in list(self._cache):
            self._drop(key)
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
        program that cannot run fused (``_fuse_ineligible``: not captured, or
        host-table pulls and pushes) warns and runs unfused. ``fuse_steps=0``
        consults the autotuner's ``fuse_steps.k`` choice, keyed by the first
        batch's feed signature and the fetch count (``_resolve_fuse_steps``):
        under ``PADDLE_TPU_TUNE=search`` with no decision yet, the epoch
        measures the candidate K on its own batches and persists the winner
        (``_fused_search_epoch``; every step of the search is a real training
        step, so the result is the fixed-K run's). Fetches stay on the device: they are read to the host only
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
        prog = program or default_main_program()
        if k != 1:
            reason = self._fuse_ineligible(prog)
            if reason is not None:
                warnings.warn(f"train_from_dataset(fuse_steps={fuse_steps}): program "
                              f"cannot run fused ({reason}); running unfused", stacklevel=2)
                k = 1
        depth = self._prefetch_depth(thread, dataset)
        batches = dataset._iter_batches()
        abort_cb = getattr(batches, "abort", None)   # before islice hides it
        if skip_batches:
            batches = itertools.islice(batches, int(skip_batches), None)
        search_params = None
        if k == 0:
            k, batches, search_params = self._resolve_fuse_steps(batches, fetch_list)
        period = max(print_period, 1)
        state = {"last": None, "fused": False, "i": 0}

        def step_cb(vals, kk, fused):
            i = state["i"]
            hits = [j for j in range(i, i + kk) if j % period == 0] \
                if debug and fetch_list else []
            if hits:     # one read to the host per chunk that crosses a boundary
                vals_np = materialize_fetches(vals)
                for j in hits:
                    _debug_line("train_from_dataset", j, fetch_info,
                                [v[j - i] for v in vals_np] if fused else vals_np)
            state["last"], state["fused"], state["i"] = vals, fused, i + kk

        if search_params is not None:
            self._fused_search_epoch(prog, batches, depth, fetch_list, scope, search_params,
                                     step_cb, abort=abort_cb)
        else:
            loop = self._prefetch_batches(batches, depth, fuse=k, abort=abort_cb)
            with contextlib.closing(loop):     # a step that raises ends the worker now
                for item in loop:
                    kind, feed = (item[0], item[1]) if k > 1 else ("one", item)
                    if kind == "mega":
                        vals = self.run_fused(prog, stacked_feed=feed, fetch_list=fetch_list,
                                              scope=scope)
                        step_cb(vals, item[2], True)
                    else:
                        vals = self.run(prog, feed=feed, fetch_list=fetch_list, scope=scope,
                                        return_numpy=False)
                        step_cb(vals, 1, False)
        last = state["last"]
        if last is None:
            return None
        if state["fused"]:
            last = [v[-1] for v in last]      # the last step's fetches
        return materialize_fetches(last) if return_numpy else list(last)

    #: timed ``run_fused`` calls a candidate K gets in the search, after one untimed
    _FUSE_SEARCH_PROBES = 2

    def _fuse_params(self, feed, fetch_names) -> dict:
        """The ``fuse_steps.k`` params of a workload: the per-step feed
        signature and the fetch count, as the JAX executor's ``_fuse_params``
        (numpy dtype names, so the keys match across the packages)."""
        return {"feed": sorted((n, [int(d) for d in np.shape(v)], str(np.asarray(v).dtype))
                               for n, v in feed.items()),
                "fetches": len(fetch_names)}

    def _resolve_fuse_steps(self, batches, fetch_list):
        """``fuse_steps=0``: the ``fuse_steps.k`` decision for this workload.
        Peeks at the first batch (its shapes key the decision) and returns
        ``(k, the batches with the peek put back, params or None)``; params
        (``PADDLE_TPU_TUNE=search`` with no decision yet) means the caller
        runs the search in the loop."""
        from ..tuning import cache as _tcache
        it = iter(batches)
        try:
            first = next(it)
        except StopIteration:
            return 1, iter(()), None
        chained = itertools.chain([first], it)
        tmode = _tcache.mode()
        if tmode == "off":
            return 1, chained, None
        params = self._fuse_params(first, self._fetch_names(fetch_list))
        cached = _tcache.CACHE.get(_tuning.get_choice("fuse_steps.k").key(params))
        k = int(_tuning.decide("fuse_steps.k", params, allow_search=False))
        if cached is not None or tmode != "search":
            return k, chained, None
        return 1, chained, params

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fused_search_epoch(self, program, batches, depth, fetch_list, scope, params,
                            step_cb, abort=None):
        """The ``fuse_steps.k`` search on the live workload: two single
        steps first (on the card, the step's warm-up and its capture), then
        each candidate K, in ascending order, takes one untimed
        ``run_fused`` call of K batches and ``_FUSE_SEARCH_PROBES`` timed
        ones (host clock, closed by a device sync), every call a real
        training step; the fastest per step wins and is persisted
        (``tuning.record_decision``), and the rest of the epoch runs at it.
        An epoch that runs out of batches first persists what it measured."""
        import time as _time
        cands = sorted(int(c) for c in _tuning.get_choice("fuse_steps.k").candidates(params))
        loop = self._prefetch_batches(batches, depth, abort=abort)
        timings: Dict[str, dict] = {}
        t_search = _time.perf_counter()

        def run_chunk(feeds):
            if len(feeds) == 1:
                vals = self.run(program, feed=feeds[0], fetch_list=fetch_list, scope=scope,
                                return_numpy=False)
                step_cb(vals, 1, False)
            else:
                vals = self.run_fused(program, feeds=feeds, fetch_list=fetch_list,
                                      scope=scope)
                step_cb(vals, len(feeds), True)

        with contextlib.closing(loop):
            for feed in itertools.islice(loop, 2):    # the warm-up and the capture
                run_chunk([feed])
            exhausted = False
            for cand in cands:
                for probe in range(self._FUSE_SEARCH_PROBES + 1):   # +1: untimed
                    feeds = list(itertools.islice(loop, cand))
                    if len(feeds) < cand:
                        exhausted = True
                        for f in feeds:       # the leftover batches still train
                            run_chunk([f])
                        break
                    self._sync()
                    t0 = _time.perf_counter()
                    run_chunk(feeds)
                    self._sync()
                    if probe > 0:
                        rec = timings.setdefault(str(cand), {"runs_ms": []})
                        rec["runs_ms"].append((_time.perf_counter() - t0) / cand * 1e3)
                if str(cand) in timings:
                    runs = sorted(timings[str(cand)]["runs_ms"])
                    timings[str(cand)]["run_ms"] = runs[len(runs) // 2]
                if exhausted:
                    break
            measured = {c: t["run_ms"] for c, t in timings.items() if "run_ms" in t}
            winner = int(min(measured, key=measured.get)) if measured else 1
            _tuning.record_decision("fuse_steps.k", params, winner, timings=timings,
                                    search_seconds=_time.perf_counter() - t_search,
                                    measured=bool(measured))
            if exhausted:
                return
            feeds = []
            for feed in loop:      # the rest of the epoch at the winner
                feeds.append(feed)
                if len(feeds) == winner:
                    run_chunk(feeds)
                    feeds = []
            for f in feeds:
                run_chunk([f])

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

    def _run_step(self, program, feeds, fetch_names, scope, counter, fuse_k=None) -> _StepRun:
        """One step, through the cache of steps (``_StepRun``). A miss is
        verified first (``_maybe_verify``; ``fuse_k`` is ``run_fused``'s K)."""
        seed = self._seed(program)
        sig = tuple(sorted((k, tuple(t.shape), str(t.dtype)) for k, t in feeds.items()))
        captures = self._captures()
        dp = self._dp.key if self._dp is not None else ()
        if captures:
            _tuning.prefetch()     # before the key: the lowerings' consults are lookups
            key = (id(program), program._version, sig, tuple(fetch_names), seed, id(scope),
                   dp, _tuning.state_token())
        else:
            key = (id(program), program._version, sig, tuple(fetch_names), seed, id(scope),
                   dp)
        step = self._cache.get(key)
        if step is None:
            # before the step enters the cache: a program that fails the gate
            # is a miss again on its retry, and raises again
            self._maybe_verify(program, list(feeds), fetch_names,
                               {k: tuple(t.shape) for k, t in feeds.items()}, fuse_k)
            ws = (self._warmstore_consult("fused_step" if fuse_k else "train_step", program,
                                          sig, fetch_names, seed, captures)
                  if _warmstore_armed() else None)
            step = self._cache[key] = _Step(capture_refusal(program) if captures
                                            else "CUDA graphs are off (the CPU, or "
                                                 "_use_graphs False)")
            step.ws = ws
            if captures and step.refusal is not None:
                warnings.warn(f"Executor.run: the program is not captured as a CUDA graph "
                              f"({step.refusal}); its runs are eager", stacklevel=3)
            while len(self._cache) > self._CACHE_CAP:
                self._drop(next(iter(self._cache)))
        else:
            self._cache.move_to_end(key)
        label = f"{id(program)}:v{program._version}"
        if not step.warmed:
            # the signature's first run: eager (on the card on a side stream,
            # setting up what a capture needs), its cost counted and, when
            # armed, attributed op by op
            step.warmed = True
            if step.refusal is None:
                run = lambda: cuda_graphs.warm_up(self.device, lambda: self._eager(  # noqa: E731
                    program, feeds, fetch_names, scope, counter, self._counter))
            else:
                run = lambda: self._eager(  # noqa: E731
                    program, feeds, fetch_names, scope, counter, self._counter)
            with _attrib.profiled(program, label, self.device):
                out = run()
                work_end = time.perf_counter()
            step.cost = _cost.step_cost(program, _feed_batch(program, feeds), self.device)
            _cost.update_cost_gauges(step.cost, None, label)
            _memory.update_program_memory_gauges(
                label, _memory.tensor_bytes(itertools.chain(
                    feeds.values(), (scope.find_var(n) for n in
                                     self._state_names(program, feeds, fetch_names)[0]))),
                _memory.tensor_bytes(out))
            if step.refusal is not None:
                # not captured: the static estimate's one time for this signature
                self._static_memory(program, feeds, fetch_names, label)
                if step.ws is not None:
                    self._warmstore_offer(step, None)
            _memory.sample_device_memory("compile", self.device, scope)
            self._last_miss = {"program": label, "feeds": {k: list(t.shape) for k, t in
                                                           feeds.items()},
                               "fetches": list(fetch_names), "captured": False}
            if captures:
                key = self._rehome_tuning_token(key)
            return _StepRun(out, False, key, True, None, work_end)
        if step.refusal is not None:
            return _StepRun(self._eager(program, feeds, fetch_names, scope, counter,
                                        self._counter), False, key, False, None, None)
        capture = None
        if step.graph is None:
            if _faults._active:
                # before the capture: nothing is cached yet, a retry recaptures
                _faults.fire("compile", counter, program=label)
            t0 = time.perf_counter()
            self._capture(step, program, feeds, fetch_names, scope)
            capture = (t0, time.perf_counter() - t0)
            _OBS.histogram("executor_compile_seconds",
                           "CUDA-graph capture wall time per cache miss").observe(capture[1])
            _timeline.record_span("compile", t0, capture[1], step=counter, program=label)
            _memory.sample_device_memory("compile", self.device)
            self._last_miss = dict(self._last_miss or {}, program=label, captured=True,
                                   capture_ms=round(capture[1] * 1e3, 3),
                                   graph_pool_bytes=step.graph.memory_bytes)
        elif not self._guard(step, scope):
            # the scope's state changed shape or dtype: a new executable
            self._drop(key)
            return self._run_step(program, feeds, fetch_names, scope, counter)
        for k, t in feeds.items():
            step.feeds[k].copy_(t)
        step.counter.fill_(counter)
        step.graph.replay()
        fetches, written = step.graph.outputs
        for n, t in written.items():
            scope.set_var(n, t.clone())
        if capture is not None:
            parts = _memory.update_program_memory_gauges(
                label, _memory.tensor_bytes(itertools.chain(step.state.values(),
                                                            step.feeds.values())),
                _memory.tensor_bytes(fetches), step.graph.memory_bytes)
            self._static_memory(program, feeds, fetch_names, label, parts)
            if step.ws is not None:
                self._warmstore_offer(step, {"graph_pool_bytes": step.graph.memory_bytes,
                                             "argument_bytes": parts["argument_bytes"]})
        return _StepRun(fetches, True, key, capture is not None, capture, None)

    # -- the warm store (``warmstore/``), armed by PADDLE_TPU_WARMSTORE ----------

    def _startup_prefetch(self) -> None:
        """The warm store's one startup scan a process, at its first armed
        miss: the stored steps' kernels made ready together."""
        global _WS_PREFETCHED
        if _WS_PREFETCHED:
            return
        _WS_PREFETCHED = True
        from .. import warmstore as _ws
        _ws.prefetch()

    def _warmstore_key(self, kind, program, sig, fetch_names, seed, captures) -> dict:
        """The cache key in the store's cross-process form: the program's
        content digest for its id, the decision records' fingerprint for the
        in-process token; no scope (a restart has another)."""
        from .. import warmstore as _ws
        return _ws.build_key(kind, program, feed_sig=sig, fetch_names=fetch_names, seed=seed,
                             flags=(self._reuse_forward, self._group_updates,
                                    self._free_dead, captures),
                             strategy=(), world_dependent=False, device=self.device)

    def _warmstore_consult(self, kind, program, sig, fetch_names, seed, captures):
        """At a signature's miss, after the verifier gate: a hit has the
        step's kernels ready before its warm-up. The warm-up and the capture
        run as on any miss."""
        self._startup_prefetch()
        from .. import warmstore as _ws
        return _ws.consult_step(self._warmstore_key(kind, program, sig, fetch_names, seed,
                                                    captures))

    @staticmethod
    def _warmstore_offer(step: _Step, parts) -> None:
        """After the capture (the first run when there is none): the step's
        record goes to the store's writer thread."""
        from .. import warmstore as _ws
        handle, step.ws = step.ws, None
        _ws.offer_step(handle, parts)

    @staticmethod
    def _static_memory(program, feeds, fetch_names, label, parts=None) -> None:
        """``program_static_peak_bytes`` (and, beside a capture's ``parts``,
        its ratio), once a signature."""
        _memory.update_static_memory_gauges(
            program, {k: tuple(t.shape) for k, t in feeds.items()}, list(feeds),
            fetch_names, label, parts)

    def _drop(self, key) -> None:
        """Evict a cache entry with its anomaly windows and, when no live
        executor still caches its program, its gauges."""
        step = self._cache.pop(key)
        for w in step.windows:
            _anomaly.DETECTOR.retire(w)
        _retire_program_gauges_if_dead(key[0], key[1])

    def _rehome_tuning_token(self, key):
        """Move a just-warmed entry under the current decision-state token
        and return its key. A search in the warm-up bumps the token after
        the key was made; without the move the next run would miss and warm
        up again."""
        new = _tuning.state_token()
        if new != key[-1] and key in self._cache:
            self._cache[key[:-1] + (new,)] = self._cache.pop(key)
            return key[:-1] + (new,)
        return key

    def _captures(self) -> bool:
        """Whether runs go through the cache of CUDA graphs: on the card,
        unless ``_use_graphs`` is off."""
        return self._use_graphs and self.device.type == "cuda"

    def _seed(self, program) -> int:
        """The program's seed; on a data-parallel run of more than one rank
        this rank folded in, so the ranks draw different dropout masks (the
        JAX explicit path folds the shard index into the step key)."""
        seed = program.random_seed if program.random_seed is not None else 0
        if self._dp is not None and self._dp.size > 1:
            seed = registry.seed_int(seed, self._dp.rank, _RANK_SALT)
        return seed

    def _trace(self, program, env, fetch_names, state_in, state_out, counter, counter_t):
        """The program's ops over ``env``, freeing what no later op reads; on
        a data-parallel run the fetches reduced over the ranks
        (``_DataParallel.reduce_fetch``)."""
        seed = self._seed(program)
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
        if self._dp is not None:
            block = program.global_block()
            with torch.no_grad():
                for n in fetch_names:
                    env[n] = self._dp.reduce_fetch(n, env[n], block)

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
