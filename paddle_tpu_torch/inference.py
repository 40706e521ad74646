"""Inference session: Predictor + AnalysisConfig (the port's copy of
``paddle_tpu/inference.py``).

``Predictor`` loads a ``save_inference_model`` directory (either package's)
into its own Scope, pins the parameters on its device once, and answers
``run`` calls through an executable cache keyed, as the JAX Predictor's
``_executable`` keys its AOT executables, by ``(dtype,) + ((name, shape,
dtype) for each feed)``, one lock per signature. On the card a miss copies
the feeds into static buffers, runs the pruned program's ops once eagerly on
a side stream (loading the kernels, setting up cuBLAS and cuDNN), and
captures them into a CUDA graph with its own memory pool; a hit copies the
feeds in, replays the graph and copies the fetches out, under the
signature's lock. A capture that fails raises: nothing serves eagerly
instead. On the CPU the cached executable is the eager op-by-op run. The
device is explicit: ``device=None`` is the card, and with no card that
raises.

Not ported yet: the JAX Predictor's warm store, IR attribution, journal,
health checks and timeline spans, ``swap_state`` and sparse tables.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional

import torch

from .core import cuda_build
from .core.executor import (Scope, as_tensor, resolve_device, scope_guard, to_numpy,
                            trace_block)
from .core.registry import torch_dtype
from .framework import Program

#: serving dtypes Predictor can cast to; None means "native" (serve in the
#: saved model's own dtypes)
SERVING_DTYPES = (None, "float32", "bfloat16")


def _norm_dtype(dtype) -> Optional[str]:
    if dtype in SERVING_DTYPES:
        return dtype
    raise ValueError(f"serving dtype {dtype!r} invalid; use one of {SERVING_DTYPES}")


class AnalysisConfig:
    """Predictor settings (the reference's paddle_analysis_config.h surface)."""

    def __init__(self, model_dir: str, params_file: Optional[str] = None):
        self.model_dir = model_dir
        self.model_file = None
        self.params_file = params_file
        self.device: Optional[str] = None   # None: the card
        self._use_bf16 = False

    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self.device = f"cuda:{device_id}"

    def disable_gpu(self):
        self.device = "cpu"

    def switch_ir_optim(self, flag=True):
        pass   # no graph passes: the ops run as saved

    def enable_memory_optim(self):
        pass   # PyTorch's caching allocator reuses buffers

    def enable_bfloat16(self):
        """Serve in bfloat16: pinned float parameters and float feeds are cast."""
        self._use_bf16 = True


class _EagerRun:
    """The executable of a signature on the CPU: the ops run eagerly, one
    lowering at a time. Concurrent calls share nothing."""

    lock = contextlib.nullcontext()

    def __init__(self, pred: "Predictor", state):
        self._pred, self._state = pred, state

    def __call__(self, feeds: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        return self._pred._trace(self._state, feeds)


class _GraphRun:
    """The executable of a signature on the card: one CUDA graph of the
    program over static feed buffers, in a memory pool of its own. Call it
    under ``lock``: the feed and fetch buffers are shared.

    The kernel wrappers' ``launches`` are host counters that a replay does
    not move, so the capture's launches are taken back off them and added
    again on every replay: they count what ran."""

    def __init__(self, pred: "Predictor", state, feeds: Dict[str, torch.Tensor], lock):
        self.lock = lock
        dev = pred.device
        self._feeds = {k: t.clone() for k, t in feeds.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            pred._trace(state, self._feeds)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()     # as the capture does first: what it adds is its pool
        before = {fn: fn.launches for fn in cuda_build.COUNTED}
        reserved = torch.cuda.memory_reserved(dev)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread serving its own signature meanwhile does
        # not break this capture (the capturing thread's own syncs still do)
        with torch.cuda.graph(self.graph, pool=torch.cuda.graph_pool_handle(),
                              capture_error_mode="thread_local"):
            self._fetches = pred._trace(state, self._feeds)
        #: device memory the capture reserved for this signature's pool (bytes)
        self.memory_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {}
        for fn, n in before.items():
            if fn.launches != n:
                self.launches[fn] = fn.launches - n
                fn.launches = n

    def __call__(self, feeds: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        for k, t in feeds.items():
            self._feeds[k].copy_(t)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self._fetches


class Predictor:
    """Serving session over a save_inference_model directory, on one device."""

    def __init__(self, model_dir: str, model_filename=None, params_filename=None,
                 dtype: Optional[str] = None, device=None):
        from . import io
        self.device = resolve_device(device)
        self._scope = Scope()
        with scope_guard(self._scope):
            prog, feeds, fetches = io.load_inference_model(
                model_dir, None, model_filename, params_filename)
        self.program: Program = prog
        self.feed_names: List[str] = list(feeds)
        self.fetch_names: List[str] = list(fetches)
        self._dtype = _norm_dtype(dtype)
        # pin parameters on the device once; only the ones the program reads
        needed = {n for blk in self.program.blocks
                  for op in blk.ops for n in op.input_arg_names()}
        self._state: Dict[str, torch.Tensor] = {
            n: self._scope.find_var(n).to(self.device)
            for n in self._scope.var_names()
            if n in needed and self._scope.find_var(n) is not None}
        # _lock guards the lock table, the counts and the state casts; one lock
        # per signature makes N threads racing a new signature build it once
        self._lock = threading.Lock()
        self._sig_locks: Dict[tuple, threading.Lock] = {}
        #: signature -> executable (``_GraphRun`` on the card, ``_EagerRun`` on the CPU)
        self._compiled: Dict[tuple, object] = {}
        # executable-cache lookups by outcome
        self._cache_counts = {"hit": 0, "miss": 0}
        # per-dtype pinned state: a serving-dtype override keeps its own cast copy
        self._states: Dict[Optional[str], Dict[str, torch.Tensor]] = {None: self._state}

    # False selects the eager reference path (no executable cache, no graph)
    # that tests and chip_smoke.py compare with
    _use_graphs = True

    def _state_for(self, dtype: Optional[str]) -> Dict[str, torch.Tensor]:
        """Pinned state for a serving dtype (None = native). Float tensors are
        cast once and stay on the device; integer state is never touched."""
        state = self._states.get(dtype)
        if state is not None:
            return state
        with self._lock:
            state = self._states.get(dtype)
            if state is None:
                td = torch_dtype(dtype)
                state = {n: v.to(td) if v.is_floating_point() else v
                         for n, v in self._state.items()}
                self._states[dtype] = state
        return state

    def run(self, inputs, dtype: Optional[str] = None) -> list:
        """inputs: dict name -> array, or a list of arrays ordered as
        feed_names. Returns numpy outputs ordered as fetch_names. numpy has
        no bfloat16, so a bf16 output comes back widened to float32: the
        values are exact, only the dtype differs. ``dtype`` overrides the
        session's serving dtype for this call."""
        if not isinstance(inputs, dict):
            inputs = list(inputs)
            if len(inputs) != len(self.feed_names):
                raise ValueError(
                    f"Predictor.run got {len(inputs)} positional inputs "
                    f"but the model feeds {len(self.feed_names)}: {self.feed_names}")
            inputs = dict(zip(self.feed_names, inputs))
        missing = [n for n in self.feed_names if n not in inputs]
        if missing:
            raise ValueError(f"Predictor.run missing inputs {missing}")
        unexpected = sorted(k for k in inputs if k not in self.feed_names)
        if unexpected:
            raise ValueError(f"Predictor.run got unexpected inputs {unexpected}; "
                             f"the model feeds are {self.feed_names}")
        dt_serve = _norm_dtype(dtype) if dtype is not None else self._dtype
        feeds = {}
        for k in self.feed_names:
            t = as_tensor(inputs[k], self.device)
            if dt_serve is not None and t.is_floating_point():
                t = t.to(torch_dtype(dt_serve))
            feeds[k] = t
        if not self._use_graphs:
            return [to_numpy(t) for t in self._trace(self._state_for(dt_serve), feeds)]
        exe = self._executable(feeds, dt_serve)
        with exe.lock:
            return [to_numpy(t) for t in exe(feeds)]

    def _signature(self, feeds: Dict[str, torch.Tensor], dtype: Optional[str]) -> tuple:
        """The executable cache's key, the JAX Predictor's: the serving dtype,
        then (name, shape, dtype name) of each feed as the program sees it."""
        return (dtype,) + tuple((k, tuple(feeds[k].shape), str(feeds[k].dtype)[len("torch."):])
                                for k in self.feed_names)

    def _count(self, outcome: str):
        with self._lock:
            self._cache_counts[outcome] += 1

    def _executable(self, feeds: Dict[str, torch.Tensor], dtype: Optional[str]):
        """The executable of this feed signature, built on a miss. Exactly one
        thread builds a new signature; the rest wait on its lock and hit."""
        sig = self._signature(feeds, dtype)
        exe = self._compiled.get(sig)
        if exe is not None:
            self._count("hit")
            return exe
        with self._lock:
            lk = self._sig_locks.setdefault(sig, threading.Lock())
        with lk:
            exe = self._compiled.get(sig)
            if exe is not None:
                self._count("hit")
                return exe
            self._count("miss")
            state = self._state_for(dtype)
            if self.device.type == "cuda":
                exe = _GraphRun(self, state, feeds, lk)
            else:
                exe = _EagerRun(self, state)
            self._compiled[sig] = exe
        return exe

    def _trace(self, state, feeds) -> List[torch.Tensor]:
        """The pruned program's ops over the pinned state and the feeds."""
        env = dict(state)
        env.update(feeds)
        with torch.inference_mode():
            trace_block(self.program.global_block(), env, self.device)
        return [env[n] for n in self.fetch_names]

    predict = run

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return list(self.fetch_names)


def create_paddle_predictor(config: AnalysisConfig) -> Predictor:
    return Predictor(config.model_dir, config.model_file, config.params_file,
                     dtype="bfloat16" if config._use_bf16 else None, device=config.device)
