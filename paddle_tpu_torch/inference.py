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
instead. On the CPU the cached executable is the eager op-by-op run, also
under the signature's lock. The device is explicit: ``device=None`` is the
card, and with no card that raises.

Around each request ``run`` does what the JAX ``Predictor.run`` does: the
timeline spans ``feed_prep``, ``dispatch`` and ``fetch_sync``
(``observability/timeline.py``), the tensor-health check of the fetches
when ``PADDLE_TPU_OBS_HEALTH`` is on, the histogram
``predictor_request_seconds{cold}`` (cold: this request built its
signature's executable), the counter
``predictor_executable_cache_total{outcome}`` and, with ``PADDLE_TPU_OBS``
on, a ``predict`` journal event.

``swap_state`` replaces the weights for the serving pool's hot swap. A
captured graph holds the pointers of the pinned parameter tensors, so the
new values are copied INTO those tensors (and into each serving dtype's
cast copy), with every signature's lock held: no replay reads half-old
weights, and no graph is captured again.

On the card each capture records a ``compile`` span (the goodput ledger's
compile cause), and its warm-up is attributed op by op when attribution is
armed (``observability/attribution.py``; label ``predict:<signature
digest>``), as the JAX Predictor attributes each compiled signature.

With the warm store armed (``PADDLE_TPU_WARMSTORE``, ``warmstore/``), a
signature's miss consults it first (kind ``predict``): a hit has the step's
kernels ready before the warm-up, restored or all compiled at once; the
warm-up and the capture run as on any miss, and the step's record is
offered after the capture.

Not ported yet: the JAX Predictor's sparse tables (ROADMAP item 10's online
part).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .core import graphs
from .core.executor import (Scope, SubBlockRunner, as_tensor, resolve_device, scope_guard,
                            to_numpy, trace_block)
from .core.registry import torch_dtype
from .framework import Program
from .observability import attribution as _attrib
from .observability import health as _health
from .observability import journal as _journal
from .observability import timeline as _timeline
from .observability.metrics import REGISTRY as _OBS

#: the key prefix of a sparse-table delta in a ``swap_state`` dict
SPARSE_PREFIX = "sparse:"

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
    lowering at a time, under the signature's ``lock`` (which ``swap_state``
    holds while it copies)."""

    def __init__(self, pred: "Predictor", state, lock):
        self._pred, self._state, self.lock = pred, state, lock

    def __call__(self, feeds: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        return self._pred._trace(self._state, feeds)


class _GraphRun:
    """The executable of a signature on the card: one CUDA graph of the
    program over static feed buffers, in a memory pool of its own
    (``core/graphs.py``), after a warm-up run on a side stream. Call it under
    ``lock``: the feed and fetch buffers are shared."""

    def __init__(self, pred: "Predictor", state, feeds: Dict[str, torch.Tensor], lock,
                 label: str):
        self.lock = lock
        dev = pred.device
        self._feeds = {k: t.clone() for k, t in feeds.items()}
        t0 = time.perf_counter()
        with _attrib.profiled(pred.program, label, dev):   # when attribution is armed
            graphs.warm_up(dev, lambda: pred._trace(state, self._feeds))
        t1 = time.perf_counter()
        self._graph = graphs.Graph(dev, lambda: pred._trace(state, self._feeds))
        t2 = time.perf_counter()
        #: the seconds of the eager warm-up and of the capture
        self.warm_up_s, self.capture_s = t1 - t0, t2 - t1
        # the capture is the port's compile: the goodput ledger's compile
        # cause, wherever it happens (a serving pool's warm-up included)
        _timeline.record_span("compile", t1, t2 - t1, program=label)
        #: device memory the capture reserved for this signature's pool (bytes)
        self.memory_bytes = self._graph.memory_bytes
        #: bytes of the pinned state and the feed buffers the graph reads
        self.argument_bytes = sum(t.numel() * t.element_size() for t in
                                  list(state.values()) + list(self._feeds.values()))
        #: each kernel wrapper's launches in one replay
        self.launches = self._graph.launches

    def __call__(self, feeds: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
        for k, t in feeds.items():
            self._feeds[k].copy_(t)
        self._graph.replay()
        return self._graph.outputs


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
        #: weight generation served by this session (``swap_state`` moves it;
        #: the serving pool tags its journal events and /metrics with it)
        self.model_version: int = 1

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
        session's serving dtype for this call (the serving pool's
        ``serving.dtype`` decision lands here)."""
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
        t0 = time.perf_counter()
        dt_serve = _norm_dtype(dtype) if dtype is not None else self._dtype
        with _timeline.phase("feed_prep", cat="predictor"):
            feeds = self._feed_tensors(inputs, dt_serve)
        if not self._use_graphs:
            with _timeline.phase("dispatch", cat="predictor"):
                outs = self._trace(self._state_for(dt_serve), feeds)
            with _timeline.phase("fetch_sync", cat="predictor"):
                outs = [to_numpy(t) for t in outs]
            cold = False
        else:
            exe, cold = self._executable(feeds, dt_serve)
            with exe.lock:
                with _timeline.phase("dispatch", cat="predictor"):
                    outs = exe(feeds)
                with _timeline.phase("fetch_sync", cat="predictor"):
                    outs = [to_numpy(t) for t in outs]   # the device work is done
        hmode = _health.mode()
        if hmode != "off":
            # after fetch_sync: host numpy, so the scan is host work only
            _health.check(list(zip(self.fetch_names, outs)), f"predictor:{id(self.program)}",
                          where="predictor", health_mode=hmode)
        dt = time.perf_counter() - t0
        # cold and warm are separate series: a request that captured its
        # signature's graph would otherwise poison the warm p99
        _OBS.histogram("predictor_request_seconds", "Predictor.run end-to-end request latency",
                       cold="true" if cold else "false").observe(dt)
        if _journal.enabled():
            _journal.emit({"event": "predict", "cold": cold, "run_ms": round(dt * 1e3, 3),
                           "feed": {k: [list(np.shape(inputs[k])),
                                        str(np.asarray(inputs[k]).dtype)]
                                    for k in self.feed_names},
                           "fetch": list(self.fetch_names)})
        return outs

    def _feed_tensors(self, inputs, dtype: Optional[str]) -> Dict[str, torch.Tensor]:
        """The feeds as tensors on the device, float feeds cast to the
        serving ``dtype`` (None: as given)."""
        feeds = {}
        for k in self.feed_names:
            t = as_tensor(inputs[k], self.device)
            if dtype is not None and t.is_floating_point():
                t = t.to(torch_dtype(dtype))
            feeds[k] = t
        return feeds

    def _signature(self, feeds: Dict[str, torch.Tensor], dtype: Optional[str]) -> tuple:
        """The executable cache's key, the JAX Predictor's: the serving dtype,
        then (name, shape, dtype name) of each feed as the program sees it."""
        return (dtype,) + tuple((k, tuple(feeds[k].shape), str(feeds[k].dtype)[len("torch."):])
                                for k in self.feed_names)

    def _count(self, outcome: str):
        with self._lock:
            self._cache_counts[outcome] += 1
        _OBS.counter("predictor_executable_cache_total",
                     "Predictor executable cache lookups by outcome", outcome=outcome).inc()

    def _executable(self, feeds: Dict[str, torch.Tensor], dtype: Optional[str]):
        """(executable, cold) of this feed signature, built on a miss. Exactly
        one thread builds a new signature and is the only one labelled cold;
        the rest wait on its lock and hit."""
        sig = self._signature(feeds, dtype)
        exe = self._compiled.get(sig)
        if exe is not None:
            self._count("hit")
            return exe, False
        with self._lock:
            lk = self._sig_locks.setdefault(sig, threading.Lock())
        with lk:
            exe = self._compiled.get(sig)
            if exe is not None:
                self._count("hit")
                return exe, False
            self._count("miss")
            state = self._state_for(dtype)
            ws = None
            if os.environ.get("PADDLE_TPU_WARMSTORE"):   # read before the import
                from . import warmstore as _ws
                ws = _ws.consult_step(_ws.build_key(
                    "predict", self.program, feed_sig=sig, fetch_names=self.fetch_names,
                    seed=0, flags=None, strategy=(), world_dependent=False,
                    device=self.device))
            if self.device.type == "cuda":
                exe = _GraphRun(self, state, feeds, lk,
                                f"predict:{_attrib.signature_digest(sig)}")
            else:
                exe = _EagerRun(self, state, lk)
            if ws is not None:
                _ws.offer_step(ws, {"graph_pool_bytes": exe.memory_bytes,
                                    "argument_bytes": exe.argument_bytes}
                               if self.device.type == "cuda" else None)
            self._compiled[sig] = exe
        return exe, True

    # -- hot swap ---------------------------------------------------------------------
    def swap_state(self, new_state: Dict[str, object], validate_only: bool = False,
                   model_version: Optional[int] = None) -> None:
        """Replace the pinned parameters by ``new_state`` (name -> array or
        tensor), keeping every executable: each new value is copied into the
        pinned tensor a captured graph reads, and into each serving dtype's
        cast copy, with every signature's lock held, so a run sees all old or
        all new weights. A missing parameter, or a shape or dtype other than
        the pinned one, is rejected before anything is touched
        (ValueError). ``validate_only=True`` checks without copying. A
        ``"sparse:<table>"`` key (the JAX package's online delta push)
        raises NotImplementedError: sparse tables are ROADMAP item 10's
        online part."""
        sparse = sorted(k for k in new_state if str(k).startswith(SPARSE_PREFIX))
        if sparse:
            raise NotImplementedError(
                f"swap_state got sparse-table deltas {sparse}: the Predictor's sparse "
                f"tables and the online delta push are not ported (ROADMAP item 10, its "
                f"online part)")
        missing = [n for n in self._state if n not in new_state]
        if missing:
            raise ValueError(f"swap_state missing {len(missing)} parameter(s): "
                             f"{sorted(missing)[:5]}")
        staged = {}
        for n, cur in self._state.items():
            v = new_state[n]
            new = v if isinstance(v, torch.Tensor) else as_tensor(v, torch.device("cpu"))
            if tuple(new.shape) != tuple(cur.shape) or new.dtype != cur.dtype:
                raise ValueError(
                    f"swap_state parameter {n!r} is {tuple(new.shape)}/{new.dtype}, current "
                    f"is {tuple(cur.shape)}/{cur.dtype}; hot swap needs identical shapes "
                    f"and dtypes")
            staged[n] = new
        if validate_only:
            return
        with self._lock:
            locks = [self._sig_locks[s] for s in sorted(self._sig_locks, key=repr)]
        for lk in locks:
            lk.acquire()
        try:
            with torch.no_grad():
                for n, new in staged.items():
                    self._state[n].copy_(new)
                for dt, state in self._states.items():
                    if dt is not None:
                        for n, t in state.items():
                            if t is not self._state[n]:
                                t.copy_(self._state[n])
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            with self._lock:
                self.model_version = (int(model_version) if model_version is not None
                                      else self.model_version + 1)
        finally:
            for lk in reversed(locks):
                lk.release()

    def _trace(self, state, feeds) -> List[torch.Tensor]:
        """The pruned program's ops over the pinned state and the feeds, each
        intermediate dropped after its last reader; a control-flow op (an
        RNN's ``scan``) runs its sub-block through a ``SubBlockRunner``."""
        env = dict(state)
        env.update(feeds)
        keep = frozenset(env) | frozenset(self.fetch_names)
        runner = SubBlockRunner(self.program, env, self.device, reuse_forward=False)
        with torch.inference_mode():
            trace_block(self.program.global_block(), env, self.device, keep=keep,
                        block_runner=runner)
        return [env[n] for n in self.fetch_names]

    predict = run

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return list(self.fetch_names)


def create_paddle_predictor(config: AnalysisConfig) -> Predictor:
    return Predictor(config.model_dir, config.model_file, config.params_file,
                     dtype="bfloat16" if config._use_bf16 else None, device=config.device)
