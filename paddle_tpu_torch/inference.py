"""Inference session: Predictor + AnalysisConfig (the port's copy of
``paddle_tpu/inference.py``).

``Predictor`` loads a ``save_inference_model`` directory (either package's)
into its own Scope, pins the parameters on its device once, and answers
``run`` calls by running the pruned program's ops eagerly on that device:
on the card, attention is the CUDA flash-attention kernel. The device is
explicit: ``device=None`` is the card, and with no card that raises.

Not ported yet: the JAX Predictor's executable cache, warm store, IR
attribution, journal, health checks and timeline spans, ``swap_state`` and
sparse tables.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import torch

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
        self._lock = threading.Lock()
        # per-dtype pinned state: a serving-dtype override keeps its own cast copy
        self._states: Dict[Optional[str], Dict[str, torch.Tensor]] = {None: self._state}

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
        env = dict(self._state_for(dt_serve))
        for k in self.feed_names:
            t = as_tensor(inputs[k], self.device)
            if dt_serve is not None and t.is_floating_point():
                t = t.to(torch_dtype(dt_serve))
            env[k] = t
        with torch.inference_mode():
            trace_block(self.program.global_block(), env, self.device)
        return [to_numpy(env[n]) for n in self.fetch_names]

    predict = run

    def get_input_names(self):
        return list(self.feed_names)

    def get_output_names(self):
        return list(self.fetch_names)


def create_paddle_predictor(config: AnalysisConfig) -> Predictor:
    return Predictor(config.model_dir, config.model_file, config.params_file,
                     dtype="bfloat16" if config._use_bf16 else None, device=config.device)
