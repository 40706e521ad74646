"""Device-memory telemetry: per-device gauges and per-program bytes (the
port's copy of ``paddle_tpu/observability/memory.py``).

- Occupancy: on the card, ``torch.cuda.memory_stats()`` (the caching
  allocator's allocated bytes now and at its high-water mark); on the CPU,
  where PyTorch keeps no such count, the bytes of the scope's tensors, as
  the JAX package sums ``jax.live_arrays()`` when its backend has no
  ``memory_stats()``. Samples land in ``device_memory_bytes_in_use`` /
  ``device_memory_peak_bytes``, the ``memory_samples_total`` counter and a
  flight-recorder counter track.
- A step's footprint, from its capture: ``program_peak_bytes`` (the bytes
  the CUDA graph's memory pool reserved: every intermediate of the step and
  its outputs), ``program_argument_bytes`` (the state and the feeds it
  reads) and ``program_output_bytes`` (its fetches), per program label. On
  the CPU there is no pool, and only the argument and output bytes are set.

The executor samples at a step's first run and then every K steps
(``PADDLE_TPU_OBS_MEM_INTERVAL``, default 10) while ``PADDLE_TPU_OBS`` is
on; with it off the per-step path does nothing.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

from .metrics import REGISTRY, MetricsRegistry

DEFAULT_INTERVAL = 10


def sample_interval() -> int:
    raw = os.environ.get("PADDLE_TPU_OBS_MEM_INTERVAL", "")
    try:
        k = int(raw) if raw else DEFAULT_INTERVAL
    except ValueError:
        k = DEFAULT_INTERVAL
    return max(1, k)


def tensor_bytes(tensors: Iterable) -> int:
    """Bytes of the distinct storages behind ``tensors`` (non-tensors skipped;
    two views of one storage count once)."""
    import torch
    seen, total = set(), 0
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        key = (st.data_ptr(), t.device)
        if key in seen:
            continue
        seen.add(key)
        total += st.nbytes()
    return total


def sample_device_memory(reason: str = "step", device=None, scope=None,
                         registry: Optional[MetricsRegistry] = None,
                         ) -> Dict[str, Dict[str, float]]:
    """Take one memory sample of ``device`` (default: card 0 when there is
    one, else the CPU); set the gauges and the counter track; return the
    {device: {bytes_in_use, peak_bytes}} snapshot. On the CPU ``scope``'s
    tensors are what is counted."""
    import torch
    registry = registry or REGISTRY
    if device is None:
        device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        key = f"cuda:{idx}"
        stats = torch.cuda.memory_stats(idx)
        in_use = float(stats.get("allocated_bytes.all.current", 0))
        peak = float(stats.get("allocated_bytes.all.peak", in_use))
    else:
        key = "cpu:0"
        in_use = float(tensor_bytes(scope._vars.values()) if scope is not None else 0)
        # no allocator high-water mark: the max this process has observed
        peak = max(registry.gauge("device_memory_peak_bytes",
                                  "peak device bytes (allocator high-water mark, or "
                                  "max observed sample)", device=key).value, in_use)
    registry.gauge("device_memory_bytes_in_use", "device bytes in use at last sample",
                   device=key).set(in_use)
    registry.gauge("device_memory_peak_bytes", "peak device bytes (allocator high-water "
                   "mark, or max observed sample)", device=key).set(peak)
    registry.counter("memory_samples_total", "device-memory telemetry samples by reason",
                     reason=reason).inc()
    from . import timeline as _timeline
    _timeline.counter_sample("device_memory_bytes", {key: in_use})
    return {key: {"bytes_in_use": in_use, "peak_bytes": peak}}


def update_program_memory_gauges(program: str, argument_bytes: float,
                                 output_bytes: float,
                                 pool_bytes: Optional[float] = None,
                                 registry: Optional[MetricsRegistry] = None,
                                 ) -> Dict[str, float]:
    """Set a step's footprint gauges; ``pool_bytes`` is its CUDA graph's
    memory pool (None on the CPU: ``program_peak_bytes`` is then not set).
    Returns the parts set."""
    registry = registry or REGISTRY
    g = registry.gauge
    parts = {"argument_bytes": float(argument_bytes), "output_bytes": float(output_bytes)}
    g("program_argument_bytes", "input bytes of the step (state and feeds)",
      program=program).set(parts["argument_bytes"])
    g("program_output_bytes", "output bytes of the step (fetches)",
      program=program).set(parts["output_bytes"])
    if pool_bytes is not None:
        parts["peak_bytes"] = float(pool_bytes)
        g("program_peak_bytes", "bytes the step's CUDA graph pool reserved at its "
          "capture (its intermediates and outputs)", program=program).set(parts["peak_bytes"])
    return parts


def update_static_memory_gauges(program_ir, feed_shapes, feed_names, fetch_names,
                                strategy, program: str,
                                parts: Optional[Dict[str, float]] = None,
                                registry: Optional[MetricsRegistry] = None):
    """The JAX package's static peak-memory estimate needs its liveness
    planner, ``analysis/memplan.py``, which is not ported (``analysis/`` is
    the rest of ROADMAP item 12). Returns None, as the JAX function does
    when its planner fails, and sets no gauge."""
    return None
