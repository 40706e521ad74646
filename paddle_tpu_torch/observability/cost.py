"""Per-step FLOPs gauges and an achieved-MFU derivation (the port's copy of
``paddle_tpu/observability/cost.py``).

The JAX package reads a step's FLOPs from XLA's ``cost_analysis()`` of the
compiled executable. The port has no such analysis: a step's FLOPs come
from ``utils/flops.py::program_flops`` over the Program, counted once at the
step's first run (the capture miss on the card), and so cover the
matmul-class ops only (``mul``, ``matmul``, the convolutions,
``fused_attention``; grad ops twice). Elementwise and reduction work is
left out, so the MFU is a slight underestimate. The byte count and the
arithmetic intensity that XLA gives the JAX package have no exact source
here and are not estimated: ``program_bytes_accessed`` and
``program_arithmetic_intensity`` are absent.

Peak resolution order: an explicit ``peak`` argument > the
``PADDLE_TPU_OBS_PEAK_FLOPS`` environment override (how a CPU run, whose
peak the table cannot know, still gets a finite MFU) > the card's row in
``utils/flops.py`` for the program's product dtype. An unknown peak gives
MFU None, and the gauge is not set: never fabricated.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional

from .metrics import REGISTRY, MetricsRegistry

PEAK_ENV = "PADDLE_TPU_OBS_PEAK_FLOPS"


def peak_flops(device_kind: Optional[str] = None,
               dtype: str = "bfloat16") -> Optional[float]:
    """Peak FLOP/s for products in ``dtype`` on ``device_kind`` (default:
    card 0's name, when there is a card); None when unknown."""
    env = os.environ.get(PEAK_ENV)
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if device_kind is None:
        import torch
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    from ..utils.flops import device_peak_flops
    return device_peak_flops(device_kind, dtype)


def achieved_mfu(flops: float, step_seconds: float,
                 peak: Optional[float] = None,
                 device_kind: Optional[str] = None,
                 dtype: str = "bfloat16") -> Optional[float]:
    """flops / step_seconds / peak, or None when the peak is unknown or the
    timing is degenerate (a wall time <= 0 would divide to inf)."""
    if not step_seconds or step_seconds <= 0 or flops <= 0:
        return None
    peak = peak if peak is not None else peak_flops(device_kind, dtype)
    if not peak:
        return None
    mfu = flops / step_seconds / peak
    return mfu if math.isfinite(mfu) else None


class StepCost:
    """What a step costs, counted once at its first run: ``flops`` is
    ``program_flops``' dict, ``dtype`` the program's product dtype (the dtype
    that carries most of its FLOPs), ``device_kind`` the card's name (None on
    the CPU)."""

    def __init__(self, flops: Dict[str, int], dtype: str,
                 device_kind: Optional[str]):
        self.flops = dict(flops)
        self.dtype = dtype
        self.device_kind = device_kind

    @property
    def peak(self) -> Optional[float]:
        return peak_flops(self.device_kind or "cpu", self.dtype)


def step_cost(program, batch: int, device) -> StepCost:
    """The StepCost of one run of ``program`` at ``batch`` on ``device``."""
    from ..utils.flops import program_flops, product_dtype
    kind = None
    if getattr(device, "type", str(device)) == "cuda":
        import torch
        kind = torch.cuda.get_device_name(device)
    return StepCost(program_flops(program, batch), product_dtype(program, batch), kind)


def update_cost_gauges(cost: StepCost, step_seconds: Optional[float], program: str,
                       registry: Optional[MetricsRegistry] = None) -> Optional[dict]:
    """Set the per-program cost gauges (label program=<id:version>):
    ``program_flops`` always, and with a measured step time
    ``program_flops_per_sec`` and, when the peak is known, ``program_mfu``.
    Returns {"flops", "flops_per_sec", "mfu", "peak", "dtype"}."""
    registry = registry or REGISTRY
    g = registry.gauge
    flops = float(cost.flops["total"])
    g("program_flops", "matmul-class FLOPs per step (utils/flops.py::program_flops)",
      program=program).set(flops)
    out = {"flops": flops, "flops_per_sec": None, "mfu": None, "peak": cost.peak,
           "dtype": cost.dtype}
    if step_seconds and step_seconds > 0:
        out["flops_per_sec"] = flops / step_seconds
        g("program_flops_per_sec", "achieved FLOP/s at last measured step",
          program=program).set(out["flops_per_sec"])
        out["mfu"] = achieved_mfu(flops, step_seconds, peak=out["peak"])
        if out["mfu"] is not None:
            g("program_mfu", "achieved FLOP/s over the card's peak for the "
              "program's product dtype", program=program).set(out["mfu"])
    return out
