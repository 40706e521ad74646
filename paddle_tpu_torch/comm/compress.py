"""Compressed gradient all-reduce: quantize -> collective -> dequantize (the
port's copy of ``paddle_tpu/comm/compress.py``, on torch tensors over a
bound process group, ``ops/collective.py``).

Two modes, as in the JAX package:

- ``bf16``: cast to bfloat16, all-reduce in bf16 (2 bytes an element on the
  wire), cast back;
- ``int8``: per-process symmetric int8 quantization reduced by the
  two-phase quantized all-reduce: each rank quantizes its whole
  (error-compensated) vector with its own f32 scale and all-to-alls the
  int8 shards (rank j gets everyone's j-th shard; the scales ride a small
  all-gather); rank j dequantizes and sums its shards in f32, quantizes the
  sum again and all-gathers the int8 result and its scales; every rank
  dequantizes the same bytes, so the output is equal on all ranks.

**Error feedback**: each rank keeps a per-tensor residual ``r_t``, sends
``c(g_t + r_t)`` and carries ``r_{t+1} = (g_t + r_t) - c(g_t + r_t)``. The
residual is per-process state (``rewrite.py`` declares it).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

#: suffix of the error-feedback residual persistable made per compressed
#: gradient (``rewrite.py``); checkpoints leave these out (a fresh zero
#: residual after a restore is harmless)
RESIDUAL_SUFFIX = "@comm_residual"

#: gradient dtypes the quantizer handles; any other stays uncompressed
SUPPORTED_DTYPES = ("float32", "bfloat16", "float16")

#: compression modes the DistributedStrategy knob accepts
MODES = ("off", "bf16", "int8")

#: tensors below this many bytes never compress by default (the JAX
#: package's floor; the per-tensor TunableChoice only widens it)
MIN_COMPRESS_BYTES = 65536


def is_residual(name: str) -> bool:
    return name.endswith(RESIDUAL_SUFFIX)


def residual_name(grad_name: str) -> str:
    return grad_name + RESIDUAL_SUFFIX


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: (q, scale) with x ~= q * scale; scale is a
    f32 scalar, 1.0 for an all-zero tensor."""
    xf = x.float()
    amax = xf.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def _group(axis):
    from ..ops import collective as _coll
    if isinstance(axis, _coll.AxisGroup):
        return axis
    g = _coll.bound(axis)
    if g is None:
        raise ValueError(f"compressed_allreduce: no process group is bound to axis "
                         f"{axis!r}")
    return g


def _sum_int8(x: torch.Tensor, g) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-phase int8 all-reduce of ``x``; returns (sum cast back, this
    rank's quantization error)."""
    from ..ops import collective as _coll
    n = g.size
    shape, dtype = x.shape, x.dtype
    xf = x.float().reshape(-1)
    size = xf.shape[0]
    pad = (-size) % n
    if pad:
        xf = torch.cat([xf, xf.new_zeros((pad,))])
    q, scale = quantize_int8(xf)
    # phase 1: the int8 shards to their owners, everyone's scale
    recv = _coll.all_to_all(q.reshape(n, -1), g, 0, 0).reshape(n, -1)
    scales = _coll.stack_gather(scale.reshape(()), g)             # (n,)
    partial = (recv.float() * scales[:, None]).sum(dim=0)
    # phase 2: the reduced shard quantized again and gathered
    q2, s2 = quantize_int8(partial)
    all_q = _coll.all_gather(q2, g, 0)
    all_s = _coll.stack_gather(s2.reshape(()), g)
    out = (all_q.reshape(n, -1).float() * all_s[:, None]).reshape(-1)
    err = xf - dequantize_int8(q, scale)
    if pad:
        out, err = out[:size], err[:size]
    return out.reshape(shape).to(dtype), err.reshape(shape).to(dtype)


def compressed_allreduce(x: torch.Tensor, axis_name, mode: str,
                         residual: Optional[torch.Tensor] = None,
                         mean: bool = False, world: Optional[int] = None):
    """Quantize -> all-reduce -> dequantize over the group bound to
    ``axis_name`` (or an ``AxisGroup``), with optional error feedback.
    Returns ``(reduced, new_residual)``; ``new_residual`` is None without a
    residual. ``mean=True`` averages (``c_allreduce_avg``)."""
    from ..ops import collective as _coll
    if mode not in ("bf16", "int8"):
        raise ValueError(f"comm compression mode must be bf16|int8 here, got {mode!r}")
    g = _group(axis_name)
    n = int(world) if world is not None else g.size
    local = x if residual is None else x + residual.to(x.dtype)
    if mode == "bf16":
        sent = local.to(torch.bfloat16)
        out = _coll.all_reduce_sum(sent, g).to(x.dtype)
        err = (local - sent.to(x.dtype)) if residual is not None else None
    else:
        out, err_all = _sum_int8(local, g)
        err = err_all if residual is not None else None
    if mean:
        out = out / n
    return out, err


# ----------------------------------------------------------- telemetry --

def record_collective(kind: str, dtype: str, raw_bytes: int, on_wire_bytes: int):
    """Wire-byte accounting of one collective call: per-device bytes by kind
    and on-wire dtype, the bytes before compression, and the cumulative
    compression ratio."""
    from ..observability.metrics import REGISTRY as _OBS
    _OBS.counter(
        "comm_bytes_total",
        "per-device interconnect bytes of the collectives run, by collective "
        "kind and on-wire dtype",
        kind=kind, dtype=dtype).inc(max(0, int(on_wire_bytes)))
    _OBS.counter(
        "comm_raw_bytes_total",
        "per-device interconnect bytes of the collectives run BEFORE "
        "compression (the full-width traffic)",
        kind=kind, dtype=dtype).inc(max(0, int(raw_bytes)))
    raw = wire = 0.0
    for fname in ("comm_raw_bytes_total", "comm_bytes_total"):
        fam = _OBS.get(fname)
        if fam is None:
            continue
        total = sum(child.value for _, child in fam.items())
        if fname == "comm_raw_bytes_total":
            raw = total
        else:
            wire = total
    if wire > 0:
        _OBS.gauge("comm_compress_ratio",
                   "cumulative pre-compression bytes / on-wire bytes over all "
                   "recorded collectives (1.0 = nothing compressed)").set(raw / wire)
