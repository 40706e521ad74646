"""Communication-efficiency layer: quantized gradient collectives + the
spec-to-spec redistribution planner.

The layer between ``DistributedStrategy`` and the collective lowerings
(ROADMAP "comm efficiency at scale"; EQuARX arXiv:2506.17615 + the
redistribution decomposition of arXiv:2112.01075):

- ``compress``: bf16/int8 quantized allreduce with per-tensor
  error-feedback residuals (``DistributedStrategy.comm_compression``);
- ``rewrite``: the compile-time explicit-dp gradient-sync rewrite the
  executor applies when compression is on;
- ``reshard``: ``plan_transfer`` -- the minimal collective sequence for a
  spec-to-spec transfer, shared by the PT046 lint, the ``reshard`` op
  lowering and ``resilience/elastic.py``'s host-chunk reshard;
- ``cost``: per-device wire-byte pricing for every collective kind.

The port's copy of ``paddle_tpu/comm/``: the same functions on torch
tensors over ``torch.distributed`` process groups (``ops/collective.py``
binds a mesh axis to one). In the port ``rewrite.sync_program`` runs for
every data-parallel program: its data parallel is the explicit path.

CLI: ``python -m paddle_tpu_torch.comm --selftest`` (hermetic).
"""
from __future__ import annotations

from .compress import (MIN_COMPRESS_BYTES, MODES, RESIDUAL_SUFFIX,
                       SUPPORTED_DTYPES, compressed_allreduce,
                       dequantize_int8, is_residual, quantize_int8,
                       record_collective, residual_name)
from .cost import (compressed_bytes, compression_ratio, dtype_wire_bytes,
                   wire_bytes)
from .reshard import (ShardSpec, TransferPlan, TransferStep, apply_transfer,
                      plan_transfer, regions_for)
from .rewrite import (compression_eligible, optimizer_grad_vars,
                      planned_residual_bytes, sync_program)

__all__ = [
    "MIN_COMPRESS_BYTES", "MODES", "RESIDUAL_SUFFIX", "SUPPORTED_DTYPES",
    "compressed_allreduce", "quantize_int8", "dequantize_int8",
    "is_residual", "residual_name", "record_collective",
    "wire_bytes", "compressed_bytes", "compression_ratio",
    "dtype_wire_bytes",
    "ShardSpec", "TransferPlan", "TransferStep", "plan_transfer",
    "apply_transfer", "regions_for",
    "sync_program", "optimizer_grad_vars", "compression_eligible",
    "planned_residual_bytes",
    "selftest",
]


def selftest(verbose: bool = False) -> int:
    """Hermetic self-check (no device search, no tuning, no network):
    quantize/dequantize round-trip bounds, error-feedback bias decay,
    planner decomposition cases, wire-byte formulas, and the rewrite's
    idempotence on a tiny in-memory program.  Returns the number of
    failed checks (0 = pass)."""
    from .__main__ import run_selftest
    return run_selftest(verbose=verbose)
