"""Wire-byte cost model for collectives: the pricing half of the comm layer.

One formula table answers "how many bytes cross the interconnect per
device for this collective" -- consumed by the PT046 lint (pricing the
ZeRO re-gather plan instead of hand-waving at it), the reshard planner
(per-step priced plans), the trace-time ``comm_bytes_total`` metrics, and
the ``bench.py --comm-sweep`` on-wire-reduction report.  The formulas are
the standard ring/bucket algorithm costs (the NCCL busbw convention the
BASELINE allreduce bench already uses), expressed per participating
device for a *global* payload of ``nbytes``:

==================  =====================================================
allreduce           ``2 (n-1)/n * nbytes``   (ring: reduce-scatter + gather)
allgather           ``(n-1)/n * nbytes``     (each device receives n-1 shards)
reducescatter       ``(n-1)/n * nbytes``
alltoall            ``(n-1)/n * nbytes / n`` (payload is one shard, re-split)
broadcast           ``(n-1)/n * nbytes``
permute             ``nbytes / n``           (one local shard forwarded)
dynamic_slice       ``0``                    (local, no communication)
==================  =====================================================

Compression changes the *on-wire element width*, not the formula:
``compressed_bytes`` scales a payload to what the quantizer actually
ships (bf16 = 2 bytes/elem, int8 = 1 byte/elem + a per-device f32 scale).
"""
from __future__ import annotations

from typing import Optional

#: bytes per element actually shipped, by compression mode
WIRE_ELEM_BYTES = {"off": None, "bf16": 2, "int8": 1}

#: collective kind -> (coefficient builder) used by :func:`wire_bytes`
_FORMULAS = {
    "allreduce": lambda n: 2.0 * (n - 1) / n,
    "allgather": lambda n: (n - 1) / n,
    "all_gather": lambda n: (n - 1) / n,
    "reducescatter": lambda n: (n - 1) / n,
    "alltoall": lambda n: (n - 1) / (n * n),
    "all_to_all": lambda n: (n - 1) / (n * n),
    "broadcast": lambda n: (n - 1) / n,
    "permute": lambda n: 1.0 / n,
    "collective_permute": lambda n: 1.0 / n,
    "dynamic_slice": lambda n: 0.0,
    "pipeline": lambda n: 1.0 / n,   # one stage boundary forwarded
    "reshard": lambda n: (n - 1) / n,  # upper bound: priced per plan step
}


def wire_bytes(kind: str, nbytes: int, world: int) -> int:
    """Per-device interconnect bytes for one ``kind`` collective moving a
    global payload of ``nbytes`` over ``world`` devices.  Unknown kinds
    price as an allgather (conservative); world <= 1 is always 0 (nothing
    crosses a wire)."""
    n = int(world)
    if n <= 1:
        return 0
    f = _FORMULAS.get(kind, _FORMULAS["allgather"])
    return int(f(n) * int(nbytes))


def dtype_wire_bytes(dtype: str) -> int:
    """Bytes per element a dtype ships uncompressed."""
    if dtype in ("bfloat16", "float16"):
        return 2
    if dtype in ("float64", "int64", "uint64"):
        return 8
    if dtype in ("int8", "uint8", "bool"):
        return 1
    if dtype in ("int16", "uint16"):
        return 2
    return 4


def payload_bytes(shape, dtype: str) -> int:
    """Bytes of one full tensor of ``shape``/``dtype`` (the shared size
    helper behind the rewrite's compression floor and the planner's
    pricing -- one convention, zero-dims count as 1)."""
    n = dtype_wire_bytes(dtype)
    for s in shape:
        n *= max(1, int(s))
    return n


def compressed_bytes(nbytes: int, dtype: str, mode: str,
                     world: Optional[int] = None) -> int:
    """What ``nbytes`` of ``dtype`` payload becomes on the wire under
    compression ``mode`` ('off' returns it unchanged).  int8 adds one f32
    scale per participating device (negligible, but counted so the ratio
    is honest on tiny tensors)."""
    w = WIRE_ELEM_BYTES.get(mode)
    if w is None:
        return int(nbytes)
    elem = dtype_wire_bytes(dtype)
    n_elem = int(nbytes) // max(1, elem)
    out = n_elem * w
    if mode == "int8":
        out += 4 * max(1, int(world or 1))   # per-device f32 scales
    return out


def compression_ratio(nbytes: int, dtype: str, mode: str,
                      world: Optional[int] = None) -> float:
    """On-wire reduction factor (>= 1.0 means compression shrinks it)."""
    c = compressed_bytes(nbytes, dtype, mode, world)
    return float(nbytes) / c if c else 1.0
