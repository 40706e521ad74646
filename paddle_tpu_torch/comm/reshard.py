"""Spec-to-spec redistribution planner (arXiv:2112.01075 framing).

Given a source sharding and a target sharding of one array, emit the
*minimal portable collective sequence* that realizes the transfer --
``all_gather`` / ``dynamic_slice`` / ``all_to_all`` /
``collective_permute`` steps, each priced in per-device wire bytes by
``comm.cost``.  One decomposition, three consumers:

- **lint**: ``analysis/distributed.py`` prices the PT046 ZeRO re-gather
  with the plan instead of a raw byte count;
- **lowering**: :func:`apply_transfer` executes a plan on a local block
  over a bound process group (the ``reshard`` op in ``ops/collective.py``,
  which the ZeRO update's slice and re-gather go through);
- **elastic reshard**: the host-chunk reshard of a checkpoint (ROADMAP
  item 13 (c) in the port).

The port's copy of ``paddle_tpu/comm/reshard.py``: the planner is the JAX
package's, pure metadata; ``apply_transfer`` runs on torch tensors.

The decomposition rules, most-specific first (``n`` = shard counts):

====================================  ==================================
src == dst (same regions, same rank)  ``keep`` -- no steps
same regions, ranks permuted          ``permute`` -- [collective_permute]
every dst region inside a src region  ``slice``  -- [dynamic_slice] (no
                                      comm: replicated->sharded, or a
                                      world-multiplying split)
every src region inside a dst region  ``gather`` -- [all_gather]
shard dim moves, same count           ``alltoall`` -- [all_to_all]
anything else                         ``redistribute`` --
                                      [all_gather, dynamic_slice]
====================================  ==================================
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

from . import cost as _cost

Region = List[List[int]]   # [[start, stop], ...] per dim


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """A single-axis sharding: ``dim`` split ``nshards`` ways over mesh
    axis ``axis`` (``dim=None`` = fully replicated)."""

    dim: Optional[int] = None
    nshards: int = 1
    axis: str = "dp"

    @property
    def sharded(self) -> bool:
        return self.dim is not None and self.nshards > 1


def regions_for(shape: Sequence[int], spec: ShardSpec) -> List[Region]:
    """Per-rank index regions of ``shape`` under ``spec`` (rank order).
    The sharded dim must divide evenly -- callers pick divisible dims
    (elastic.zero_shard_dim) or replicate."""
    full = [[0, int(s)] for s in shape]
    if not spec.sharded:
        return [full]
    d, n = spec.dim, spec.nshards
    if int(shape[d]) % n:
        raise ValueError(f"dim {d} (={shape[d]}) is not divisible by "
                         f"{n} shards")
    per = int(shape[d]) // n
    out = []
    for r in range(n):
        region = [list(x) for x in full]
        region[d] = [r * per, (r + 1) * per]
        out.append(region)
    return out


@dataclasses.dataclass
class TransferStep:
    """One collective (or local) step of a transfer plan."""

    collective: str            # all_gather|dynamic_slice|all_to_all|...
    dim: Optional[int]         # the dim the step gathers/slices/splits on
    wire_bytes: int            # per-device interconnect bytes
    detail: str = ""
    #: collective_permute only: the [src_rank, dst_rank] pairs (ppermute
    #: form) realizing the rank reassignment
    perm: Optional[List[List[int]]] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TransferPlan:
    """The planned collective sequence for one spec-to-spec transfer."""

    kind: str                  # keep|slice|gather|permute|alltoall|redistribute
    shape: List[int]
    dtype: str
    n_src: int
    n_dst: int
    steps: List[TransferStep]

    @property
    def collectives(self) -> List[str]:
        return [s.collective for s in self.steps]

    @property
    def wire_bytes(self) -> int:
        return sum(s.wire_bytes for s in self.steps)

    def to_dict(self) -> dict:
        return {"kind": self.kind, "shape": list(self.shape),
                "dtype": self.dtype, "n_src": self.n_src,
                "n_dst": self.n_dst, "wire_bytes": self.wire_bytes,
                "steps": [s.to_dict() for s in self.steps]}

    def summary(self) -> str:
        if not self.steps:
            return f"{self.kind}: no data movement"
        parts = ", ".join(
            f"{s.collective}" + (f"[dim {s.dim}]" if s.dim is not None
                                 else "")
            + (f" {s.wire_bytes} B/device" if s.wire_bytes else " local")
            for s in self.steps)
        return f"{self.kind}: {parts}"


def _nbytes(shape: Sequence[int], dtype: str) -> int:
    return _cost.payload_bytes(shape, dtype)


def _keys(regions: List[Region]):
    return [tuple(tuple(x) for x in r) for r in regions]


def _contains(outer: Region, inner: Region) -> bool:
    return all(oa <= ia and ib <= ob
               for (oa, ob), (ia, ib) in zip(outer, inner))


def _vary_dim(regions: List[Region]) -> Optional[int]:
    """The dim along which a region list is split (None = single/full)."""
    if len(regions) <= 1:
        return None
    for d in range(len(regions[0])):
        if len({tuple(r[d]) for r in regions}) > 1:
            return d
    return None


def _norm(shape, spec_or_regions) -> List[Region]:
    if isinstance(spec_or_regions, ShardSpec):
        return regions_for(shape, spec_or_regions)
    return [[list(x) for x in r] for r in spec_or_regions]


def plan_transfer(shape: Sequence[int], dtype: str,
                  src: Union[ShardSpec, List[Region]],
                  dst: Union[ShardSpec, List[Region]],
                  axis: str = "dp") -> TransferPlan:
    """Plan the minimal collective sequence moving an array of global
    ``shape``/``dtype`` from sharding ``src`` to sharding ``dst`` (each a
    :class:`ShardSpec` or an explicit rank-ordered region list, e.g. a
    checkpoint's chunk layout).  Pure metadata -- no device is touched."""
    shape = [int(s) for s in shape]
    srcs, dsts = _norm(shape, src), _norm(shape, dst)
    sk, dk = _keys(srcs), _keys(dsts)
    full = _nbytes(shape, dtype)
    n_src, n_dst = len(set(sk)), len(set(dk))

    def step(coll, dim, world, detail=""):
        return TransferStep(coll, dim,
                            _cost.wire_bytes(coll, full, world), detail)

    if sk == dk:
        return TransferPlan("keep", shape, dtype, n_src, n_dst, [])
    if set(sk) == set(dk):
        d = _vary_dim(srcs)
        s = step("collective_permute", d, n_src, "rank assignment changed")
        # the actual reassignment: src rank i's block lands on the dst
        # rank that owns the same region (ppermute (src, dst) pairs)
        s.perm = [[i, dk.index(k)] for i, k in enumerate(sk)]
        return TransferPlan("permute", shape, dtype, n_src, n_dst, [s])
    if all(any(_contains(s, r) for s in srcs) for r in dsts):
        # every destination block is readable locally from one source
        # block: replicated -> sharded, or a nested world-multiplying
        # split -- no communication
        return TransferPlan("slice", shape, dtype, n_src, n_dst,
                            [TransferStep("dynamic_slice", _vary_dim(dsts),
                                          0, "local slice, no comm")])
    if all(any(_contains(d, r) for d in dsts) for r in srcs):
        # every source block lands whole inside one destination block:
        # sharded -> replicated (or a world-dividing merge) = the gather
        return TransferPlan("gather", shape, dtype, n_src, n_dst,
                            [step("all_gather", _vary_dim(srcs), n_src)])
    sd, dd = _vary_dim(srcs), _vary_dim(dsts)
    if (sd is not None and dd is not None and sd != dd
            and n_src == n_dst):
        return TransferPlan("alltoall", shape, dtype, n_src, n_dst,
                            [step("all_to_all", dd, n_src,
                                  f"shard dim {sd} -> {dd}")])
    # boundary-incompatible resharding (e.g. 8 -> 6 on one dim): the
    # portable fallback -- materialize, then re-slice locally
    return TransferPlan("redistribute", shape, dtype, n_src, n_dst,
                        [step("all_gather", sd, n_src),
                         TransferStep("dynamic_slice", dd, 0,
                                      "re-slice after gather, no comm")])


def apply_transfer(x, plan: TransferPlan, axis_name="dp"):
    """Execute a plan on a local block over the process group bound to
    ``axis_name`` (or an ``ops.collective.AxisGroup``), which must have
    ``plan.n_src`` ranks. ``x`` is this rank's block of the source
    sharding; returns its block of the destination sharding. This is the
    lowering the ``reshard`` op uses: the decomposition the lint prices."""
    from ..ops import collective as _coll
    g = axis_name if isinstance(axis_name, _coll.AxisGroup) else _coll.bound(axis_name)
    if g is None:
        raise ValueError(f"apply_transfer: no process group is bound to axis "
                         f"{axis_name!r}")
    for s in plan.steps:
        if s.collective == "all_gather":
            x = _coll.all_gather(x, g, int(s.dim or 0))
        elif s.collective == "dynamic_slice":
            d = int(s.dim or 0)
            size = x.shape[d] // plan.n_dst
            x = x.narrow(d, g.rank * size, size)
        elif s.collective == "all_to_all":
            split = int(s.dim or 0)
            # concat dim = the previously sharded dim, recorded in detail
            concat = _parse_src_dim(s.detail, default=0)
            x = _coll.all_to_all(x, g, split, concat)
        elif s.collective == "collective_permute":
            if s.perm is None:
                raise ValueError(
                    "collective_permute step carries no rank mapping; "
                    "plans must come from plan_transfer")
            x = _coll.permute(x, g, [tuple(p) for p in s.perm])
        else:
            raise ValueError(f"unknown transfer step {s.collective!r}")
    return x


def _parse_src_dim(detail: str, default: int = 0) -> int:
    # "shard dim A -> B": A is the concat (previously sharded) dim
    try:
        return int(detail.split("shard dim", 1)[1].split("->")[0].strip())
    except (IndexError, ValueError):
        return default
