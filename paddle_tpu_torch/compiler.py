"""CompiledProgram and the strategies (the port's copy of
``paddle_tpu/compiler.py``; reference python/paddle/fluid/compiler.py:138,
details/build_strategy.h:38).

The JAX package compiles a program under a ``DistributedStrategy`` onto a
``jax.sharding.Mesh`` and lets GSPMD insert the collectives. The port maps
the mesh onto processes, one rank a process over ``torch.distributed``
(``parallel/env.py``), the axes in ``mesh_shape`` order with the last
fastest, as the JAX mesh lays its devices out, and one process group for
each slice of each axis larger than 1. The executor binds this rank's
groups for the run (``ops/collective.py::bind``) and runs each axis
explicitly:

- ``dp`` (the data axis): each rank runs the step on its rows of the global
  batch, the program's gradients pass through ``c_allreduce_avg`` ops
  before the update (``comm/rewrite.py``;
  ``GradientScaleStrategy.CoeffNumDevice``), and the state stays
  replicated. ``ReduceStrategy.Reduce`` shards the optimizer accumulators
  over dp (ZeRO): each rank keeps and updates its block of them, and the
  parameters are gathered after the update (``zero_program``); with
  ``reduce_params`` the parameters themselves are held as blocks and
  gathered where they are read.
- ``pp``: the ``temporal_pipeline`` op runs the GPipe schedule, one stage a
  rank (``parallel/pipeline.py``); ``PipelineOptimizer.pp_param_rules()``
  holds each ``@pp_stacked`` parameter and its optimizer state as this
  rank's stage's block.
- ``sp``: each rank feeds its block of the positions (a data rule such as
  ``("x", ("dp", "sp"))``) and ``fused_attention`` runs ring or Ulysses
  attention over the group (``parallel/ring_attention.py``,
  ``parallel/ulysses.py``). So sp runs position-local programs whose only
  op across positions is ``fused_attention``: it raises for what neither
  path takes (``impl`` 'composed' or 'pallas', a bias other than
  [B,1,1,S]), but nothing refuses another op that mixes positions (MLM's
  flat ``mask_pos`` gather, the pooler's position 0), which would compute
  on this rank's block alone.

The gradients and a fetched loss are averaged over the ranks that hold the
same stage (``sync_axis``: dp and sp together), never over pp.

Not run yet: the ``mp`` and ``ep`` axes and their parameter rules (tensor
and expert sharding, ROADMAP item 13 (b)'s second part), ``auto_shard``
other than ``off`` (item 13 (c)), and ZeRO together with pp or sp: each
raises.
"""
from __future__ import annotations

import re
import warnings
from typing import Dict, List, Optional, Tuple

from .framework import Program

_warned_knobs = set()

ITEM_13B = ("ROADMAP item 13 (b), second part: tensor and expert sharding (the mp and "
            "ep axes and their param_rules)")
#: the mesh axes the port runs besides the data axis
RUN_AXES = ("pp", "sp")
ITEM_13C = "ROADMAP item 13 (c): the auto-sharding planner"

#: update ops that are elementwise in every state slot: their update of a
#: block is the block of their update (ZeRO may shard their accumulators);
#: lamb and lars_momentum take norms over the whole parameter
ZERO_UPDATE_OPS = ("sgd", "momentum", "adam", "adamw", "adamax", "adagrad",
                   "decayed_adagrad", "adadelta", "rmsprop", "ftrl")


def _warn_noop_knob(name: str, why: str):
    """Warn once when a knob with no effect in the port is changed."""
    if name in _warned_knobs:
        return
    _warned_knobs.add(name)
    warnings.warn(f"paddle_tpu_torch: {name!r} has no effect in the port ({why})",
                  UserWarning, stacklevel=3)


class ExecutionStrategy:
    """Knob parity with the reference (details/execution_strategy.h); the
    port's executor runs one stream a step, so the knobs have no effect."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class BuildStrategy:
    """Reference details/build_strategy.h:38. ``reduce_strategy=Reduce`` is
    real: the optimizer accumulators are sharded over dp (ZeRO), and with
    ``reduce_params`` the parameters too. The fusion and memory knobs are
    what the port's executor always does; changing one warns once."""

    class ReduceStrategy:
        AllReduce = 0   # replicated params (default)
        Reduce = 1      # shard optimizer states/params over dp (ZeRO-like)

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    _NOOP_KNOBS = {
        "enable_sequential_execution": "the executor runs the ops in program order",
        "fuse_all_reduce_ops": "one c_allreduce_avg a gradient; a captured step "
                               "launches them from one CUDA graph",
        "fuse_elewise_add_act_ops": "the lowerings are fixed; fusions are the "
                                    "hand-written kernels'",
        "fuse_all_optimizer_ops": "consecutive update ops always run as one "
                                  "multi-tensor update",
        "memory_optimize": "the executor always frees a variable after its last reader",
        "enable_inplace": "the update ops always write their state in place",
        "sync_batch_norm": "batch_norm always sums its statistics over the dp group",
    }

    def __init__(self):
        object.__setattr__(self, "_init_done", False)
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        # Reduce mode shards the optimizer state over dp; reduce_params also
        # holds the parameters as blocks, gathered where they are read
        self.reduce_params = False
        self.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.debug_graphviz_path = ""
        self.enable_sequential_execution = False
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.fuse_all_optimizer_ops = True
        self.memory_optimize = True
        self.enable_inplace = True
        self.sync_batch_norm = True
        object.__setattr__(self, "_init_done", True)

    def __setattr__(self, name, value):
        if getattr(self, "_init_done", False) and name in self._NOOP_KNOBS \
                and value != getattr(self, name, value):
            _warn_noop_knob(f"BuildStrategy.{name}", self._NOOP_KNOBS[name])
        if getattr(self, "_init_done", False) and name == "gradient_scale_strategy" \
                and value != BuildStrategy.GradientScaleStrategy.CoeffNumDevice:
            raise NotImplementedError(
                "BuildStrategy.gradient_scale_strategy: the port averages the "
                "gradients over the dp ranks (CoeffNumDevice), as the JAX package does")
        object.__setattr__(self, name, value)


class DistributedStrategy:
    """The mesh and sharding configuration (the port of the JAX package's
    ``DistributedStrategy``; reference incubate/fleet/collective:94).

    mesh_shape: ordered {axis_name: size}, mapped onto the ranks in order,
      the last axis fastest (``build_mesh``); the port runs the data axis,
      ``pp`` and ``sp`` (``mp`` and ``ep`` are ROADMAP item 13 (b)'s second
      part and raise at the run).
    param_rules: [(regex, spec)] matched against parameter names; the port
      runs rules whose axes are ``pp`` on dim 0
      (``PipelineOptimizer.pp_param_rules()``): each pp rank holds its
      block. Rules naming other axes raise at the run.
    data_rules: [(regex, spec)] for feeds; by default dim 0 is split over
      the data axis (each rank feeds its rows); ``(data_axis, "sp")`` also
      splits dim 1, the positions, over sp (each rank feeds its block).
    comm_compression: 'off'|'bf16'|'int8': the dp gradient all-reduce
      quantized, with a per-tensor error-feedback residual (``comm/``).
    auto_shard: 'off' only in the port ('static' / 'measure' are item 13 (c)).
    """

    AUTO_SHARD_MODES = ("off", "static", "measure")

    def __init__(self, mesh_shape: Optional[Dict[str, int]] = None,
                 param_rules: Optional[List[Tuple[str, Tuple]]] = None,
                 data_rules: Optional[List[Tuple[str, Tuple]]] = None,
                 data_axis: str = "dp",
                 comm_compression: str = "off",
                 auto_shard: str = "off"):
        self.mesh_shape = dict(mesh_shape or {})
        self.param_rules = list(param_rules or [])
        self.data_rules = list(data_rules or [])
        self.data_axis = data_axis
        self.comm_compression = comm_compression
        self.auto_shard = auto_shard
        from .comm.compress import MIN_COMPRESS_BYTES
        self.comm_compress_min_bytes = MIN_COMPRESS_BYTES
        self.use_hierarchical_allreduce = False
        self.nccl_comm_num = 1

    def __setattr__(self, name, value):
        if name == "comm_compression":
            from .comm.compress import MODES
            if value not in MODES:
                raise ValueError(f"comm_compression must be one of {MODES}, got {value!r}")
        if name == "auto_shard" and value not in self.AUTO_SHARD_MODES:
            raise ValueError(f"auto_shard must be one of {self.AUTO_SHARD_MODES}, "
                             f"got {value!r}")
        if name == "use_hierarchical_allreduce" and value:
            _warn_noop_knob("DistributedStrategy.use_hierarchical_allreduce",
                            "one process group spans the ranks; NCCL picks its "
                            "own rings and trees")
        if name == "nccl_comm_num" and value not in (None, 1):
            _warn_noop_knob("DistributedStrategy.nccl_comm_num",
                            "one NCCL communicator a process group")
        object.__setattr__(self, name, value)

    # -- serialization -----------------------------------------------------------------
    def to_dict(self) -> dict:
        return {"mesh_shape": dict(self.mesh_shape),
                "param_rules": [[p, list(s)] for p, s in self.param_rules],
                "data_rules": [[p, list(s)] for p, s in self.data_rules],
                "data_axis": self.data_axis,
                "comm_compression": self.comm_compression,
                "comm_compress_min_bytes": self.comm_compress_min_bytes,
                "auto_shard": self.auto_shard}

    @staticmethod
    def from_dict(d: dict) -> "DistributedStrategy":
        """A strategy from the JSON shape ``to_dict`` emits. Spec entries may
        be axis names, null (a replicated dim) or lists of axis names."""

        def spec(entries):
            return tuple(tuple(e) if isinstance(e, list) else e for e in entries)

        ds = DistributedStrategy(
            mesh_shape=dict(d.get("mesh_shape") or {}),
            param_rules=[(p, spec(s)) for p, s in d.get("param_rules") or []],
            data_rules=[(p, spec(s)) for p, s in d.get("data_rules") or []],
            data_axis=d.get("data_axis", "dp"),
            comm_compression=d.get("comm_compression", "off"),
            auto_shard=d.get("auto_shard", "off"))
        if "comm_compress_min_bytes" in d:
            ds.comm_compress_min_bytes = int(d["comm_compress_min_bytes"])
        return ds

    # -- mesh --------------------------------------------------------------------------
    def build_mesh(self, world: Optional[int] = None) -> Dict[str, int]:
        """The mesh as an ordered {axis: size} over ``world`` ranks (the
        ``torch.distributed`` world, 1 without a process group); an empty
        ``mesh_shape`` becomes {data_axis: world}. The product must equal
        the world: each rank is one device of the mesh."""
        if world is None:
            from .parallel import env as _penv
            world = _penv.dist_world_size()
        if not self.mesh_shape:
            self.mesh_shape = {self.data_axis: int(world)}
        n = 1
        for s in self.mesh_shape.values():
            n *= int(s)
        if n != int(world):
            raise ValueError(f"mesh {self.mesh_shape} needs {n} ranks, the process "
                             f"group has {world} (one rank a device)")
        return dict(self.mesh_shape)

    def check_supported(self) -> None:
        """Raise for what the port does not run yet: an axis other than the
        data axis, ``pp`` and ``sp`` larger than 1, a parameter rule that
        names another axis than ``pp`` or splits another dim than 0,
        ``auto_shard``, a data rule that splits a dim other than 0 over the
        data axis and 1 over sp."""
        other = {a: s for a, s in self.mesh_shape.items()
                 if a != self.data_axis and a not in RUN_AXES and int(s) > 1}
        if other:
            raise NotImplementedError(f"mesh axes {other}: {ITEM_13B}")
        for pat, spec in self.param_rules:
            entries = tuple(spec)
            axes = [a for e in entries for a in (e if isinstance(e, (tuple, list)) else (e,))
                    if a is not None]
            if any(a != "pp" for a in axes) or any(e is not None for e in entries[1:]):
                raise NotImplementedError(
                    f"param_rules ({pat!r}, {spec}): {ITEM_13B}; the port runs rules that "
                    f"split dim 0 over 'pp' (PipelineOptimizer.pp_param_rules(); ZeRO over "
                    f"dp is BuildStrategy.ReduceStrategy.Reduce)")
        if self.auto_shard != "off":
            raise NotImplementedError(f"auto_shard={self.auto_shard!r}: {ITEM_13C}")
        for pat, spec in self.data_rules:
            spec = tuple(spec)
            if any(e is not None for e in spec[2:]) or \
                    (spec and spec[0] not in (None, self.data_axis)) or \
                    (len(spec) > 1 and spec[1] not in (None, "sp")):
                raise NotImplementedError(
                    f"data rule {pat!r} -> {spec}: the port splits a feed's dim 0 over "
                    f"{self.data_axis!r} and its dim 1 over 'sp', or replicates them; "
                    f"{ITEM_13B}")

    def sync_axis(self) -> str:
        """The name the gradient sync and the fetch reduction bind: the
        ranks that hold the same stage, the data axis and ``sp`` together
        (``"dp+sp"`` when both are larger than 1, else the one that is, else
        the data axis)."""
        axes = [a for a in (self.data_axis, "sp") if int(self.mesh_shape.get(a, 1)) > 1]
        return "+".join(axes) if axes else self.data_axis

    def sync_size(self) -> int:
        """The ranks the gradients are averaged over: dp x sp."""
        n = 1
        for a in {self.data_axis, "sp"}:
            n *= int(self.mesh_shape.get(a, 1))
        return n

    # -- sharding specs ----------------------------------------------------------------
    def param_spec(self, name: str) -> tuple:
        """The spec of parameter ``name``: its first matching rule's, else
        replicated (``()``)."""
        for pat, spec in self.param_rules:
            if re.search(pat, name):
                return tuple(spec)
        return ()

    def data_spec(self, name: str, ndim: int) -> tuple:
        """The spec of feed ``name``: its first matching data rule's, else
        dim 0 over the data axis."""
        for pat, spec in self.data_rules:
            if re.search(pat, name):
                return tuple(spec)
        if ndim == 0:
            return ()
        return (self.data_axis,) + (None,) * (ndim - 1)


class CompiledProgram:
    """Wrap a Program with a distribution strategy (reference compiler.py:138).
    ``with_data_parallel`` keeps the reference's signature; ``with_strategy``
    takes a ``DistributedStrategy``. ``Executor.run`` and ``run_fused`` take
    the wrapper."""

    def __init__(self, program: Program, build_strategy: Optional[BuildStrategy] = None):
        self.program = program
        self.build_strategy = build_strategy or BuildStrategy()
        self.exec_strategy = ExecutionStrategy()
        self.dist_strategy: Optional[DistributedStrategy] = None
        self._mesh = None
        #: (key) -> the ZeRO copy of the program (``zero_program``)
        self._zero = None
        #: ((program id, version), name -> ZeRO role), ``state_sharding``'s
        self._roles = None
        #: (key, [(name, (dim, ndp))]): the split state, ``Executor._shard_state``'s
        self._split = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None):
        if build_strategy is not None:
            self.build_strategy = build_strategy
        if exec_strategy is not None:
            self.exec_strategy = exec_strategy
        self.dist_strategy = DistributedStrategy()   # pure dp over every rank
        if places is not None:
            self.dist_strategy.mesh_shape = {"dp": len(places)}
        self._mesh = None
        return self

    def with_strategy(self, dist_strategy: DistributedStrategy):
        self.dist_strategy = dist_strategy
        self._mesh = None
        return self

    def strategy_signature(self) -> tuple:
        """Content signature of the strategy (a changed strategy must not
        reuse a step made for the old one)."""
        ds = self.dist_strategy
        if ds is None:
            return ()
        return (tuple(sorted(ds.mesh_shape.items())),
                tuple((p, tuple(s)) for p, s in ds.param_rules),
                tuple((p, tuple(s)) for p, s in ds.data_rules),
                ds.data_axis, self.build_strategy.reduce_strategy,
                getattr(self.build_strategy, "reduce_params", False),
                getattr(ds, "comm_compression", "off"),
                getattr(ds, "comm_compress_min_bytes", None),
                getattr(ds, "auto_shard", "off"))

    @property
    def mesh(self) -> Optional[Dict[str, int]]:
        """The mesh description {axis: size} over the process group's ranks."""
        if self._mesh is None and self.dist_strategy is not None:
            self._mesh = self.dist_strategy.build_mesh()
        return self._mesh

    def zero_mode(self) -> bool:
        """``ReduceStrategy.Reduce`` over a data axis of more than one rank."""
        mesh = self.mesh or {}
        return (self.build_strategy.reduce_strategy == BuildStrategy.ReduceStrategy.Reduce
                and int(mesh.get(self.dist_strategy.data_axis, 1)) > 1)

    def state_sharding(self, name: str):
        """How persistable ``name`` is held, one source of truth for the
        executor and the checkpoints: None without a strategy, ``()`` when
        replicated, else ``(dim, n, axis)``: each rank holds block (its
        index on ``axis``) of ``dim``, one of ``n``. An error-feedback
        residual is ``(0, ndp, data axis)`` (each rank its own row). A
        parameter rule over ``pp`` (``PipelineOptimizer.pp_param_rules()``)
        splits dim 0 over the pp ranks. Under ``ReduceStrategy.Reduce`` an
        optimizer accumulator of an elementwise update
        (``ZERO_UPDATE_OPS``) is split on its first dim that ndp divides, and
        with ``reduce_params`` its parameter too; one with no such dim stays
        replicated (warned once)."""
        ds = self.dist_strategy
        if ds is None:
            return None
        mesh = self.mesh or {}
        ndp = int(mesh.get(ds.data_axis, 1))
        from .comm.compress import is_residual
        if is_residual(name):
            return (0, ndp, ds.data_axis)
        npp = int(mesh.get("pp", 1))
        if npp > 1:
            spec = ds.param_spec(name)
            if spec and spec[0] == "pp":
                return (0, npp, "pp")
        if not self.zero_mode():
            return ()
        key = (id(self.program), self.program._version)
        if self._roles is None or self._roles[0] != key:
            self._roles = (key, _zero_roles(self.program))
        role = self._roles[1].get(name)
        if role is None or (role == "param" and not self.build_strategy.reduce_params):
            return ()
        v = self.program.global_block().find_var_recursive(name)
        dim = zero_shard_dim(v.shape, ndp) if v is not None else None
        if dim is None:
            if v is not None and any(isinstance(s, int) and s > ndp for s in v.shape) \
                    and name not in _warned_knobs:
                _warned_knobs.add(name)
                warnings.warn(
                    f"paddle_tpu_torch: ReduceStrategy.Reduce keeps {name!r} replicated: "
                    f"no dim of shape {tuple(v.shape)} divides dp={ndp} (other state "
                    f"still shards)")
            return ()
        return (dim, ndp, ds.data_axis)


def zero_shard_dim(shape, ndp: int) -> Optional[int]:
    """The first dim of ``shape`` that ``ndp`` divides (None: none does, or
    ndp <= 1): the dim a ZeRO-sharded variable is split on."""
    if ndp <= 1:
        return None
    for d, s in enumerate(shape):
        if isinstance(s, int) and s > 0 and s % ndp == 0:
            return d
    return None


def _zero_roles(program: Program) -> Dict[str, str]:
    """name -> 'param' | 'accum' for the state slots of the program's
    elementwise update ops: the variables ZeRO may shard. A scalar-like
    accumulator (a beta power) is listed and stays replicated by shape."""
    roles: Dict[str, str] = {}
    for op in program.global_block().ops:
        if op.type not in ZERO_UPDATE_OPS:
            continue
        for slot, names in op.inputs.items():
            if slot in ("Param",):
                for n in names:
                    roles.setdefault(n, "param")
            elif slot not in ("Grad", "LearningRate") and "Pow" not in slot:
                for n in names:
                    roles.setdefault(n, "accum")
    return roles


def zero_program(cp: CompiledProgram, program: Program) -> Program:
    """The ZeRO copy of ``program`` (after the gradient sync) for
    ``cp``'s strategy, cached on ``cp`` by (program, version, signature).

    Around each elementwise update op whose state is sharded: its gradient
    (and, without ``reduce_params``, its parameter) is sliced to this rank's
    block (a ``reshard`` to the shard dim: a local slice), the op updates
    the blocks, and the new parameter block is gathered back (a ``reshard``
    from the shard dim: the all-gather). With ``reduce_params`` the
    parameter stays a block, and every other reader of it reads a gathered
    copy made at the start of the step. The slices go before the run of
    update ops and the gathers after it, so the updates stay one grouped
    multi-tensor update."""
    key = (id(program), program._version, cp.strategy_signature())
    if cp._zero is not None and cp._zero[0] == key and cp._zero[1] is program:
        return cp._zero[2]
    zp = program.clone()
    zp._rng_run_counter = getattr(program, "_rng_run_counter", 0)
    gb = zp.global_block()
    axis = cp.dist_strategy.data_axis
    rp = cp.build_strategy.reduce_params

    def sharded(n):
        s = cp.state_sharding(n)
        return s[0] if s else None

    gathered: Dict[str, str] = {}
    if rp:
        # the full copy of each sharded parameter, made first in the step
        for op in gb.ops:
            if op.type in ZERO_UPDATE_OPS:
                p = op.inputs["Param"][0]
                d = sharded(p)
                if d is not None and p not in gathered:
                    gathered[p] = f"{p}@ZERO_FULL"
        for i, op in enumerate(list(gb.ops)):
            if op.type in ZERO_UPDATE_OPS:
                continue
            for slot, names in op.inputs.items():
                op.inputs[slot] = [gathered.get(n, n) for n in names]
        for b in zp.blocks[1:]:
            for op in b.ops:
                for slot, names in op.inputs.items():
                    op.inputs[slot] = [gathered.get(n, n) for n in names]
        for k, (p, full) in enumerate(gathered.items()):
            v = gb.vars[p]
            gb.create_var(full, shape=tuple(v.shape), dtype=v.dtype)
            gb.insert_op(k, "reshard", inputs={"X": [p]}, outputs={"Out": [full]},
                         attrs={"axis_name": axis, "src_dim": sharded(p), "dst_dim": -1},
                         infer_shape=False)
    i = 0
    while i < len(gb.ops):
        if gb.ops[i].type not in ZERO_UPDATE_OPS:
            i += 1
            continue
        end = i
        while end < len(gb.ops) and gb.ops[end].type in ZERO_UPDATE_OPS:
            end += 1
        before, after = [], []
        for op in gb.ops[i:end]:
            p = op.inputs["Param"][0]
            d = sharded(p) if rp else None
            accs = [n for s, ns in op.inputs.items()
                    if s not in ("Param", "Grad", "LearningRate") for n in ns]
            acc_dims = {sharded(n) for n in accs} - {None}
            if d is None and not acc_dims:
                continue
            d = d if d is not None else acc_dims.pop()
            g = op.inputs["Grad"][0]
            gv = gb.find_var_recursive(g)
            blk = f"{g}@ZERO_BLOCK"
            gb.create_var(blk, shape=tuple(gv.shape), dtype=gv.dtype)
            before.append(("reshard", {"X": [g]}, {"Out": [blk]},
                           {"axis_name": axis, "src_dim": -1, "dst_dim": d}))
            op.inputs["Grad"] = [blk]
            if not rp:
                pv = gb.vars[p]
                pblk = f"{p}@ZERO_BLOCK"
                gb.create_var(pblk, shape=tuple(pv.shape), dtype=pv.dtype)
                before.append(("reshard", {"X": [p]}, {"Out": [pblk]},
                               {"axis_name": axis, "src_dim": -1, "dst_dim": d}))
                op.inputs["Param"] = [pblk]
                op.outputs["ParamOut"] = [pblk]
                after.append(("reshard", {"X": [pblk]}, {"Out": [p]},
                              {"axis_name": axis, "src_dim": d, "dst_dim": -1}))
        for k, (t, ins, outs, attrs) in enumerate(before):
            gb.insert_op(i + k, t, inputs=ins, outputs=outs, attrs=attrs, infer_shape=False)
        end += len(before)
        for k, (t, ins, outs, attrs) in enumerate(after):
            gb.insert_op(end + k, t, inputs=ins, outputs=outs, attrs=attrs,
                         infer_shape=False)
        i = end + len(after)
    cp._zero = (key, program, zp)
    return zp
