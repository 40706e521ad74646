"""Explicit data-parallel gradient-sync rewrite (the port's copy of
``paddle_tpu/comm/rewrite.py``).

The JAX package has two data-parallel paths: GSPMD, whose partitioner
reduces the gradients implicitly, and, with ``comm_compression`` on, the
explicit path: the step runs per shard on the local batch and this rewrite
inserts one ``c_allreduce_avg`` per optimizer-consumed gradient::

    grad --[c_allreduce_avg{comm_compress: off|bf16|int8}]--> grad

The port has no GSPMD, so its data parallel *is* the explicit path: the
executor calls ``sync_program(program, wrapper, explicit=True)`` for every
run of a data-parallel ``CompiledProgram``, and compression ``off`` (or a
world of 1, or ``ReduceStrategy.Reduce``, or a tensor under the floor) is a
plain ``c_allreduce_avg``. Over a mesh with a ``pp`` or ``sp`` axis the
explicit sync averages over the ranks that hold the same stage (dp and sp
together, ``DistributedStrategy.sync_axis``), uncompressed. Called as the
JAX function is (``explicit``
False), it keeps the JAX contract: ``off``, world 1, a multi-axis mesh,
``ReduceStrategy.Reduce``, no optimizer gradients or an orphan gradient
strip any earlier rewrite and return None.

Per-tensor compression is the ``comm.compress`` TunableChoice gated by a
hard floor. A compressed tensor gets an error-feedback residual persistable
``<grad>@comm_residual`` declared ``(ndp, *grad.shape)``; each process
holds its own ``(1, *grad.shape)`` block of it, zeroed by the executor and
left out of checkpoints.

The rewrite is idempotent: a warm re-sync is a token compare with no
mutation (no ``_version`` bump, no new capture); it mutates only when the
knob, the world or a tuning decision changed.
"""
from __future__ import annotations

import warnings
from typing import Dict, List, Optional, Tuple

from . import compress as _compress

#: attr stamped on ops this rewrite inserted (so re-syncs recognize them)
SYNC_ATTR = "__comm_sync__"

_warned = set()


def _warn_once(key: str, msg: str):
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(f"paddle_tpu_torch.comm: {msg}", UserWarning, stacklevel=3)


def optimizer_grad_vars(program) -> List[Tuple[str, str]]:
    """(param, grad) pairs the program's optimizer ops consume, in op
    order -- the dp-crossing gradients.  Detection is slot-based (ops
    with both 'Param' and 'Grad' inputs), so SGD/Momentum/Adam/... and
    clipped/regularized grad names all qualify without a name convention.
    Shared by the rewrite, the PT048 lint and the memplan overhead
    model."""
    out, seen = [], set()
    for op in program.global_block().ops:
        if "Param" not in op.inputs or "Grad" not in op.inputs:
            continue
        params = op.inputs.get("Param") or [None]
        for p, g in zip(params, op.inputs["Grad"]):
            if g and g not in seen:
                seen.add(g)
                out.append((p or "", g))
    return out


def compression_eligible(v, mode: str, min_bytes: int) -> Tuple[bool, str]:
    """(eligible, why_not) for one gradient var under ``mode``.  The hard
    gates the TunableChoice can never override: dtype support, static
    shape, and the size floor."""
    if v is None:
        return False, "no declared var"
    if v.dtype not in _compress.SUPPORTED_DTYPES:
        return False, f"dtype {v.dtype} unsupported"
    if any(not isinstance(s, int) or s <= 0 for s in v.shape):
        return False, "dynamic shape"
    nbytes = _var_bytes(v)
    if nbytes < max(0, int(min_bytes)):
        return False, f"{nbytes} B under the {min_bytes} B floor"
    return True, ""


def _var_bytes(v) -> int:
    from . import cost as _cost
    return _cost.payload_bytes(v.shape, v.dtype)


def _decide_tensor(v, mode: str, ndp: int, min_bytes: int) -> str:
    """'off'|'bf16'|'int8' for one gradient tensor: the hard gates, then
    the ``comm.compress`` TunableChoice (measured on the live workload
    via ``tuning.record_decision``, like ``fuse_steps.k``)."""
    ok, _ = compression_eligible(v, mode, min_bytes)
    if not ok:
        return "off"
    from .. import tuning as _tuning
    verdict = _tuning.decide(
        "comm.compress",
        {"nbytes": _var_bytes(v), "dtype": v.dtype, "world": int(ndp),
         "mode": mode, "min_bytes": int(min_bytes)},
        allow_search=False)
    return mode if verdict == "on" else "off"


def _strategy_fields(wrapper):
    ds = wrapper.dist_strategy
    mode = getattr(ds, "comm_compression", "off")
    min_bytes = int(getattr(ds, "comm_compress_min_bytes",
                            _compress.MIN_COMPRESS_BYTES))
    dp_axis = ds.data_axis
    sizes = dict(ds.mesh_shape or {})
    ndp = int(sizes.get(dp_axis, 1))
    multi_axis = any(int(n) > 1 for ax, n in sizes.items() if ax != dp_axis)
    return ds, mode, min_bytes, dp_axis, ndp, multi_axis


def _strip(program) -> bool:
    """Remove any previously inserted sync ops + residual slots; True if
    anything changed."""
    gb = program.global_block()
    keep, changed = [], False
    for op in gb.ops:
        if op.attr(SYNC_ATTR):
            changed = True
            continue
        keep.append(op)
    if changed:
        gb.ops[:] = keep
    dead = [n for n in gb.vars if _compress.is_residual(n)]
    for n in dead:
        del gb.vars[n]
        changed = True
    if getattr(program, "_comm_explicit", None) is not None:
        program._comm_explicit = None
        changed = True
    return changed


def sync_program(program, wrapper, explicit: bool = False) -> Optional[dict]:
    """Idempotently (re)apply the explicit-dp gradient-sync rewrite for
    ``wrapper``'s strategy. Returns the active plan info dict (also stored
    as ``program._comm_explicit``) or None when there is nothing to sync.
    ``explicit``: the executor's data-parallel path, where every optimizer
    gradient is synchronised (uncompressed where compression does not
    apply); without it, the JAX contract (None wherever the JAX package
    keeps its GSPMD path). Warm calls are a token compare."""
    from ..compiler import BuildStrategy
    ds, mode, min_bytes, dp_axis, ndp, multi_axis = _strategy_fields(wrapper)
    from .. import tuning as _tuning
    token = (mode, min_bytes, dp_axis, ndp, multi_axis,
             tuple(sorted((ds.mesh_shape or {}).items())),
             wrapper.build_strategy.reduce_strategy, bool(explicit),
             _tuning.state_token())
    cached = getattr(program, "_comm_sync_token", None)
    if cached is not None and cached[0] == token \
            and cached[1] == program._version:
        return getattr(program, "_comm_explicit", None)

    reasons = []
    if mode not in _compress.MODES:
        raise ValueError(f"comm_compression must be one of "
                         f"{_compress.MODES}, got {mode!r}")
    zero = (wrapper.build_strategy.reduce_strategy == BuildStrategy.ReduceStrategy.Reduce)
    if explicit:
        if multi_axis:
            # over a pp or sp mesh the gradients are averaged over the ranks
            # that hold the same stage, dp and sp together, never over pp
            dp_axis, ndp = ds.sync_axis(), ds.sync_size()
            if mode != "off":
                _warn_once("fallback:multi_axis", f"comm_compression={mode!r} ignored: "
                           "the mesh has a pp or sp axis; its gradients sync "
                           "uncompressed")
                mode = "off"
        if zero and mode != "off" and ndp > 1:
            _warn_once("fallback:zero", f"comm_compression={mode!r} ignored: "
                       "ReduceStrategy.Reduce shards the update over dp; its "
                       "gradients sync uncompressed")
        if mode != "off" and (ndp <= 1 or zero):
            mode = "off"
    elif mode == "off":
        reasons.append(None)   # silent: the documented default
    elif ndp <= 1:
        reasons.append(None)   # world=1 short-circuit, byte-identical pin
    elif multi_axis:
        reasons.append("the mesh has non-dp axes (mp/pp/sp programs keep "
                       "the GSPMD lowering; compression covers pure-dp)")
    elif zero:
        reasons.append("ReduceStrategy.Reduce shards state over dp, "
                       "incompatible with the replicated-state explicit "
                       "path; ZeRO runs keep the GSPMD lowering")
    grads = optimizer_grad_vars(program) if not reasons else []
    if not reasons and not grads:
        reasons.append(None)   # eval/no-optimizer program: GSPMD exact
    if not reasons:
        gb0 = program.global_block()
        produced = {n for op in gb0.ops if not op.attr(SYNC_ATTR)
                    for n in op.output_arg_names()}
        orphan = [g for _, g in grads if g not in produced]
        if orphan:
            # a Grad input no global-block op writes (fed external
            # gradients, or a sub-block-only producer): there is no
            # in-step point to sync at -- keep the GSPMD lowering
            if explicit:
                raise NotImplementedError(
                    f"data parallel: gradient(s) {orphan[:3]} have no global-block "
                    f"producer, so there is no in-step point to synchronise them")
            reasons.append(f"gradient(s) {orphan[:3]} have no "
                           f"global-block producer; explicit-dp "
                           f"compression needs in-step gradients")

    if reasons:
        why = reasons[0]
        if why:
            _warn_once(f"fallback:{why[:40]}",
                       f"comm_compression={mode!r} ignored: {why}")
        changed = _strip(program)
        if changed:
            program._bump()
        program._comm_sync_token = (token, program._version)
        return None

    gb = program.global_block()
    plan: Dict[str, str] = {}
    for _, g in grads:
        v = gb.find_var_recursive(g)
        plan[g] = "off" if mode == "off" else _decide_tensor(v, mode, ndp, min_bytes)

    changed = _sync_ops(program, plan, dp_axis, ndp)
    info = {"axis": dp_axis, "ndp": ndp, "mode": mode, "plan": dict(plan),
            "compressed": sorted(g for g, m in plan.items() if m != "off")}
    if getattr(program, "_comm_explicit", None) != info:
        program._comm_explicit = info
        changed = True
    if changed:
        program._bump()
    program._comm_sync_token = (token, program._version)
    return info


def _sync_ops(program, plan: Dict[str, str], dp_axis: str,
              ndp: int) -> bool:
    """Make the program's sync ops match ``plan`` exactly; True if any
    op/var was added, removed or re-attributed."""
    gb = program.global_block()
    changed = False
    existing: Dict[str, object] = {}
    keep = []
    for op in gb.ops:
        if op.attr(SYNC_ATTR):
            g = op.inputs["X"][0]
            if g in plan and g not in existing:
                existing[g] = op
                keep.append(op)
            else:
                changed = True    # stale sync op (grad vanished/dup)
        else:
            keep.append(op)
    if len(keep) != len(gb.ops):
        gb.ops[:] = keep

    for g, tensor_mode in plan.items():
        v = gb.find_var_recursive(g)
        res = _compress.residual_name(g)
        op = existing.get(g)
        if op is None:
            # insert right after the final write of g, so every consumer
            # (clip, optimizer) reads the synchronized value
            idx = max(i for i, o in enumerate(gb.ops)
                      if g in o.output_arg_names()) + 1
            op = gb.insert_op(
                idx, "c_allreduce_avg", inputs={"X": [g]},
                outputs={"Out": [g]},
                attrs={"axis_name": dp_axis, "comm_compress": tensor_mode,
                       SYNC_ATTR: True},
                infer_shape=False)
            changed = True
        elif op.attr("comm_compress") != tensor_mode:
            op.attrs["comm_compress"] = tensor_mode
            changed = True
        if op.attr("axis_name") != dp_axis:
            op.attrs["axis_name"] = dp_axis
            changed = True
        want_residual = tensor_mode != "off"
        has_residual = "ResidualIn" in op.inputs
        if want_residual and not has_residual:
            gb.create_var(res, shape=(ndp,) + tuple(v.shape),
                          dtype=v.dtype, persistable=True)
            op.inputs["ResidualIn"] = [res]
            op.outputs["ResidualOut"] = [res]
            changed = True
        elif not want_residual and has_residual:
            op.inputs.pop("ResidualIn", None)
            op.outputs.pop("ResidualOut", None)
            if res in gb.vars:
                del gb.vars[res]
            changed = True
        elif want_residual and res in gb.vars \
                and gb.vars[res].shape[0] != ndp:
            # world changed: residual state is per-device, re-shape it
            gb.vars[res].shape = (ndp,) + tuple(v.shape)
            changed = True
    return changed


def planned_residual_bytes(program, strategy, build_strategy=None,
                           batch=None) -> int:
    """Per-device error-feedback residual bytes ``comm_compression``
    would add to this program -- the memplan hook (lint runs before the
    rewrite, so the residual vars don't exist in the IR yet).  Uses the
    hard gates only (no tuning decisions: an estimate must not depend on
    a cache).  Returns 0 when residuals are already materialized (the
    planner then counts the real vars)."""
    ds = strategy
    mode = getattr(ds, "comm_compression", "off")
    if mode == "off":
        return 0
    sizes = dict(ds.mesh_shape or {})
    ndp = int(sizes.get(ds.data_axis, 1))
    if ndp <= 1:
        return 0
    gb = program.global_block()
    if any(_compress.is_residual(n) for n in gb.vars):
        return 0
    min_bytes = int(getattr(ds, "comm_compress_min_bytes",
                            _compress.MIN_COMPRESS_BYTES))
    total = 0
    for _, g in optimizer_grad_vars(program):
        v = gb.find_var_recursive(g)
        ok, _ = compression_eligible(v, mode, min_bytes)
        if ok:
            total += _var_bytes(v)   # (ndp, *shape)/ndp per device
    return total
