"""Control-flow ops (the port's copy of ``scan`` and ``remat_segment`` from
``paddle_tpu/ops/control_flow.py``).

A body is a sub-block of the program, run through ``ctx.block_runner``
(``core/executor.py::SubBlockRunner``). ``scan`` is a Python loop over
its static length: no value is read back to the host and every shape is
static, so a captured step holds the whole loop, each iteration's kernels
one after another (the JAX package's ``lax.scan`` compiles the body once
and loops on the device). Its gradient is the registry's generic grad:
autograd through the loop, as ``grad="auto"`` is ``jax.vjp`` through
``lax.scan`` in the JAX package.

``remat_segment`` is the ``RecomputeOptimizer``'s unit: a forward segment
moved into a sub-block. It is registered ``remat``, so the executor never
keeps its forward graph: its forward runs without autograd and frees the
segment's intermediates after their last reader, and its generic grad op
runs the sub-block again under autograd (the JAX package's
``jax.checkpoint``). Each op of the sub-block draws its random numbers
with the salt of its own first output, in the forward and in the
recompute alike (``trace_block``), so a ``dropout`` or the attention
kernel's dropout draws the same mask twice.
"""
from __future__ import annotations

import torch

from ..core.registry import register


@register("scan")
def scan_op(ctx, ins):
    """attrs: sub_block, carry_names (the loop state), x_names (the inputs
    sliced along the time axis), out_names (the outputs stacked along it),
    static_names, time_major. Inputs: Init (the first carries, in
    carry_names' order), X (sequences, [T, ...] time-major or else [B, T,
    ...]) and Static (the outer variables the body reads, parameters
    included: declared inputs, so the generic grad reaches them). Outputs
    Out (one per out_names) and FinalCarry."""
    if ctx.block_runner is None:
        raise RuntimeError("scan: no block runner to run its body with; run the "
                           "program through Executor.run (the Predictor runs one "
                           "block only, as the JAX package's does)")
    sub_idx = ctx.attr("sub_block")
    carry_names = list(ctx.attr("carry_names", []))
    x_names = list(ctx.attr("x_names", []))
    out_names = list(ctx.attr("out_names", []))
    t_axis = 0 if ctx.attr("time_major", False) else 1
    statics = dict(zip(ctx.attr("static_names", []), ins.get("Static", [])))
    carry = dict(zip(carry_names, ins["Init"]))
    seqs = list(zip(x_names, ins.get("X", [])))
    if not seqs:
        raise ValueError("scan needs at least one sequence input to set its length")
    length = seqs[0][1].shape[t_axis]
    keep = frozenset(carry_names) | frozenset(out_names)
    stacked = {n: [] for n in out_names}
    for i in range(length):
        env = dict(statics)
        env.update(carry)
        env.update({n: s.select(t_axis, i) for n, s in seqs})
        env = ctx.block_runner(sub_idx, env, keep)
        carry = {n: env[n] for n in carry_names}
        for n in out_names:
            stacked[n].append(env[n])
    return {"Out": [torch.stack(stacked[n], dim=t_axis) for n in out_names],
            "FinalCarry": [carry[n] for n in carry_names]}


def _remat_infer(op, block):
    """The segment's outputs are the variables its ops made when they were
    built (``_rewrite_recompute``): nothing to infer."""


@register("remat_segment", remat=True, infer_shape=_remat_infer)
def remat_segment(ctx, ins):
    """attrs: sub_block, in_names (X's order), out_names (Out's order)."""
    if ctx.block_runner is None:
        raise RuntimeError("remat_segment: no block runner to run its sub-block with; run "
                           "the program through Executor.run")
    in_names = list(ctx.attr("in_names", []))
    out_names = list(ctx.attr("out_names", []))
    env = ctx.block_runner(ctx.attr("sub_block"), dict(zip(in_names, ins["X"])),
                           keep=frozenset(out_names))
    return {"Out": [env[n] for n in out_names]}
