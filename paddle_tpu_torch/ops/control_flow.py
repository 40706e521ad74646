"""Control-flow ops (the port's copy of ``paddle_tpu/ops/control_flow.py``:
``while``, ``conditional_block``, ``scan``, ``remat_segment``,
``array_write``, ``array_read``, ``is_empty``, ``print`` and ``assert``).

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

``while`` has the JAX package's two lowerings. With ``max_iters`` it is a
masked loop of exactly ``max_iters`` runs of the body, each variable
taking the body's value where the condition held at the run's start and
keeping its own where it did not (``torch.where`` on the card): no value
is read on the host, so a step holding it is captured whole, and its
gradient is the generic one, autograd through the loop. Without
``max_iters`` the trip count is the data's: the condition is read on the
host before each run of the body, so a program holding such a ``while``
is refused capture (``capture_refusal``) and runs eagerly, and a gradient
through it raises, as the JAX package's ``lax.while_loop`` does.

``conditional_block`` runs both branches and selects each output on the
card (``torch.where`` on the condition), where the JAX package's
``lax.cond`` runs one: reading the condition on the host to pick a branch
would sync every step and break a capture, while a select costs only the
branch not taken, and the branches of a ``Switch`` (a learning-rate
schedule's cases) or an ``IfElse`` are a few small ops. Its outputs equal
``lax.cond``'s: a branch writes only the op's outputs.

A TensorArray is a fixed-capacity stacked buffer [capacity, ...] with its
length ``OutLen`` beside it: ``array_write`` is an ``index_copy`` at the
index, ``array_read`` an ``index_select``, the index taken as
``lax.dynamic_update_slice`` / ``dynamic_index_in_dim`` take it (``_slot``),
both on the card. ``print`` prints on the host at every run, so a program
holding one is refused capture (a replay would print nothing).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register


def _unbounded_while(op):
    if op.attr("max_iters", None) is None:
        return ("op 'while' has no max_iters: its condition is read on the host "
                "before every run of its body")
    return None


@register("while", capture_refusal=_unbounded_while)
def while_op(ctx, ins):
    """attrs: sub_block, cond_name, x_names (the carries, then the outer
    variables the body reads), out_names (the carries) and, optionally,
    ``max_iters``. Input X in x_names' order; output Out in out_names'."""
    if ctx.block_runner is None:
        raise RuntimeError("while: no block runner to run its body with; run the "
                           "program through Executor.run")
    sub_idx = ctx.attr("sub_block")
    cond_name = ctx.attr("cond_name")
    out_names = list(ctx.attr("out_names", []))
    env = dict(zip(ctx.attr("x_names", []), ins["X"]))
    keep = frozenset(env)
    max_iters = ctx.attr("max_iters", None)
    if max_iters is not None:
        for _ in range(int(max_iters)):
            active = env[cond_name].reshape(()).to(torch.bool)
            new = ctx.block_runner(sub_idx, dict(env), keep)
            env = {k: v if new[k] is v else torch.where(active, new[k], v)
                   for k, v in env.items()}
        return {"Out": [env[n] for n in out_names]}
    if torch.is_grad_enabled() and any(v.requires_grad for v in ins["X"]):
        raise ValueError(
            "gradient through a dynamic `while` needs a static bound: set attr "
            "max_iters=N on the while op (layers.While(cond, max_iters=N)) so that it "
            "lowers to a differentiable masked loop")
    if not ctx.abstract:
        while bool(env[cond_name].reshape(())):
            new = ctx.block_runner(sub_idx, dict(env), keep)
            env = {k: new[k] for k in env}
    return {"Out": [env[n] for n in out_names]}


@register("conditional_block", grad=None)
def conditional_block(ctx, ins):
    """attrs: sub_block (the true branch), else_block (-1: none, the outputs
    keep their values), x_names, out_names. Inputs Cond ([1] bool) and X;
    output Out. Both branches run; each output is selected on the card."""
    if ctx.block_runner is None:
        raise RuntimeError("conditional_block: no block runner to run its branches "
                           "with; run the program through Executor.run")
    out_names = list(ctx.attr("out_names", []))
    env0 = dict(zip(ctx.attr("x_names", []), ins["X"]))
    keep = frozenset(out_names)
    cond = ins["Cond"][0].reshape(()).to(torch.bool)
    then = ctx.block_runner(ctx.attr("sub_block"), dict(env0), keep)
    else_idx = ctx.attr("else_block", -1)
    if else_idx is not None and else_idx >= 0:
        other = ctx.block_runner(else_idx, dict(env0), keep)
    else:
        other = env0
    return {"Out": [then[n] if then[n] is other[n] else torch.where(cond, then[n], other[n])
                    for n in out_names]}


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


def _slot(i, cap):
    """The buffer row of index ``i`` as ``lax.dynamic_index_in_dim`` takes it:
    a negative index counts from the end, then it is clamped into
    [0, cap - 1]."""
    idx = i.reshape(1).to(torch.int64)
    return torch.where(idx < 0, idx + cap, idx).clamp(0, cap - 1)


@register("array_write", nondiff_inputs=("I", "ALen"))
def array_write_op(ctx, ins):
    """Out = Array with X written at index I (``_slot``), OutLen =
    max(ALen, I + 1); differentiable in Array and X."""
    arr, x, i, alen = ins["Array"][0], ins["X"][0], ins["I"][0], ins["ALen"][0]
    new = arr.index_copy(0, _slot(i, arr.shape[0]), x.unsqueeze(0).to(arr.dtype))
    newlen = torch.maximum(alen, (i.reshape(1).to(torch.int64) + 1).to(alen.dtype)
                           .reshape(alen.shape))
    return {"Out": [new], "OutLen": [newlen]}


@register("array_read", nondiff_inputs=("I",))
def array_read_op(ctx, ins):
    """Out = Array[I] (``_slot``)."""
    arr, i = ins["Array"][0], ins["I"][0]
    return {"Out": [arr.index_select(0, _slot(i, arr.shape[0])).squeeze(0)]}


@register("is_empty", grad=None)
def is_empty_op(ctx, ins):
    """[1] bool: whether X has no elements, a fact of its shape."""
    x = ins["X"][0]
    return {"Out": [torch.full((1,), x.numel() == 0, dtype=torch.bool, device=ctx.device)]}


def _prints(op):
    return ("op 'print' prints on the host at every run: a replayed graph would "
            "print nothing")


@register("print", capture_refusal=_prints)
def print_op(ctx, ins):
    """Prints ``message`` and In's value on the host; Out is In."""
    x = ins["In"][0]
    if not ctx.abstract:
        value = x.detach().float() if x.dtype == torch.bfloat16 else x.detach()
        print(ctx.attr("message", "") + str(np.asarray(value.cpu())), flush=True)
    return {"Out": [x]}


@register("assert", grad=None)
def assert_op(ctx, ins):
    """A no-op, as in the JAX package."""
    return {}
