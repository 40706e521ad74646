"""Optimizer update ops (the port's copy of ``sgd``, ``momentum`` and
``adam`` from ``paddle_tpu/ops/optimizer_ops.py``).

An update op rewrites Param and its state: the outputs carry the input state
vars' names, so the executor writes them back to the scope. It computes in
the master dtype -- the dtype of its moment accumulators (f32; f32 for the
stateless ``sgd``) -- by casting
Param, Grad and LearningRate up front, and casts only ParamOut back to the
parameter's dtype. Each op is a handful of elementwise PyTorch launches per
parameter. ``trace_block`` runs a run of consecutive update ops as one
multi-tensor update (``ops/multi_tensor.py``), whose plain version calls
these lowerings and whose CUDA kernel repeats their arithmetic bit for bit.
"""
from __future__ import annotations

import torch

from ..core.registry import register


def _up(mdt, *xs):
    """Cast tensors up to the master dtype."""
    return [x.to(mdt) if x is not None else None for x in xs]


def _down(p_out, p):
    return p_out.to(p.dtype)


def _state_out_infer(op, block):
    """Each ``<Slot>Out`` takes the shape and dtype of the input ``<Slot>``
    (what the lowering gives), without running it on meta tensors: a
    program has one update op per parameter."""
    for slot, names in op.outputs.items():
        src = op.inputs.get(slot[:-len("Out")], [])
        for n, s in zip(names, src):
            sv = block.find_var_recursive(s)
            v = block.find_var_recursive(n) or block.create_var(n, sv.shape, sv.dtype)
            v.shape, v.dtype = sv.shape, sv.dtype


@register("sgd", grad=None, infer_shape=_state_out_infer)
def sgd(ctx, ins):
    """p' = p - lr g, in f32."""
    p = ins["Param"][0]
    pf, gf, lrf = _up(torch.float32, p, ins["Grad"][0], ins["LearningRate"][0])
    return {"ParamOut": [_down(pf - lrf * gf, p)]}


@register("momentum", grad=None, infer_shape=_state_out_infer)
def momentum(ctx, ins):
    """v' = mu v + g; p' = p - lr v' (Nesterov: p - lr (g + mu v'))."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    pf, gf, lrf = _up(v.dtype, p, g, ins["LearningRate"][0])
    mu = ctx.attr("mu", 0.9)
    v_out = mu * v + gf
    if ctx.attr("use_nesterov", False):
        p_out = pf - (gf + mu * v_out) * lrf
    else:
        p_out = pf - lrf * v_out
    return {"ParamOut": [_down(p_out, p)], "VelocityOut": [v_out]}


@register("adam", grad=None, infer_shape=_state_out_infer)
def adam(ctx, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    pf, gf, lrf = _up(m.dtype, p, g, ins["LearningRate"][0])
    b1 = ctx.attr("beta1", 0.9)
    b2 = ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * gf
    v_out = b2 * v + (1 - b2) * gf * gf
    lr_t = lrf * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = pf - lr_t * m_out / (torch.sqrt(v_out) + eps)
    return {"ParamOut": [_down(p_out, p)], "Moment1Out": [m_out],
            "Moment2Out": [v_out], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}
