"""Optimizer update ops: the port's copy of the 14 update ops of
``paddle_tpu/ops/optimizer_ops.py`` (``sgd``, ``momentum``,
``lars_momentum``, ``adam``, ``adamw``, ``adagrad``, ``adamax``,
``adadelta``, ``rmsprop``, ``ftrl``, ``lamb``, ``dpsgd``, ``proximal_gd``,
``decayed_adagrad``), each the JAX op's arithmetic in its order.

An update op rewrites Param and its state: the outputs carry the input state
vars' names, so the executor writes them back to the scope. It computes in
the master dtype -- the dtype of its moment accumulators (f32; f32 for the
stateless ``sgd``) -- by casting
Param, Grad and LearningRate up front, and casts only ParamOut back to the
parameter's dtype. Each op is a handful of elementwise PyTorch launches per
parameter. ``trace_block`` runs a run of consecutive ``sgd``,
``momentum``, ``adam``, ``lamb`` or ``lars_momentum`` ops as one
multi-tensor update (``ops/multi_tensor.py``), whose plain version calls
these lowerings and whose CUDA kernel repeats their arithmetic (bit for bit
where no per-tensor norm is involved).

``lars_momentum``, ``lamb`` and ``dpsgd`` read a norm of the whole tensor
(``torch.sum`` of squares); the ``1e-12`` guards and the ``where`` on a
zero norm are the JAX op's. ``dpsgd`` draws Gaussian noise from the op's
host-seeded generator (``ctx.rng()``), so it is registered ``host_rng``: a
program that holds it is not captured as a CUDA graph and runs eagerly.
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


@register("lars_momentum", grad=None, infer_shape=_state_out_infer)
def lars_momentum(ctx, ins):
    """local_lr = lr coeff |p| / (|g| + decay |p| + 1e-12) (lr where |p| = 0);
    v' = mu v + local_lr (g + decay p); p' = p - v'."""
    p, g, v = ins["Param"][0], ins["Grad"][0], ins["Velocity"][0]
    pf, gf, lrf = _up(v.dtype, p, g, ins["LearningRate"][0])
    mu = ctx.attr("mu", 0.9)
    coeff = ctx.attr("lars_coeff", 0.001)
    decay = ctx.attr("lars_weight_decay", 0.0005)
    pn = torch.sqrt(torch.sum(pf * pf))
    gn = torch.sqrt(torch.sum(gf * gf))
    local_lr = torch.where(pn > 0, lrf * coeff * pn / (gn + decay * pn + 1e-12), lrf)
    v_out = mu * v + local_lr * (gf + decay * pf)
    return {"ParamOut": [_down(pf - v_out, p)], "VelocityOut": [v_out]}


@register("adamw", grad=None, infer_shape=_state_out_infer)
def adamw(ctx, ins):
    """Adam, then p -= lr coeff p (decoupled weight decay)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    pf, gf, lrf = _up(m.dtype, p, g, ins["LearningRate"][0])
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    wd = ctx.attr("coeff", 0.01)
    m_out = b1 * m + (1 - b1) * gf
    v_out = b2 * v + (1 - b2) * gf * gf
    lr_t = lrf * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = pf - lr_t * m_out / (torch.sqrt(v_out) + eps) - lrf * wd * pf
    return {"ParamOut": [_down(p_out, p)], "Moment1Out": [m_out],
            "Moment2Out": [v_out], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}


@register("adagrad", grad=None, infer_shape=_state_out_infer)
def adagrad(ctx, ins):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    pf, gf, lrf = _up(mom.dtype, p, g, ins["LearningRate"][0])
    eps = ctx.attr("epsilon", 1e-6)
    m_out = mom + gf * gf
    p_out = pf - lrf * gf / (torch.sqrt(m_out) + eps)
    return {"ParamOut": [_down(p_out, p)], "MomentOut": [m_out]}


@register("adamax", grad=None, infer_shape=_state_out_infer)
def adamax(ctx, ins):
    """Beta1Pow is read, not advanced: the optimizer appends a ``scale`` of
    it after the op, as the JAX package's does."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, inf = ins["Moment"][0], ins["InfNorm"][0]
    b1p = ins["Beta1Pow"][0]
    pf, gf, lrf = _up(m.dtype, p, g, ins["LearningRate"][0])
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * gf
    inf_out = torch.maximum(b2 * inf, torch.abs(gf))
    p_out = pf - (lrf / (1 - b1p)) * m_out / (inf_out + eps)
    return {"ParamOut": [_down(p_out, p)], "MomentOut": [m_out],
            "InfNormOut": [inf_out]}


@register("adadelta", grad=None, infer_shape=_state_out_infer)
def adadelta(ctx, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    asg_in, asu_in = ins["AvgSquaredGrad"][0], ins["AvgSquaredUpdate"][0]
    pf, gf = _up(asg_in.dtype, p, g)
    rho = ctx.attr("rho", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    asg = rho * asg_in + (1 - rho) * gf * gf
    update = -torch.sqrt((asu_in + eps) / (asg + eps)) * gf
    asu = rho * asu_in + (1 - rho) * update * update
    return {"ParamOut": [_down(pf + update, p)], "AvgSquaredGradOut": [asg],
            "AvgSquaredUpdateOut": [asu]}


@register("rmsprop", grad=None, infer_shape=_state_out_infer)
def rmsprop(ctx, ins):
    """Plain, or centered (``centered``: MeanGrad in, MeanGradOut out)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    ms, mom = ins["MeanSquare"][0], ins["Moment"][0]
    pf, gf, lrf = _up(ms.dtype, p, g, ins["LearningRate"][0])
    eps = ctx.attr("epsilon", 1e-10)
    decay = ctx.attr("decay", 0.9)
    mu = ctx.attr("momentum", 0.0)
    ms_out = decay * ms + (1 - decay) * gf * gf
    if ctx.attr("centered", False):
        mg = ins["MeanGrad"][0]
        mg_out = decay * mg + (1 - decay) * gf
        mom_out = mu * mom + lrf * gf / torch.sqrt(ms_out - mg_out * mg_out + eps)
        return {"ParamOut": [_down(pf - mom_out, p)], "MeanSquareOut": [ms_out],
                "MomentOut": [mom_out], "MeanGradOut": [mg_out]}
    mom_out = mu * mom + lrf * gf / torch.sqrt(ms_out + eps)
    return {"ParamOut": [_down(pf - mom_out, p)], "MeanSquareOut": [ms_out],
            "MomentOut": [mom_out]}


def _ftrl_infer(op, block):
    """Ftrl's outputs are named ``SquaredAccumOut`` / ``LinearAccumOut``
    beside the inputs ``SquaredAccumulator`` / ``LinearAccumulator``."""
    src = {"ParamOut": "Param", "SquaredAccumOut": "SquaredAccumulator",
           "LinearAccumOut": "LinearAccumulator"}
    for slot, names in op.outputs.items():
        for n, s in zip(names, op.inputs.get(src[slot], [])):
            sv = block.find_var_recursive(s)
            v = block.find_var_recursive(n) or block.create_var(n, sv.shape, sv.dtype)
            v.shape, v.dtype = sv.shape, sv.dtype


@register("ftrl", grad=None, infer_shape=_ftrl_infer)
def ftrl(ctx, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    sq, lin = ins["SquaredAccumulator"][0], ins["LinearAccumulator"][0]
    pf, gf, lrf = _up(sq.dtype, p, g, ins["LearningRate"][0])
    l1 = ctx.attr("l1", 0.0)
    l2 = ctx.attr("l2", 0.0)
    power = ctx.attr("lr_power", -0.5)
    new_sq = sq + gf * gf
    sigma = (new_sq ** -power - sq ** -power) / lrf
    lin_out = lin + gf - sigma * pf
    x = torch.clamp(lin_out, -l1, l1) - lin_out
    y = new_sq ** -power / lrf + 2 * l2
    return {"ParamOut": [_down(x / y, p)], "SquaredAccumOut": [new_sq],
            "LinearAccumOut": [lin_out]}


@register("lamb", grad=None, infer_shape=_state_out_infer)
def lamb(ctx, ins):
    """r = m^ / (sqrt(v^) + eps) + wd p; p' = p - lr trust r, with trust =
    |p| / |r| (1 where either norm is 0)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    m, v = ins["Moment1"][0], ins["Moment2"][0]
    b1p, b2p = ins["Beta1Pow"][0], ins["Beta2Pow"][0]
    pf, gf, lrf = _up(m.dtype, p, g, ins["LearningRate"][0])
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-6)
    wd = ctx.attr("weight_decay", 0.01)
    m_out = b1 * m + (1 - b1) * gf
    v_out = b2 * v + (1 - b2) * gf * gf
    m_hat = m_out / (1 - b1p)
    v_hat = v_out / (1 - b2p)
    r = m_hat / (torch.sqrt(v_hat) + eps) + wd * pf
    p_norm = torch.sqrt(torch.sum(pf * pf))
    r_norm = torch.sqrt(torch.sum(r * r))
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    return {"ParamOut": [_down(pf - lrf * trust * r, p)], "Moment1Out": [m_out],
            "Moment2Out": [v_out], "Beta1PowOut": [b1p * b1],
            "Beta2PowOut": [b2p * b2]}


@register("dpsgd", grad=None, infer_shape=_state_out_infer, host_rng=True)
def dpsgd(ctx, ins):
    """Clip g to norm ``clip``, add N(0, (sigma clip)^2) noise, p' = p - lr g.
    The noise comes from the op's host-seeded generator (another generator
    than the JAX package's: held by its statistics)."""
    p, g = ins["Param"][0], ins["Grad"][0]
    pf, gf, lrf = _up(torch.float32, p, g, ins["LearningRate"][0])
    clip = ctx.attr("clip", 10.0)
    sigma = ctx.attr("sigma", 1.0)
    gn = torch.sqrt(torch.sum(gf * gf))
    gf = gf * torch.clamp(clip / (gn + 1e-12), max=1.0)
    noise = torch.randn(gf.shape, generator=ctx.rng(), dtype=gf.dtype,
                        device=gf.device) * sigma * clip
    return {"ParamOut": [_down(pf - lrf * (gf + noise), p)]}


@register("proximal_gd", grad=None, infer_shape=_state_out_infer)
def proximal_gd(ctx, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    pf, gf, lrf = _up(torch.float32, p, g, ins["LearningRate"][0])
    l1, l2 = ctx.attr("l1", 0.0), ctx.attr("l2", 0.0)
    prox = pf - lrf * gf
    p_out = (torch.sign(prox) * torch.clamp(torch.abs(prox) - lrf * l1, min=0.0)
             / (1.0 + lrf * l2))
    return {"ParamOut": [_down(p_out, p)]}


@register("decayed_adagrad", grad=None, infer_shape=_state_out_infer)
def decayed_adagrad(ctx, ins):
    p, g, mom = ins["Param"][0], ins["Grad"][0], ins["Moment"][0]
    pf, gf, lrf = _up(mom.dtype, p, g, ins["LearningRate"][0])
    decay = ctx.attr("decay", 0.95)
    eps = ctx.attr("epsilon", 1e-6)
    m_out = decay * mom + (1 - decay) * gf * gf
    return {"ParamOut": [_down(pf - lrf * gf / (torch.sqrt(m_out) + eps), p)],
            "MomentOut": [m_out]}
