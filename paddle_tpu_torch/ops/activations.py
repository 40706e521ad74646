"""Activation ops (the port's copy of ``paddle_tpu/ops/activations.py``,
all 42 types). Their gradients come from the generic grad; the roundings
(``ceil``, ``floor``, ``round``, ``sign``) have none.

Each is written as the JAX lowering computes it, so that the generic grad
differentiates the same expression: a clip is ``minimum(maximum(...))`` as
``jnp.clip``, which passes half the gradient at a bound (``torch.clamp``
passes all of it); ``abs`` is ``where(x >= 0, x, -x)``, whose gradient at 0
is ``jnp.abs``'s 1 (``torch.abs``'s is 0); ``softplus`` is
``logaddexp(x, 0)`` as ``jax.nn.softplus``. Constants are filled on the
device: a CUDA-graph capture refuses a copy from the host."""
from __future__ import annotations

import math

import torch

from ..core.registry import simple_op
from .basic import _full, jnp_clip


@simple_op("gelu")
def gelu(ctx, x):
    """GELU written out as ``jax.nn.gelu`` computes it, one op at a time in
    x's dtype: in bf16 each step rounds, and ``F.gelu`` (one rounding) would
    differ from the JAX package in about half the elements by one bf16 ulp.
    approximate=True is the tanh form (what BERT computes). The constants
    are filled on the device (``torch.tensor`` would copy them from the
    host, which a CUDA-graph capture refuses)."""
    if ctx.attr("approximate", False):
        c = torch.full((), math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x ** 3)))))
    sqrt_half = torch.full((), math.sqrt(0.5), dtype=x.dtype, device=x.device)
    return 0.5 * x * torch.special.erfc(-x * sqrt_half)


@simple_op("tanh")
def tanh(ctx, x):
    return torch.tanh(x)


@simple_op("relu")
def relu(ctx, x):
    """max(x, 0) as ``torch.maximum``: at x == 0 it passes half the gradient,
    as ``jnp.maximum`` does (``torch.relu`` passes none)."""
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


@simple_op("sigmoid")
def sigmoid(ctx, x):
    return torch.sigmoid(x)


@simple_op("square")
def square(ctx, x):
    return x * x


@simple_op("sqrt")
def sqrt(ctx, x):
    return torch.sqrt(x)


@simple_op("sign", grad=None)
def sign(ctx, x):
    return torch.sign(x)


def jnp_abs(x):
    """|x| whose gradient at 0 is ``jnp.abs``'s 1 (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)


def _softplus(x):
    return torch.logaddexp(x, _full(x, 0.0))


def _act(name, fn, grad="auto"):
    simple_op(name, grad=grad)(fn)


_act("logsigmoid", lambda c, x: -_softplus(-x))
_act("tanh_shrink", lambda c, x: x - torch.tanh(x))
_act("exp", lambda c, x: torch.exp(x))
_act("log", lambda c, x: torch.log(x))
_act("log1p", lambda c, x: torch.log1p(x))
_act("rsqrt", lambda c, x: 1.0 / torch.sqrt(x))
_act("abs", lambda c, x: jnp_abs(x))
_act("reciprocal", lambda c, x: 1.0 / x)
_act("softplus", lambda c, x: _softplus(x))
_act("softsign", lambda c, x: x / (1 + jnp_abs(x)))
_act("softshrink", lambda c, x: torch.where(
    x > c.attr("lambda", 0.5), x - c.attr("lambda", 0.5),
    torch.where(x < -c.attr("lambda", 0.5), x + c.attr("lambda", 0.5), torch.zeros_like(x))))
_act("hard_shrink", lambda c, x: torch.where(
    jnp_abs(x) > c.attr("threshold", 0.5), x, torch.zeros_like(x)))
_act("thresholded_relu", lambda c, x: torch.where(
    x > c.attr("threshold", 1.0), x, torch.zeros_like(x)))
_act("relu6", lambda c, x: jnp_clip(x, 0.0, c.attr("threshold", 6.0)))
_act("brelu", lambda c, x: jnp_clip(x, c.attr("t_min", 0.0), c.attr("t_max", 24.0)))
_act("leaky_relu", lambda c, x: torch.where(x >= 0, x, x * c.attr("alpha", 0.02)))
_act("elu", lambda c, x: torch.where(x > 0, x, c.attr("alpha", 1.0) * (torch.exp(x) - 1)))
_act("swish", lambda c, x: x * torch.sigmoid(c.attr("beta", 1.0) * x))
_act("hard_swish", lambda c, x: x * jnp_clip(
    x / c.attr("scale", 6.0) + c.attr("offset", 0.5), 0.0, 1.0))
_act("hard_sigmoid", lambda c, x: jnp_clip(
    c.attr("slope", 0.2) * x + c.attr("offset", 0.5), 0.0, 1.0))
_act("mish", lambda c, x: x * torch.tanh(_softplus(x)))
_act("stanh", lambda c, x: c.attr("scale_b", 1.7159) * torch.tanh(c.attr("scale_a", 0.67) * x))
_act("soft_relu", lambda c, x: torch.log1p(torch.exp(
    jnp_clip(x, -c.attr("threshold", 40.0), c.attr("threshold", 40.0)))))
# the factor rounded to x's dtype first, as ``np.asarray(factor, x.dtype)``
_act("pow", lambda c, x: torch.pow(x, _full(x, c.attr("factor", 1.0))))
_act("cos", lambda c, x: torch.cos(x))
_act("sin", lambda c, x: torch.sin(x))
_act("acos", lambda c, x: torch.acos(x))
_act("asin", lambda c, x: torch.asin(x))
_act("atan", lambda c, x: torch.atan(x))
_act("cosh", lambda c, x: torch.cosh(x))
_act("sinh", lambda c, x: torch.sinh(x))
_act("erf", lambda c, x: torch.special.erf(x))

_act("ceil", lambda c, x: torch.ceil(x), grad=None)
_act("floor", lambda c, x: torch.floor(x), grad=None)
# half to even, as jnp.round
_act("round", lambda c, x: torch.round(x), grad=None)
