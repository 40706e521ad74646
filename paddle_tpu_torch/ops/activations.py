"""Activation ops (the port's copy of ``relu``, ``gelu``, ``tanh``,
``sigmoid``, ``square``, ``sqrt`` and ``sign`` from
``paddle_tpu/ops/activations.py``). Their gradients come from the generic
grad; ``sign`` has none."""
from __future__ import annotations

import math

import torch

from ..core.registry import simple_op


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
