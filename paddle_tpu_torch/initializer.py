"""Initializers: append init ops to the startup program.

The port's copy of the part of ``paddle_tpu/initializer.py`` this slice
reaches: ``Constant`` and ``Normal`` (BERT's), and ``Uniform`` / ``Xavier``
(``LayerHelper``'s default for weights).
"""
from __future__ import annotations

import numpy as np

from .framework import default_startup_program


class Initializer:
    def __call__(self, var, block=None):
        raise NotImplementedError


def _append_init(var, block, op_type, attrs):
    block = block or default_startup_program().global_block()
    block.create_var(var.name, var.shape, var.dtype, persistable=True)
    block.append_op(op_type, outputs={"Out": [var.name]},
                    attrs={"shape": list(var.shape), "dtype": var.dtype, **attrs})


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block=None):
        _append_init(var, block, "fill_constant", {"value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block=None):
        _append_init(var, block, "uniform_random",
                     {"min": self.low, "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        _append_init(var, block, "gaussian_random",
                     {"mean": self.loc, "std": self.scale, "seed": self.seed})


def _fans(var):
    shape = var.shape
    if len(shape) == 2:
        return shape[0], shape[1]
    if len(shape) >= 3:
        rf = int(np.prod(shape[2:]))
        return shape[1] * rf, shape[0] * rf
    return shape[0] if shape else 1, shape[0] if shape else 1


class XavierInitializer(Initializer):
    """Glorot init."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = (uniform, fan_in,
                                                              fan_out, seed)

    def __call__(self, var, block=None):
        fin, fout = _fans(var)
        fin = self.fan_in if self.fan_in is not None else fin
        fout = self.fan_out if self.fan_out is not None else fout
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fin + fout)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fin + fout)))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
