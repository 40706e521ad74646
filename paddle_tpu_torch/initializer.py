"""Initializers: append init ops to the startup program.

The port's copy of ``paddle_tpu/initializer.py``: ``Constant``,
``Uniform``, ``Normal``, ``TruncatedNormal``, ``Xavier`` (``LayerHelper``'s
default for weights), ``MSRA``, ``NumpyArray`` (an ``assign_value`` of the
array) and ``Bilinear`` (an upsampling deconvolution's weights), and the
no-op ``force_init_on_cpu`` / ``init_on_cpu``.
"""
from __future__ import annotations

import contextlib

import numpy as np

from .framework import Variable, default_startup_program  # noqa: F401  (fluid.initializer.Variable)


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


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block=None):
        _append_init(var, block, "truncated_gaussian_random",
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


class MSRAInitializer(Initializer):
    """He / Kaiming init."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block=None):
        fin, _ = _fans(var)
        fin = self.fan_in if self.fan_in is not None else fin
        if self.uniform:
            limit = float(np.sqrt(6.0 / fin))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / fin))
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block=None):
        block = block or default_startup_program().global_block()
        block.create_var(var.name, var.shape, var.dtype, persistable=True)
        block.append_op("assign_value", outputs={"Out": [var.name]},
                        attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                               "values": self.value.reshape(-1).tolist()})


class BilinearInitializer(Initializer):
    """Weights of an upsampling deconvolution, [C_out, C_in, kh, kw]."""

    def __call__(self, var, block=None):
        shape = var.shape
        c_out, c_in, kh, kw = shape
        f = np.ceil(kw / 2.0)
        cc = (2 * f - 1 - f % 2) / (2.0 * f)
        w = np.zeros(shape, dtype="float32")
        for i in range(kh):
            for j in range(kw):
                w[:, :, i, j] = (1 - abs(i / f - cc)) * (1 - abs(j / f - cc))
        NumpyArrayInitializer(w)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def force_init_on_cpu():
    return False


@contextlib.contextmanager
def init_on_cpu():
    """Kept for ported code: the startup program's placement is the
    executor's (the card, or the CPU it is given)."""
    yield
