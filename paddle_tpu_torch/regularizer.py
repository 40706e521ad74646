"""Weight decay: the port's copy of ``paddle_tpu/regularizer.py``.

A regularizer adds its decay term to a parameter's gradient with ops in the
program (``scale``, ``sign``, ``sum``), before the update op reads it. A
parameter's own ``regularizer`` attr (``ParamAttr(regularizer=...)``) wins
over the optimizer's ``regularization``.
"""
from __future__ import annotations

from .framework import default_main_program


class WeightDecayRegularizer:
    def append_regularization_op(self, param, grad):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * param."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        block = default_main_program().global_block()
        decay = block.create_var(grad.name + "@L2DECAY", grad.shape, grad.dtype)
        block.append_op("scale", inputs={"X": [param]}, outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "bias": 0.0,
                               "bias_after_scale": True})
        out = block.create_var(grad.name + "@REG", grad.shape, grad.dtype)
        block.append_op("sum", inputs={"X": [grad, decay]}, outputs={"Out": [out]})
        return block.var(out.name)


class L1DecayRegularizer(WeightDecayRegularizer):
    """grad + coeff * sign(param)."""

    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def append_regularization_op(self, param, grad):
        block = default_main_program().global_block()
        sign = block.create_var(grad.name + "@SIGN", grad.shape, grad.dtype)
        block.append_op("sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = block.create_var(grad.name + "@L1DECAY", grad.shape, grad.dtype)
        block.append_op("scale", inputs={"X": [sign]}, outputs={"Out": [decay]},
                        attrs={"scale": self._coeff, "bias": 0.0,
                               "bias_after_scale": True})
        out = block.create_var(grad.name + "@REG", grad.shape, grad.dtype)
        block.append_op("sum", inputs={"X": [grad, decay]}, outputs={"Out": [out]})
        return block.var(out.name)


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """Each (param, grad) with its decay added: the param's own attr wins
    over ``regularization``, the optimizer's."""
    out = []
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None or g is None:
            out.append((p, g))
            continue
        out.append((p, reg.append_regularization_op(p, g)))
    return out
