"""Decoupled weight decay through any optimizer: the port's copy of
``paddle_tpu/contrib/extend_optimizer.py`` (``extend_with_decoupled_weight_decay``,
the AdamW recipe: p -= coeff * p beside the base optimizer's update, not
through the gradient)."""
from __future__ import annotations

from .. import layers
from ..framework import Variable, default_startup_program, program_guard


class DecoupledWeightDecay:
    """Mixin in front of an Optimizer subclass (``extend_with_decoupled_weight_decay``)."""

    def __init__(self, coeff=0.0, apply_decay_param_fun=None, **kwargs):
        if not isinstance(coeff, (float, Variable)):
            raise TypeError("coeff should be float or Variable.")
        self._params_name = set()
        self._apply_decay_param_fun = apply_decay_param_fun
        self._coeff = coeff
        super().__init__(**kwargs)

    def _scale_parameters(self, params_and_grads):
        if isinstance(self._coeff, float) and self._coeff == 0.0:
            return []
        scaled = []
        for param, grad in params_and_grads:
            if grad is None:
                continue
            if (self._apply_decay_param_fun is not None
                    and not self._apply_decay_param_fun(param.name)):
                continue
            assert param.name not in self._params_name
            scaled.append((param, grad, param * self._coeff))
            self._params_name.add(param.name)
        return scaled

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None):
        """The base ``minimize``, with ``param -= coeff * param`` appended
        after the backward pass and before the update ops, in the loss's
        program."""
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program=startup_program,
                                         parameter_list=parameter_list,
                                         no_grad_set=no_grad_set)
            if grad_clip is not None:
                from ..clip import apply_clip_to_all
                params_grads = apply_clip_to_all(grad_clip, params_grads)
            for param, grad, scaled_param in self._scale_parameters(params_grads):
                updated = layers.elementwise_sub(param, scaled_param)
                layers.assign(updated, output=param)
            optimize_ops = self.apply_gradients(
                [(p, g) for p, g in params_grads if g is not None])
        return optimize_ops, params_grads

    def __str__(self):
        return " ".join(["Weight Decay, params:", ",".join(self._params_name)])


def extend_with_decoupled_weight_decay(base_optimizer):
    """A subclass of ``base_optimizer`` whose ``minimize`` also applies
    decoupled weight decay:

        AdamW = extend_with_decoupled_weight_decay(pt.optimizer.Adam)
        AdamW(weight_decay=0.01, learning_rate=1e-3).minimize(loss)
    """
    from ..optimizer import Optimizer
    if not issubclass(base_optimizer, Optimizer):
        raise TypeError("base_optimizer must be a subclass of fluid.optimizer.Optimizer")

    class OptimizerWithDecoupledWeightDecay(DecoupledWeightDecay, base_optimizer):
        def __init__(self, weight_decay, apply_decay_param_fun=None, **kwargs):
            super().__init__(coeff=weight_decay, apply_decay_param_fun=apply_decay_param_fun,
                             **kwargs)

    return OptimizerWithDecoupledWeightDecay
