"""Optimizers: the port's copy of ``Optimizer``, ``SGDOptimizer``,
``MomentumOptimizer``, ``AdamOptimizer`` and the ``SGD`` / ``Momentum`` /
``Adam`` aliases from ``paddle_tpu/optimizer.py``.

``Optimizer.minimize(loss)`` = append_backward + clipping (``clip.py``) +
regularization (``regularizer.py``) + one update op per parameter, all in
the same Program, so one ``Executor.run`` is one training step. Accumulator names come from
``unique_name`` exactly as in the JAX package (``{param}_moment1_0``, ...),
so a program built under ``unique_name.guard()`` names its state as the JAX
package's does and a training state carries across by name.
"""
from __future__ import annotations

from typing import List, Tuple

from . import unique_name
from .clip import append_gradient_clip_ops, apply_clip_to_all
from .core.backward import append_backward
from .framework import Parameter, Variable, default_main_program
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None):
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._name = name
        self._accumulators = {}
        self._lr_var = None

    # -- learning rate -----------------------------------------------------------------
    def _create_lr_var(self):
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        helper = LayerHelper("learning_rate")
        self._lr_var = helper.create_global_variable(
            [1], "float32", persistable=True,
            name=unique_name.generate("learning_rate"),
            initializer=Constant(float(self._learning_rate)))

    def _lr(self, param=None):
        lr = self._lr_var
        mult = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0) \
            if param is not None else 1.0
        if mult == 1.0:
            return lr
        block = default_main_program().global_block()
        out = block.create_var(unique_name.generate("lr_scaled"), (1,), "float32")
        block.append_op("scale", inputs={"X": [lr]}, outputs={"Out": [out]},
                        attrs={"scale": float(mult)})
        return block.var(out.name)

    # -- accumulators ------------------------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None) -> Variable:
        key = (name, param.name)
        if key in self._accumulators:
            return self._accumulators[key]
        helper = LayerHelper(name)
        v = helper.create_global_variable(
            list(shape if shape is not None else param.shape),
            dtype or "float32", persistable=True,
            name=unique_name.generate(f"{param.name}_{name}"),
            initializer=Constant(float(fill_value)))
        self._accumulators[key] = v
        return v

    # -- to be implemented by subclasses ----------------------------------------------
    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- public API --------------------------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(loss, parameter_list, no_grad_set, callbacks)

    def apply_gradients(self, params_grads) -> List:
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        self._create_lr_var()
        block = default_main_program().global_block()
        return [self._append_optimize_op(block, (p, g))
                for p, g in params_grads if g is not None]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None
                 ) -> Tuple[List, List[Tuple[Parameter, Variable]]]:
        """Append the backward pass and the update ops to the loss's program
        (the update's startup ops to ``startup_program`` or the default).
        ``grad_clip`` clips every gradient before the per-param clip attrs
        of ``set_gradient_clip`` apply (the two compose)."""
        from .framework import default_startup_program, program_guard
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program, parameter_list,
                                         no_grad_set)
            if grad_clip is not None:
                params_grads = apply_clip_to_all(grad_clip, params_grads)
            ops = self.apply_gradients(params_grads)
        return ops, params_grads


class SGDOptimizer(Optimizer):
    """p' = p - lr g."""

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "sgd", inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum, use_nesterov=False, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _append_optimize_op(self, block, pg):
        p, g = pg
        vel = self._add_accumulator("velocity", p)
        return block.append_op(
            "momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [vel],
                    "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [vel]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 lazy_mode=False, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, self._beta1, shape=[1])
        b2p = self._add_accumulator("beta2_pow_acc", p, self._beta2, shape=[1])
        return block.append_op(
            "adam",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr(p)],
                    "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p],
                    "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
