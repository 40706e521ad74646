"""Optimizers: the port's copy of ``paddle_tpu/optimizer.py`` -- the
thirteen update classes (``SGD``, ``Momentum``, ``LarsMomentum``, ``Adam``,
``AdamW``, ``Adagrad``, ``Adamax``, ``Adadelta``, ``RMSProp``, ``Ftrl``,
``Lamb``, ``DecayedAdagrad``, ``Dpsgd``) with their ``*Optimizer`` names,
the wrappers ``RecomputeOptimizer``, ``PipelineOptimizer`` (its
microbatch scan), ``ExponentialMovingAverage``, ``ModelAverage`` and
``LookaheadOptimizer``, and ``DGCMomentumOptimizer``,
which raises on construction as the JAX package's does.

``Optimizer.minimize(loss)`` = append_backward + clipping (``clip.py``) +
regularization (``regularizer.py``) + one update op per parameter, all in
the same Program, so one ``Executor.run`` is one training step. Accumulator names come from
``unique_name`` exactly as in the JAX package (``{param}_moment1_0``, ...),
so a program built under ``unique_name.guard()`` names its state as the JAX
package's does and a training state carries across by name.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

from . import unique_name
from .clip import append_gradient_clip_ops, apply_clip_to_all
from .core.backward import append_backward
from .framework import (Operator, Parameter, Program, Variable, default_main_program,
                        default_startup_program, program_guard)
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

    def apply_optimize(self, loss, startup_program, params_grads):
        """The update ops for ``params_grads`` (clip and regularization
        first), as ``apply_gradients``."""
        return self.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, grad_clip=None
                 ) -> Tuple[List, List[Tuple[Parameter, Variable]]]:
        """Append the backward pass and the update ops to the loss's program
        (the update's startup ops to ``startup_program`` or the default).
        ``grad_clip`` clips every gradient before the per-param clip attrs
        of ``set_gradient_clip`` apply (the two compose)."""
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


class LarsMomentumOptimizer(Optimizer):
    """LARS: momentum with a layer-wise learning rate."""

    def __init__(self, learning_rate, momentum, lars_coeff=0.001,
                 lars_weight_decay=0.0005, **kw):
        super().__init__(learning_rate, **kw)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay

    def _append_optimize_op(self, block, pg):
        p, g = pg
        vel = self._add_accumulator("velocity", p)
        return block.append_op(
            "lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [vel],
                    "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [vel]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay})


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




class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay."""

    def __init__(self, learning_rate=0.001, weight_decay=0.01, **kw):
        super().__init__(learning_rate, **kw)
        self._coeff = weight_decay

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, self._beta1, shape=[1])
        b2p = self._add_accumulator("beta2_pow_acc", p, self._beta2, shape=[1])
        return block.append_op(
            "adamw",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr(p)],
                    "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p],
                    "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "coeff": self._coeff})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, initial_accumulator_value=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _append_optimize_op(self, block, pg):
        p, g = pg
        mom = self._add_accumulator("moment", p, self._initial)
        return block.append_op(
            "adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [mom]},
            attrs={"epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, pg):
        """The ``adamax`` op reads Beta1Pow; a ``scale`` by beta1 after it
        advances it."""
        p, g = pg
        mom = self._add_accumulator("moment", p)
        inf = self._add_accumulator("inf_norm", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, self._beta1, shape=[1])
        op = block.append_op(
            "adamax",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom], "InfNorm": [inf],
                    "Beta1Pow": [b1p], "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [mom], "InfNormOut": [inf]},
            attrs={"beta1": self._beta1, "beta2": self._beta2, "epsilon": self._epsilon})
        block.append_op("scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
                        attrs={"scale": self._beta1})
        return op


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kw):
        super().__init__(learning_rate, **kw)
        self._epsilon, self._rho = epsilon, rho

    def _append_optimize_op(self, block, pg):
        p, g = pg
        asg = self._add_accumulator("avg_squared_grad", p)
        asu = self._add_accumulator("avg_squared_update", p)
        return block.append_op(
            "adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [asg],
                    "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [asg],
                     "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, **kw):
        super().__init__(learning_rate, **kw)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ms = self._add_accumulator("mean_square", p)
        mom = self._add_accumulator("momentum", p)
        inputs = {"Param": [p], "Grad": [g], "MeanSquare": [ms], "Moment": [mom],
                  "LearningRate": [self._lr(p)]}
        outputs = {"ParamOut": [p], "MeanSquareOut": [ms], "MomentOut": [mom]}
        if self._centered:
            mg = self._add_accumulator("mean_grad", p)
            inputs["MeanGrad"] = [mg]
            outputs["MeanGradOut"] = [mg]
        return block.append_op(
            "rmsprop", inputs=inputs, outputs=outputs,
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class FtrlOptimizer(Optimizer):
    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kw):
        super().__init__(learning_rate, **kw)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._add_accumulator("squared", p)
        lin = self._add_accumulator("linear", p)
        return block.append_op(
            "ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin], "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq], "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class LambOptimizer(Optimizer):
    """LAMB (You et al. 2019, arXiv:1904.00962), large-batch BERT training.
    ``exclude_from_weight_decay_fn(param)`` True gives that parameter's op
    ``weight_decay`` 0."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01, beta1=0.9,
                 beta2=0.999, epsilon=1e-6, exclude_from_weight_decay_fn=None, **kw):
        super().__init__(learning_rate, **kw)
        self._weight_decay = lamb_weight_decay
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m1 = self._add_accumulator("moment1", p)
        m2 = self._add_accumulator("moment2", p)
        b1p = self._add_accumulator("beta1_pow_acc", p, self._beta1, shape=[1])
        b2p = self._add_accumulator("beta2_pow_acc", p, self._beta2, shape=[1])
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        return block.append_op(
            "lamb",
            inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr(p)],
                    "Moment1": [m1], "Moment2": [m2], "Beta1Pow": [b1p],
                    "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self._decay, self._epsilon = decay, epsilon

    def _append_optimize_op(self, block, pg):
        p, g = pg
        mom = self._add_accumulator("moment", p)
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [mom],
                    "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [mom]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class DpsgdOptimizer(Optimizer):
    """Differentially private SGD. Its ``dpsgd`` ops draw noise from a
    host-seeded generator, so its program runs eagerly, not as a CUDA
    graph (``Executor.run`` warns once; ``run_fused`` refuses it)."""

    def __init__(self, learning_rate=0.001, clip=10.0, batch_size=16.0, sigma=1.0, **kw):
        super().__init__(learning_rate, **kw)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            "dpsgd", inputs={"Param": [p], "Grad": [g], "LearningRate": [self._lr(p)]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


class RecomputeOptimizer(Optimizer):
    """Activation recomputation: ``_set_checkpoints([vars])`` marks segment
    boundaries; ``minimize`` moves each forward segment between two
    checkpoints into a ``remat_segment`` op (``_rewrite_recompute``), then
    delegates to the inner optimizer. The backward pass recomputes a
    segment's intermediates instead of keeping them
    (``ops/control_flow.py``). Variables inside a segment can no longer be
    fetched."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints
        return self

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(loss, startup_program, parameter_list,
                                        no_grad_set, callbacks)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        if not self._checkpoints:
            raise ValueError("call _set_checkpoints() before minimize()")
        program = loss.block.program
        _rewrite_recompute(program, [c.name if isinstance(c, Variable) else str(c)
                                     for c in self._checkpoints])
        loss = program.global_block().var(loss.name)
        return self._optimizer.minimize(loss, startup_program, parameter_list, no_grad_set)


def _rewrite_recompute(program: Program, checkpoint_names):
    """Partition the global block's ops at the checkpoint producers: each
    run of at least two ops that ends with a checkpoint's producer becomes
    one ``remat_segment`` op over a sub-block holding them. Its inputs are
    the variables the segment reads and does not make; its outputs those
    it makes that a later op reads, the checkpoints and the persistables."""
    block = program.global_block()
    ops = block.ops
    ckpts = set(checkpoint_names)
    boundaries = [0] + [i + 1 for i, op in enumerate(ops)
                        if any(n in ckpts for n in op.output_arg_names())]
    segments = [(a, b) for a, b in zip(boundaries, boundaries[1:]) if b - a >= 2]
    if not segments:
        return
    new_ops, cursor = [], 0
    for a, b in segments:
        new_ops.extend(ops[cursor:a])
        seg_ops = ops[a:b]
        produced, read = set(), []
        for op in seg_ops:
            for n in op.input_arg_names():
                if n not in produced and n not in read:
                    read.append(n)
            produced.update(op.output_arg_names())
        used_later = {n for op in ops[b:] for n in op.input_arg_names()}
        out_names = []
        for op in seg_ops:
            for n in op.output_arg_names():
                v = block.find_var_recursive(n)
                if n not in out_names and (n in used_later or n in ckpts
                                           or (v is not None and v.persistable)):
                    out_names.append(n)
        in_names = [n for n in read if block.find_var_recursive(n) is not None]
        sub = program._create_block(parent_idx=0)
        sub.ops = list(seg_ops)
        program._rollback()
        new_ops.append(Operator(block, "remat_segment", {"X": in_names}, {"Out": out_names},
                                {"sub_block": sub.idx, "in_names": in_names,
                                 "out_names": out_names}))
        cursor = b
    new_ops.extend(ops[cursor:])
    block.ops = new_ops
    program._bump()


class PipelineOptimizer:
    """GPipe-style pipeline training (reference optimizer.py:2985
    PipelineOptimizer, framework/trainer.h:115 PipelineTrainer,
    section_worker.cc:85 SectionWorker), with the JAX package's three
    schedules.

    ``"scan"``: ``minimize`` appends the wrapped optimizer's backward pass,
    then rewrites the program into a microbatch scan
    (``_rewrite_microbatch_scan``): the feed batch splits into
    ``num_microbatches`` slices, one ``scan`` runs forward and backward per
    slice and sums the gradients in its carries, and the wrapped optimizer
    applies their mean once. For a mean loss over equal slices that is the
    full batch's gradient, at a slice's activation memory. The loss variable
    becomes the mean of the microbatches' losses.

    ``"temporal"``: the ``device_guard("stage:i")`` stages of a homogeneous
    stack (BERT's ``pp_stages``) become one ``temporal_pipeline`` op over
    ``<param>@pp_stacked`` parameters (``_rewrite_temporal_pipeline``). Over
    a bound ``pipeline_axis`` group of ``num_stages`` ranks it runs the
    GPipe schedule, one stage a rank (``parallel/pipeline.py``); otherwise
    the serial schedule, each microbatch through the stages in order. It
    raises, with the JAX package's messages, where the stages cannot lower.
    ``"auto"`` lowers annotated stacks and scans everything else.

    Feed batch sizes must be divisible by ``num_microbatches``. The cut,
    place, concurrency and queue arguments are the reference's
    thread-section knobs, accepted and not read, as in the JAX package."""

    def __init__(self, optimizer, num_microbatches=1, cut_list=None,
                 place_list=None, concurrency_list=None, queue_size=None,
                 sync_steps=None, start_cpu_core_id=0, schedule="auto",
                 pipeline_axis="pp"):
        self._optimizer = optimizer
        self._m = int(num_microbatches)
        if schedule not in ("auto", "scan", "temporal"):
            raise ValueError(f"schedule must be auto|scan|temporal, got {schedule!r}")
        self._schedule = schedule
        self._axis = pipeline_axis

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return self._optimizer.backward(loss, startup_program, parameter_list,
                                        no_grad_set, callbacks)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        startup = startup_program or default_startup_program()
        if self._schedule in ("auto", "temporal"):
            rewrote = _rewrite_temporal_pipeline(
                program, startup, self._m, self._axis,
                required=self._schedule == "temporal")
            if rewrote:
                with program_guard(program, startup):
                    params_grads = self._optimizer.backward(
                        loss, startup_program, parameter_list, no_grad_set)
                    pg = [(p, g) for p, g in params_grads if g is not None]
                    ops = self._optimizer.apply_gradients(pg)
                return ops, params_grads
        with program_guard(program, startup):
            params_grads = self._optimizer.backward(
                loss, startup_program, parameter_list, no_grad_set)
            if self._m <= 1:
                ops = self._optimizer.apply_gradients(params_grads)
                return ops, params_grads
            mean_grads = _rewrite_microbatch_scan(program, loss, params_grads, self._m)
            pg = [(p, mean_grads[p.name]) for p, g in params_grads if g is not None]
            ops = self._optimizer.apply_gradients(pg)
        return ops, params_grads

    @staticmethod
    def pp_param_rules(axis="pp"):
        """DistributedStrategy param_rules sharding the stage-stacked
        parameters (and their stage-stacked optimizer accumulators) over the
        pipeline axis, as the JAX package's: each pp rank holds its stage's
        block. Scalar accumulators derived from stacked params (Adam's
        beta-pow) stay replicated -- first match wins."""
        return [(r"@pp_stacked.*_pow_acc", ()),
                (r"@pp_stacked", (axis,))]


def _rewrite_temporal_pipeline(program: Program, startup, M, axis="pp",
                               required=False):
    """Lower device_guard("stage:i")-annotated ops into one temporal_pipeline
    op (the GPipe schedule, ``ops/pipeline_op.py``; reference
    PipelineTrainer/SectionWorker, trainer.h:115, section_worker.cc:85). The
    port's copy of the JAX package's rewrite: the same checks, messages,
    ops, variables and names.

    Requirements (the homogeneous-stage contract of parallel/pipeline.py):
      - annotated ops are contiguous and stage ids increase monotonically;
      - every stage has the same op-type/attr sequence with positionally
        matching parameter shapes (a transformer layer stack);
      - consecutive stages are linked by exactly one activation (cut) var of
        a shape shared by all cuts; other stage inputs must come from the
        prologue (stage-invariant consts, e.g. the attention mask bias).

    On success: per-stage parameters are replaced by [S, ...] stacks (named
    <stage0 param>@pp_stacked, initialized in the startup program by stacking
    the per-stage inits), the stage ops move into a template sub-block, and
    the main block gets one temporal_pipeline op. Returns True. On any
    violated requirement: returns False (schedule="auto") or raises
    (schedule="temporal").
    """
    from .framework import Parameter

    block = program.global_block()
    ops = list(block.ops)

    def stage_of(op):
        d = op.attr("op_device", None)
        if isinstance(d, str) and d.startswith("stage:"):
            return int(d.split(":", 1)[1])
        return None

    tagged = [i for i, o in enumerate(ops) if stage_of(o) is not None]

    def bail(msg):
        if required:
            raise ValueError(f"PipelineOptimizer(schedule='temporal'): {msg}")
        return False

    if not tagged:
        return bail("no device_guard('stage:i') annotations found")
    first, last = tagged[0], tagged[-1]
    prologue, staged, epilogue = ops[:first], ops[first:last + 1], ops[last + 1:]

    stages, cur = [], None
    for o in staged:
        s = stage_of(o)
        if s is None:
            return bail(f"un-annotated op {o.type!r} inside the stage region")
        if s != cur:
            if cur is not None and s != cur + 1:
                return bail(f"stage ids must increase by 1 (saw {cur} -> {s})")
            if cur is None and s != 0:
                return bail(f"stages must start at 0 (saw stage:{s} first)")
            stages.append([])
            cur = s
        stages[-1].append(o)
    S = len(stages)
    if S < 2:
        return bail("need at least 2 stages")

    # homogeneity: identical op type + attr sequences (modulo the stage tag)
    def sig(sops):
        out = []
        for o in sops:
            attrs = {k: v for k, v in o.attrs.items() if k != "op_device"}
            out.append((o.type, tuple(sorted(
                (k, repr(v)) for k, v in attrs.items()))))
        return out
    template_sig = sig(stages[0])
    for i, sops in enumerate(stages[1:], 1):
        if sig(sops) != template_sig:
            return bail(f"stage {i} op sequence differs from stage 0 "
                        f"(homogeneous stacks only; use schedule='scan' for "
                        f"heterogeneous sections)")

    produced = [set(n for o in sops for ns in o.outputs.values() for n in ns)
                for sops in stages]
    consumed = [set(n for o in sops for ns in o.inputs.values() for n in ns)
                for sops in stages]
    epi_consumed = set(n for o in epilogue for ns in o.inputs.values()
                       for n in ns)

    def params_of(sops):
        seen, out = set(), []
        for o in sops:
            for slot in sorted(o.inputs):
                for n in o.inputs[slot]:
                    v = block.find_var_recursive(n)
                    if isinstance(v, Parameter) and n not in seen:
                        seen.add(n)
                        out.append(n)
        return out

    stage_params = [params_of(sops) for sops in stages]
    K = len(stage_params[0])
    for i, ps in enumerate(stage_params[1:], 1):
        if len(ps) != K:
            return bail(f"stage {i} has {len(ps)} params, stage 0 has {K}")
        for a, b in zip(stage_params[0], ps):
            va, vb = block.var(a), block.var(b)
            if tuple(va.shape) != tuple(vb.shape) or va.dtype != vb.dtype:
                return bail(f"param {b!r} ({vb.shape}) does not match stage-0 "
                            f"{a!r} ({va.shape})")

    # cut vars: single activation handed stage i -> i+1 (and last -> epilogue)
    cuts = []
    for i in range(1, S):
        link = consumed[i] & produced[i - 1]
        if len(link) != 1:
            return bail(f"stages {i-1}->{i} must be linked by exactly one "
                        f"activation var (found {sorted(link)})")
        cuts.append(next(iter(link)))
    out_link = epi_consumed & produced[S - 1]
    if len(out_link) != 1:
        return bail(f"last stage must hand exactly one var to the epilogue "
                    f"(found {sorted(out_link)})")
    out_var = next(iter(out_link))
    # no skip connections across stages: stage i's outputs may only be read
    # by stage i+1 (the cut) -- or the epilogue for the last stage
    for i in range(S - 1):
        later = set().union(*consumed[i + 2:]) if i + 2 < S else set()
        later |= epi_consumed
        leak = produced[i] & later
        if leak:
            return bail(f"stage {i} outputs {sorted(leak)} consumed beyond "
                        f"stage {i+1} (single-cut chains only)")

    # stage inputs that are neither params nor the cut: stage-invariant consts
    pro_avail = set(n for o in prologue for ns in o.outputs.values()
                    for n in ns)
    pro_avail |= {n for n, v in block.vars.items() if v.is_data}
    for i in range(S):
        cut_in = cuts[i - 1] if i > 0 else None
        for n in sorted(consumed[i]):
            if n in stage_params[i] or n == cut_in or n in produced[i]:
                continue
            if n not in pro_avail:
                return bail(f"stage {i} reads {n!r} which is neither a "
                            f"param, the cut activation, nor a prologue "
                            f"output")
    # classify stage-0 non-param inputs: consts are read by stage >= 1 too
    later_consumed = set().union(*consumed[1:]) if S > 1 else set()
    cand = [n for n in sorted(consumed[0])
            if n not in stage_params[0] and n not in produced[0]]
    const_vars = [n for n in cand if n in later_consumed]
    ins0 = [n for n in cand if n not in later_consumed]
    if len(ins0) != 1:
        return bail(f"stage 0 must consume exactly one activation from the "
                    f"prologue (found {ins0}); stage-invariant inputs must "
                    f"also be read by later stages to classify as consts")
    in_var = ins0[0]

    # cut shapes must all match (homogeneous activation)
    shapes = {tuple(block.var(n).shape) for n in cuts + [in_var, out_var]}
    if len(shapes) != 1:
        return bail(f"cut activations must share one shape, found {shapes}")

    # classify consts statically: per-example (batch-riding, microbatched by
    # the op) vs stage-invariant (replicated). Recording this as an op attr
    # here -- where declared shapes are known -- avoids the runtime
    # shape-coincidence trap (a stage-invariant const whose dim 0 happens to
    # equal the batch). Three-way result:
    #   batch:  leading dim is the dynamic batch mark (-1) like the
    #           activation's, or concretely equals the activation's concrete
    #           batch dim;
    #   static: concrete leading dim that differs from the batch dim;
    #   defer:  declared shapes can't decide (one side -1, the other
    #           concrete) -- the op falls back to its runtime heuristic for
    #           just that var.
    act_lead = tuple(block.var(in_var).shape)[0] if block.var(in_var).shape \
        else None

    def _classify(n):
        shp = tuple(block.var(n).shape)
        if not shp:
            return "static"
        if shp[0] == -1:
            return "batch" if act_lead == -1 else "defer"
        if act_lead == -1:
            return "defer"
        return "batch" if shp[0] == act_lead else "static"

    batch_const_vars = [n for n in const_vars if _classify(n) == "batch"]
    defer_const_vars = [n for n in const_vars if _classify(n) == "defer"]

    # ---- build: template sub-block + stacked params + the pipeline op ------
    sub = program._create_block(parent_idx=0)
    program._rollback()
    sub.ops = stages[0]

    stacked_names = []
    sblock = startup.global_block()
    for k in range(K):
        base = stage_params[0][k]
        v0 = block.var(base)
        sname = f"{base}@pp_stacked"
        block.create_parameter(sname, (S,) + tuple(v0.shape), v0.dtype)
        stacked_names.append(sname)
        per_stage = [stage_params[i][k] for i in range(S)]
        sv = sblock.create_var(sname, (S,) + tuple(v0.shape), v0.dtype)
        sv.persistable = True
        sblock.append_op("stack", inputs={"X": per_stage},
                         outputs={"Y": [sname]}, attrs={"axis": 0},
                         infer_shape=False)
        # the per-stage params become startup-internal temporaries: only the
        # stack persists (keeps checkpoints and executor state stack-only)
        for i in range(S):
            block.var(per_stage[i]).persistable = False
            block.var(per_stage[i]).trainable = False
            su = sblock.find_var_recursive(per_stage[i])
            if su is not None:
                su.persistable = False

    block.ops = list(prologue)
    block.append_op(
        "temporal_pipeline",
        inputs={"X": [in_var], "Params": stacked_names,
                "Consts": const_vars},
        outputs={"Out": [out_var]},
        attrs={"sub_block": sub.idx, "num_stages": S,
               "num_microbatches": max(M, 1), "axis": axis,
               "in_var": in_var, "template_out": cuts[0],
               "param_vars": list(stage_params[0]),
               "const_vars": const_vars,
               "batch_const_vars": batch_const_vars,
               "defer_const_vars": defer_const_vars},
        infer_shape=False)
    block.ops.extend(epilogue)
    return True


def _rewrite_microbatch_scan(program: Program, loss, params_grads, M):
    """Move all ops built so far (forward + backward) into a sub-block
    scanned over M microbatch slices; return {param_name: mean-grad
    Variable}. The port's copy of the JAX package's rewrite: the same ops,
    variables and names."""
    block = program.global_block()
    fwd_bwd_ops = list(block.ops)
    block.ops = []

    # data vars the step consumes (is_data) become scanned sequences. Only
    # top-level op inputs can be sliced: a sub-block resolves outer names
    # through the enclosing env, so a feed read inside a sub-block without
    # being lifted into the enclosing op's inputs would see the full batch
    # every microbatch -- refuse instead of corrupting gradients.
    data_names = []
    for op in fwd_bwd_ops:
        for n in op.input_arg_names():
            v = block.find_var_recursive(n)
            if v is not None and v.is_data and n not in data_names:
                data_names.append(n)

    def check_nested(ops, seen_blocks):
        for op in ops:
            for a in ("sub_block", "else_block"):
                si = op.attr(a, -1)
                if not (isinstance(si, int) and 0 <= si < len(program.blocks)
                        and si not in seen_blocks):
                    continue
                seen_blocks.add(si)
                sub_ops = program.blocks[si].ops
                local = set(program.blocks[si].vars)
                for sop in sub_ops:
                    for n in sop.input_arg_names():
                        v = block.find_var_recursive(n)
                        if (v is not None and v.is_data and n not in local
                                and n not in data_names):
                            raise ValueError(
                                f"PipelineOptimizer: feed var {n!r} is read inside "
                                f"sub-block {si} but is not an input of the enclosing "
                                f"control-flow op, so the microbatch slice cannot reach "
                                f"it; declare it in the op's inputs (the While/Scan DSL "
                                f"does this automatically)")
                check_nested(sub_ops, seen_blocks)

    check_nested(fwd_bwd_ops, set())

    sub = program._create_block(parent_idx=0)
    sub.ops = fwd_bwd_ops
    program._rollback()

    carry_names, init_names, final_names = [], [], []

    def add_carry(inner_name, shape, dtype, add_name, zero_like=None):
        """Accumulator carried across microbatches: inner += add_name."""
        sub.create_var(inner_name, tuple(shape), dtype).stop_gradient = True
        sub.append_op("sum", inputs={"X": [inner_name, add_name]},
                      outputs={"Out": [inner_name]}, infer_shape=False)
        zname = inner_name + "@zero"
        zv = block.create_var(zname, tuple(shape), dtype)
        zv.stop_gradient = True
        if zero_like is not None:
            block.append_op("fill_zeros_like", inputs={"X": [zero_like]},
                            outputs={"Out": [zname]}, infer_shape=False)
        else:
            block.append_op("fill_constant", outputs={"Out": [zname]},
                            attrs={"shape": [int(s) for s in shape],
                                   "value": 0.0, "dtype": dtype},
                            infer_shape=False)
        fname = inner_name + "@final"
        block.create_var(fname, tuple(shape), dtype).stop_gradient = True
        carry_names.append(inner_name)
        init_names.append(zname)
        final_names.append(fname)
        return fname

    grad_finals = {}
    for p, g in params_grads:
        if g is None:
            continue
        gd = getattr(g, "dtype", "float32")
        grad_finals[p.name] = add_carry(g.name + "@mb_acc", p.shape, gd,
                                        g.name, zero_like=p.name)
    loss_final = add_carry(loss.name + "@mb_acc", (1,), "float32", loss.name)

    mb_names = []
    for dn in data_names:
        v = block.var(dn)
        tail = [int(s) for s in v.shape[1:]]
        out = block.create_var(dn + "@mb", tuple([M, -1] + tail), v.dtype)
        out.stop_gradient = True
        block.append_op("reshape", inputs={"X": [dn]},
                        outputs={"Out": [out.name]},
                        attrs={"shape": [M, -1] + tail}, infer_shape=False)
        mb_names.append(out.name)

    block.append_op("scan",
                    inputs={"Init": init_names, "X": mb_names},
                    outputs={"Out": [], "FinalCarry": final_names},
                    attrs={"sub_block": sub.idx, "carry_names": carry_names,
                           "x_names": data_names, "out_names": [],
                           "time_major": True},
                    infer_shape=False)

    mean_grads = {}
    for p, g in params_grads:
        if g is None:
            continue
        mname = g.name + "@mb_mean"
        mv = block.create_var(mname, tuple(p.shape),
                              getattr(g, "dtype", "float32"))
        mv.stop_gradient = True
        block.append_op("scale", inputs={"X": [grad_finals[p.name]]},
                        outputs={"Out": [mname]},
                        attrs={"scale": 1.0 / M}, infer_shape=False)
        mean_grads[p.name] = block.var(mname)
    # the user-facing loss var becomes the microbatch-mean loss
    block.append_op("scale", inputs={"X": [loss_final]},
                    outputs={"Out": [loss.name]},
                    attrs={"scale": 1.0 / M}, infer_shape=False)
    return mean_grads


def _scope_tensor(scope, name):
    """The scope's value of ``name`` as a tensor (a numpy value becomes a CPU
    tensor the scope then holds), or None."""
    from .core.executor import tensor_from_numpy
    val = scope.find_var(name)
    if val is None or isinstance(val, torch.Tensor):
        return val
    t = tensor_from_numpy(val).clone()
    scope.set_var(name, t)
    return t


class _Averaged:
    """``apply`` / ``restore`` of an averaging wrapper: ``apply`` writes each
    parameter's average into the parameter's own tensor in the scope (in
    place, in its dtype, on its device, so a captured step's state stays
    bound) after keeping a copy, and ``restore`` copies the kept values
    back. ``apply`` returns a context manager that restores on exit when
    ``need_restore``."""

    def _averages(self, scope) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def apply(self, executor=None, need_restore=True):
        from .core.executor import global_scope
        scope = global_scope()
        with torch.no_grad():
            for pname, avg in self._averages(scope).items():
                p = _scope_tensor(scope, pname)
                self._backup[pname] = p.clone()
                p.copy_(avg)
        return self._guard(need_restore)

    @contextlib.contextmanager
    def _guard(self, need_restore):
        try:
            yield self
        finally:
            if need_restore:
                self.restore()

    def restore(self, executor=None):
        from .core.executor import global_scope
        scope = global_scope()
        with torch.no_grad():
            for pname, val in self._backup.items():
                _scope_tensor(scope, pname).copy_(val)
        self._backup = {}


class ExponentialMovingAverage(_Averaged):
    """EMA shadow parameters. ``update()`` (after ``minimize``) appends the
    in-graph ops: decay^t advanced by a ``scale``, and each trainable
    parameter's shadow = decay shadow + (1 - decay) param. ``apply()``
    writes shadow / (1 - decay^t) into the parameters (the shadows start
    at 0), computed on the scope's tensors; ``restore()`` puts the
    parameters back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._shadow = {}
        self._backup = {}
        self._decay_pow_name = None

    def update(self):
        block = default_main_program().global_block()
        helper = LayerHelper("ema")
        dp = helper.create_global_variable(
            [1], "float32", persistable=True, name=unique_name.generate("ema_decay_pow"),
            initializer=Constant(1.0))
        self._decay_pow_name = dp.name
        block.append_op("scale", inputs={"X": [dp.name]}, outputs={"Out": [dp.name]},
                        attrs={"scale": self._decay})
        for p in block.all_parameters():
            if not p.trainable:
                continue
            shadow = helper.create_global_variable(
                list(p.shape), "float32", persistable=True,
                name=unique_name.generate(p.name + "_ema"), initializer=Constant(0.0))
            self._shadow[p.name] = shadow.name
            tmp = block.create_var(unique_name.generate("ema_t"), p.shape, "float32")
            block.append_op("scale", inputs={"X": [shadow.name]}, outputs={"Out": [tmp]},
                            attrs={"scale": self._decay})
            tmp2 = block.create_var(unique_name.generate("ema_t"), p.shape, "float32")
            block.append_op("scale", inputs={"X": [p.name]}, outputs={"Out": [tmp2]},
                            attrs={"scale": 1.0 - self._decay})
            block.append_op("sum", inputs={"X": [tmp, tmp2]}, outputs={"Out": [shadow.name]})

    def _averages(self, scope):
        debias = None
        if self._decay_pow_name is not None:
            pw = _scope_tensor(scope, self._decay_pow_name)
            if pw is not None:
                pw = pw.reshape(-1)[:1].float()
                debias = torch.where(pw < 1.0, 1.0 - pw, torch.ones_like(pw))
        out = {}
        for pname, sname in self._shadow.items():
            s = _scope_tensor(scope, sname)
            if s is not None:
                out[pname] = s.float() / debias.to(s.device) if debias is not None else s
        return out


class ModelAverage(_Averaged):
    """Parameter averaging: one running sum and a step count per program, as
    the JAX package's (not the reference's three-tier window buffers).
    ``update()`` appends the ``increment`` and the sums; ``apply()`` writes
    sum / count into the parameters (where the count is above 0)."""

    def __init__(self, average_window_rate=0.15, min_average_window=10000,
                 max_average_window=10000000):
        self._max_window = max_average_window
        self._sums = {}
        self._backup = {}

    def _build(self):
        block = default_main_program().global_block()
        helper = LayerHelper("model_average")
        count = helper.create_global_variable(
            [1], "float32", persistable=True, name=unique_name.generate("ma_count"),
            initializer=Constant(0.0))
        block.append_op("increment", inputs={"X": [count.name]}, outputs={"Out": [count.name]},
                        attrs={"step": 1.0})
        self._count = count.name
        for p in block.all_parameters():
            if not p.trainable:
                continue
            s = helper.create_global_variable(
                list(p.shape), "float32", persistable=True,
                name=unique_name.generate(p.name + "_ma_sum"), initializer=Constant(0.0))
            self._sums[p.name] = s.name
            block.append_op("sum", inputs={"X": [s.name, p.name]}, outputs={"Out": [s.name]})

    def update(self):
        if not self._sums:
            self._build()

    def _averages(self, scope):
        cnt = _scope_tensor(scope, self._count).reshape(-1)[:1].float()
        out = {}
        for pname, sname in self._sums.items():
            s = _scope_tensor(scope, sname)
            if s is not None:
                c = cnt.to(s.device)
                out[pname] = torch.where(c > 0, s / c, _scope_tensor(scope, pname).float())
        return out


class LookaheadOptimizer:
    """Lookahead: every ``k`` steps the slow weights move ``alpha`` of the way
    to the fast ones and the fast weights restart from them; in-graph ops
    after the inner optimizer's update."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        from .layers import nn, tensor

        ops, pg = self.inner_optimizer.minimize(loss, startup_program)
        program = loss.block.program
        with program_guard(program, startup_program or default_startup_program()):
            helper = LayerHelper("lookahead")
            block = program.global_block()
            step = helper.create_global_variable(
                [1], "float32", persistable=True, name=unique_name.generate("la_step"),
                initializer=Constant(0.0))
            block.append_op("increment", inputs={"X": [step.name]},
                            outputs={"Out": [step.name]}, attrs={"step": 1.0})
            kconst = tensor.fill_constant([1], "float32", float(self.k))
            mod = nn.elementwise_mod(block.var(step.name), kconst)
            sync = tensor.cast(nn.elementwise_mul(
                tensor.cast(mod < 0.5, "float32"),
                tensor.cast(block.var(step.name) >= 0.5, "float32")), "float32")
            keep = nn.scale(sync, scale=-1.0, bias=1.0)
            for p, g in pg:
                if g is None:
                    continue
                slow = helper.create_global_variable(
                    list(p.shape), "float32", persistable=True,
                    name=unique_name.generate(p.name + "_slow"), initializer=Constant(0.0))
                init_flag = helper.create_global_variable(
                    [1], "float32", persistable=True,
                    name=unique_name.generate(p.name + "_slow_init"),
                    initializer=Constant(0.0))
                # the first update seeds slow with p
                fresh = nn.scale(block.var(init_flag.name), scale=-1.0, bias=1.0)
                slow_seeded = nn.elementwise_add(
                    nn.elementwise_mul(block.var(slow.name), block.var(init_flag.name)),
                    nn.elementwise_mul(block.var(p.name), fresh))
                block.append_op("fill_constant", outputs={"Out": [init_flag.name]},
                                attrs={"shape": [1], "dtype": "float32", "value": 1.0})
                new_slow = nn.elementwise_add(
                    slow_seeded,
                    nn.elementwise_mul(
                        nn.elementwise_sub(block.var(p.name), slow_seeded),
                        nn.elementwise_mul(sync, tensor.fill_constant(
                            [1], "float32", self.alpha))))
                block.append_op("assign", inputs={"X": [new_slow]},
                                outputs={"Out": [slow.name]})
                new_fast = nn.elementwise_add(nn.elementwise_mul(new_slow, sync),
                                              nn.elementwise_mul(block.var(p.name), keep))
                block.append_op("assign", inputs={"X": [new_fast]}, outputs={"Out": [p.name]})
        return ops, pg


class DGCMomentumOptimizer:
    """Not built, as in the JAX package: deep gradient compression trades
    compute for interconnect bandwidth that a single card does not spend;
    use Momentum."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(self.__doc__)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adadelta = AdadeltaOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
LarsMomentum = LarsMomentumOptimizer
Lamb = LambOptimizer
Dpsgd = DpsgdOptimizer
