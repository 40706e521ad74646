"""Automatic mixed precision: the port's copy of
``paddle_tpu/contrib/mixed_precision.py`` (reference: Paddle's
contrib/mixed_precision/decorator.py:216 decorate, fp16_lists.py,
fp16_utils.py).

The low-precision type is bfloat16 by default, whose f32-size exponent makes
loss scaling unnecessary: ``decorate()`` rewrites to bf16 with scaling off.
The fp16-style dynamic loss scaling is kept (``use_dynamic_loss_scaling=True``):
scaled loss, gradient unscale, overflow check, scale update. On overflow the
gradients are zeroed for the step (Paddle skips the whole update through
conditional blocks; with zeroed gradients SGD and momentum updates change
nothing, Adam's moments still decay), and ``decr_every_n_nan_or_inf`` is
accepted and not read: the JAX package's documented behaviour, kept. The
zeroing is a ``where`` after the JAX package's product by 0, which alone
leaves NaN where the gradient overflowed (ROADMAP fault 3.12).

The rewrite is a Program pass (``rewrite_program``): white-list ops get
their float inputs cast to the low type, black-list ops get them cast back
to float32, and each rewritten op's outputs are inferred again (on meta
tensors). Parameters stay float32 master copies; on the card the casts run
as their own small kernels.
"""
from __future__ import annotations

from typing import List, Set, Tuple

from .. import unique_name
from ..framework import Program, is_float_dtype
from ..framework import Variable, default_main_program  # noqa: F401


class AutoMixedPrecisionLists:
    """The white and black op sets (Paddle's fp16_lists.py)."""

    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list: Set[str] = {
            "mul", "matmul", "bmm", "conv2d", "depthwise_conv2d",
            "conv2d_transpose", "conv3d",
        }
        self.black_list: Set[str] = {
            "softmax_with_cross_entropy", "cross_entropy", "mean", "sum",
            "softmax", "layer_norm", "batch_norm", "exp", "log", "reduce_sum",
            "reduce_mean", "squared_l2_norm", "sigmoid_cross_entropy_with_logits",
        }
        if custom_white_list:
            self.white_list |= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
            self.white_list -= set(custom_black_list)


def _cast_inputs(block, op, idx, to_dtype: str, lists) -> int:
    """Insert cast ops before op idx for its float tensor inputs; returns #inserted."""
    inserted = 0
    for slot, names in list(op.inputs.items()):
        new_names = []
        for n in names:
            v = block.find_var_recursive(n)
            if v is None or not is_float_dtype(v.dtype) or v.dtype == to_dtype:
                new_names.append(n)
                continue
            cast_name = f"{n}.cast_{to_dtype}"
            if not block.has_var(cast_name):
                block.insert_op(
                    idx + inserted, "cast", inputs={"X": [n]},
                    outputs={"Out": [cast_name]},
                    attrs={"in_dtype": v.dtype, "out_dtype": to_dtype})
                inserted += 1
            new_names.append(cast_name)
        op.inputs[slot] = new_names
    return inserted


def rewrite_program(main_program: Program, amp_lists: AutoMixedPrecisionLists,
                    dest_dtype: str = "bfloat16") -> None:
    """Cast white-list op inputs to dest_dtype and black-list inputs to float32
    (Paddle's fp16_utils.rewrite_program). Must run before append_backward:
    the grad ops then take the rewritten dtypes from the generic grad maker."""
    block = main_program.global_block()
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        if op.type in amp_lists.white_list:
            n = _cast_inputs(block, op, i, dest_dtype, amp_lists)
            # re-infer output dtypes for the rewritten op
            from ..core import registry
            registry.infer_shape(op, block)
            i += n + 1
        elif op.type in amp_lists.black_list:
            n = _cast_inputs(block, op, i, "float32", amp_lists)
            from ..core import registry
            registry.infer_shape(op, block)
            i += n + 1
        else:
            i += 1


class OptimizerWithMixedPrecision:
    """An optimizer with the AMP rewrite and, optionally, dynamic loss
    scaling (Paddle's decorator.py:34)."""

    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, incr_every_n_steps,
                 decr_every_n_nan_or_inf, incr_ratio, decr_ratio, dest_dtype):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling
        self._incr_every_n = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._dest_dtype = dest_dtype
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        from ..framework import program_guard, default_startup_program
        from ..layers import nn, tensor
        from ..layer_helper import LayerHelper
        from ..initializer import Constant

        program = loss.block.program
        with program_guard(program, startup_program or
                           default_startup_program()):
            rewrite_program(program, self._amp_lists, self._dest_dtype)
            loss = program.global_block().var(loss.name)

            if not self._use_dynamic and self._init_loss_scaling == 1.0:
                return self._optimizer.minimize(loss, startup_program,
                                                parameter_list, no_grad_set)

            helper = LayerHelper("loss_scaling")
            scale_var = helper.create_global_variable(
                [1], "float32", persistable=True,
                name=unique_name.generate("loss_scaling"),
                initializer=Constant(self._init_loss_scaling))
            self._loss_scaling = scale_var
            scaled_loss = nn.elementwise_mul(loss, scale_var)
            params_grads = self._optimizer.backward(
                scaled_loss, startup_program, parameter_list, no_grad_set)

            # unscale + overflow handling
            finite_flags = []
            new_pg: List[Tuple] = []
            for p, g in params_grads:
                fin = program.global_block().create_var(
                    g.name + "@FINITE", (1,), "bool")
                program.global_block().append_op(
                    "isfinite", inputs={"X": [g]}, outputs={"Out": [fin]})
                finite_flags.append(program.global_block().var(fin.name))
            all_finite = finite_flags[0]
            for f in finite_flags[1:]:
                af = program.global_block().create_var(
                    unique_name.generate("all_finite"), (1,), "bool")
                program.global_block().append_op(
                    "logical_and", inputs={"X": [all_finite], "Y": [f]},
                    outputs={"Out": [af]})
                all_finite = program.global_block().var(af.name)
            finite_f = tensor.cast(all_finite, "float32")
            inv_scale = nn.elementwise_div(finite_f, scale_var)  # 0 on overflow
            # an overflowed gradient holds inf or NaN, and inf * 0 is NaN: the
            # JAX package's product alone writes NaN into every parameter
            # (ROADMAP fault 3.12); a where() gives the zeroed gradient its
            # docstring promises
            block = program.global_block()
            zeros = {}
            for p, g in params_grads:
                if g.dtype not in zeros:
                    zeros[g.dtype] = tensor.fill_constant([1], g.dtype, 0.0)
                scaled = nn.elementwise_mul(g, inv_scale)
                out = block.create_var(unique_name.generate(g.name + "@UNSCALED"),
                                       g.shape, g.dtype)
                block.append_op("where", inputs={"Condition": [all_finite], "X": [scaled],
                                                 "Y": [zeros[g.dtype]]},
                                outputs={"Out": [out]})
                new_pg.append((p, block.var(out.name)))

            if self._use_dynamic:
                self._append_scale_update(scale_var, finite_f, helper)

            ops = self._optimizer.apply_gradients(new_pg)
        return ops, new_pg

    def _append_scale_update(self, scale_var, finite_f, helper):
        """good_steps counter; scale *= incr after N finite steps, *= decr on
        overflow (Paddle's update_loss_scaling in fp16_utils.py)."""
        from ..layers import nn, tensor
        from ..initializer import Constant
        good = helper.create_global_variable(
            [1], "float32", persistable=True,
            name=unique_name.generate("good_steps"),
            initializer=Constant(0.0))
        block = helper.main_program.global_block()
        # good = (good + 1) * finite   (resets on overflow)
        g1 = nn.elementwise_mul(nn.scale(block.var(good.name), bias=1.0),
                                finite_f)
        # grow: if good >= N: scale *= incr; good = 0
        grow = tensor.cast(g1 >= float(self._incr_every_n), "float32")
        keep = nn.scale(grow, scale=-1.0, bias=1.0)
        # overflow: finite_f == 0 -> scale *= decr
        overflow = nn.scale(finite_f, scale=-1.0, bias=1.0)
        factor = nn.elementwise_add(
            nn.elementwise_add(
                nn.elementwise_mul(grow, tensor.fill_constant(
                    [1], "float32", self._incr_ratio)),
                nn.elementwise_mul(
                    nn.elementwise_mul(keep, finite_f),
                    tensor.fill_constant([1], "float32", 1.0))),
            nn.elementwise_mul(overflow, tensor.fill_constant(
                [1], "float32", self._decr_ratio)))
        new_scale = nn.elementwise_mul(block.var(scale_var.name), factor)
        block.append_op("assign", inputs={"X": [new_scale]},
                        outputs={"Out": [scale_var.name]})
        new_good = nn.elementwise_mul(g1, keep)
        block.append_op("assign", inputs={"X": [new_good]},
                        outputs={"Out": [good.name]})


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.5, use_dynamic_loss_scaling=False,
             dest_dtype="bfloat16"):
    """Paddle's decorator.py:216, with the JAX package's defaults: bf16, no
    loss scaling. Pass dest_dtype='float16' and use_dynamic_loss_scaling=True
    for fp16-style AMP."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio, decr_ratio,
        dest_dtype)
