"""LR schedules (the port's copy of ``paddle_tpu/layers/learning_rate_scheduler.py``;
reference: python/paddle/fluid/layers/learning_rate_scheduler.py:
noam/exponential/natural_exp/inverse_time/polynomial/piecewise/cosine/linear_warmup).

A schedule is ops of the training program over the global step, a
persistable int64 counter (``@LR_DECAY_COUNTER@``) that each schedule's
``increment`` op advances once a run: on the card they run inside the
step's CUDA graph, and the learning rate they compute is a one-element
tensor that ``multi_tensor_update`` reads on the card. As in the JAX
package, every schedule appends its own ``increment``, so a nested
schedule (``linear_lr_warmup`` over ``polynomial_decay``) advances the
counter once per schedule a run, and the inner one reads the count after
its own increment.
"""
from __future__ import annotations

import math

from ..framework import default_main_program
from ..initializer import Constant
from ..layer_helper import LayerHelper
from . import nn, tensor


GLOBAL_STEP_NAME = "@LR_DECAY_COUNTER@"


def _global_step():
    helper = LayerHelper("global_step")
    block = default_main_program().global_block()
    if block.has_var(GLOBAL_STEP_NAME):
        return block.var(GLOBAL_STEP_NAME)
    v = helper.create_global_variable([1], "int64", persistable=True,
                                      name=GLOBAL_STEP_NAME,
                                      initializer=Constant(0))
    return v


def _autoincreased_step_counter(begin=0):
    """Increment the global step (called by Optimizer before LR evaluation)."""
    v = _global_step()
    block = default_main_program().global_block()
    block.append_op("increment", inputs={"X": [v]}, outputs={"Out": [v]},
                    attrs={"step": 1.0})
    return tensor.cast(v, "float32")


def noam_decay(d_model, warmup_steps):
    step = _autoincreased_step_counter()
    a = nn.pow(step, -0.5)
    b = step * (warmup_steps ** -1.5)
    lr = (d_model ** -0.5) * nn.elementwise_min(a, b)
    return lr


def _pow_scalar(base, exponent_var):
    b = tensor.fill_constant([1], "float32", base)
    return nn.elementwise_pow(b, exponent_var)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _autoincreased_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    return nn.scale(_pow_scalar(decay_rate, div), scale=learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _autoincreased_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    return nn.scale(nn.exp(nn.scale(div, scale=-decay_rate)),
                    scale=learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    step = _autoincreased_step_counter()
    div = step / float(decay_steps)
    if staircase:
        div = nn.floor(div)
    denom = nn.scale(nn.scale(div, scale=decay_rate), bias=1.0)
    return nn.elementwise_div(tensor.fill_constant([1], "float32",
                                                   learning_rate), denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    step = _autoincreased_step_counter()
    if cycle:
        div = nn.ceil(step / float(decay_steps))
        div = nn.elementwise_max(div, tensor.ones([1]))
        decay_var = nn.scale(div, scale=float(decay_steps))
    else:
        decay_var = tensor.fill_constant([1], "float32", float(decay_steps))
        step = nn.elementwise_min(step, decay_var)
    frac = nn.elementwise_div(step, decay_var)
    one_minus = nn.scale(frac, scale=-1.0, bias=1.0)
    powed = nn.elementwise_pow(one_minus,
                               tensor.fill_constant([1], "float32", power))
    return nn.scale(powed, scale=(learning_rate - end_learning_rate),
                    bias=end_learning_rate)


def piecewise_decay(boundaries, values):
    """values[i] for step < boundaries[i] (reference semantics)."""
    step = _autoincreased_step_counter()
    lr = tensor.fill_constant([1], "float32", values[-1])
    for b, v in zip(reversed(boundaries), reversed(values[:-1])):
        cond = nn.cast(step < float(b), "float32")
        vv = tensor.fill_constant([1], "float32", v)
        lr = nn.elementwise_add(nn.elementwise_mul(cond, vv),
                                nn.elementwise_mul(nn.scale(cond, scale=-1.0,
                                                            bias=1.0), lr))
    return lr


def cosine_decay(learning_rate, step_each_epoch, epochs):
    step = _autoincreased_step_counter()
    epoch = nn.floor(step / float(step_each_epoch))
    lr = nn.scale(
        nn.scale(nn.cos(nn.scale(epoch, scale=math.pi / epochs)), bias=1.0),
        scale=0.5 * learning_rate)
    return lr


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    step = _autoincreased_step_counter()
    if not hasattr(learning_rate, "name"):
        learning_rate = tensor.fill_constant([1], "float32",
                                             float(learning_rate))
    warm = nn.scale(step, scale=(end_lr - start_lr) / float(warmup_steps),
                    bias=start_lr)
    cond = nn.cast(step < float(warmup_steps), "float32")
    return nn.elementwise_add(
        nn.elementwise_mul(cond, warm),
        nn.elementwise_mul(nn.scale(cond, scale=-1.0, bias=1.0), learning_rate))
