"""Gradient clipping: the port's copy of ``paddle_tpu/clip.py``
(GradientClipByValue, GradientClipByNorm, GradientClipByGlobalNorm,
ErrorClipByValue).

A clip class appends ops to the program that rewrite a gradient before the
update op reads it. ``set_gradient_clip`` marks parameters with a clip attr,
which ``Optimizer.apply_gradients`` applies (``append_gradient_clip_ops``);
``Optimizer.minimize(grad_clip=...)`` applies one clip to every gradient
first (``apply_clip_to_all``).
"""
from __future__ import annotations

from .framework import default_main_program
from .layers import nn, tensor


class BaseGradientClipAttr:
    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    """Each element clipped to [min, max] (min defaults to -max)."""

    def __init__(self, max, min=None):
        if min is None:
            min = -max
        self.max, self.min = float(max), float(min)

    def _create_operators(self, param, grad):
        return param, nn.clip(grad, self.min, self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    """Each gradient scaled to L2 norm ``clip_norm`` where it exceeds it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _create_operators(self, param, grad):
        return param, nn.clip_by_norm(grad, self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """g_i * clip_norm / max(global_norm, clip_norm), the global norm taken
    over the gradients of one ``group_name``."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def clip_all(self, params_grads):
        sq_norms = []
        kept = []
        for p, g in params_grads:
            if g is None:
                continue
            kept.append((p, g))
            block = default_main_program().global_block()
            sq = block.create_var(g.name + "@SQN", (1,), g.dtype)
            block.append_op("squared_l2_norm", inputs={"X": [g]}, outputs={"Out": [sq]})
            sq_norms.append(block.var(sq.name))
        global_norm = nn.sqrt(tensor.sums(sq_norms))
        clip_var = tensor.fill_constant([1], "float32", self.clip_norm)
        scale = nn.elementwise_div(clip_var, nn.elementwise_max(global_norm, clip_var))
        return [(p, nn.elementwise_mul(g, scale)) for p, g in kept]


class ErrorClipByValue:
    def __init__(self, max, min=None):
        self.max, self.min = max, min if min is not None else -max


def set_gradient_clip(clip, param_list=None, program=None):
    """Mark the parameters of ``param_list`` (names or Parameters; all of the
    program's when None) with the clip attr ``clip``."""
    program = program or default_main_program()
    if param_list is None:
        params = program.all_parameters()
    else:
        params = [program.global_block().var(p if isinstance(p, str) else p.name)
                  for p in param_list]
    for p in params:
        p.gradient_clip = clip


def apply_clip_to_all(clip, params_grads):
    """One explicit clip applied to every gradient (``minimize(grad_clip=)``)."""
    if isinstance(clip, GradientClipByGlobalNorm):
        clipped = clip.clip_all([(p, g) for p, g in params_grads if g is not None])
        return clipped + [(p, g) for p, g in params_grads if g is None]
    return [clip._create_operators(p, g) if g is not None else (p, g)
            for p, g in params_grads]


def append_gradient_clip_ops(params_grads):
    """Apply per-param clip attrs; ByGlobalNorm groups all params sharing the
    attr's ``group_name``."""
    global_norm_groups = {}
    result = []
    for p, g in params_grads:
        clip = getattr(p, "gradient_clip", None)
        if g is None or clip is None:
            result.append((p, g))
        elif isinstance(clip, GradientClipByGlobalNorm):
            global_norm_groups.setdefault(clip.group_name, (clip, []))[1].append((p, g))
        else:
            result.append(clip._create_operators(p, g))
    for clip, pg in global_norm_groups.values():
        result.extend(clip.clip_all(pg))
    return result
