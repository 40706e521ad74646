"""Post-training weight quantization (the port's copy of
``paddle_tpu/contrib/quantize.py``).

Weights are stored int8 with per-output-channel symmetric scales (4x fewer
weight bytes on the card and in the checkpoint). By default each consumer
reads the weight through a ``dequantize_weight`` op. ``int8_compute=True``
swaps every ``mul`` with a quantized 2-D weight for ``quantized_mul``: the
activation is quantized dynamically per row and multiplied int8 x int8 ->
int32 on the card's CUDA kernel (``ops/int8_matmul.py``).

The codes and scales are computed with numpy from the weights' f32 view,
exactly as the JAX package computes them, so both packages quantize the same
weights to the same bits, and a quantized model saved by either loads in the
other.

API::

    quantize_weights(program, scope)           # rewrite in place, returns
                                               # {param: (bits, scale_name)}
    # then run / save_inference_model as usual -- the checkpoint stores int8
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.registry import register, torch_dtype
from ..framework import Program
from ..ops.int8_matmul import int8_matmul

# ops whose weight input can be quantized: slot holding the weight
_WEIGHT_SLOTS = {"mul": "Y", "matmul": "Y", "conv2d": "Filter",
                 "conv3d": "Filter", "conv2d_transpose": "Filter"}


@register("quantized_mul", grad=None, nondiff_inputs=("Y", "YScale"))
def quantized_mul(ctx, ins):
    """int8 x int8 -> int32 matmul: X flattened to 2-D at ``x_num_col_dims``
    and quantized dynamically per row (abs-max / 127), against the int8
    weight Y [K, N] with its per-output-channel scale YScale [N]. On the
    card every call launches the CUDA kernel (a shape it refuses raises); on
    the CPU it runs the kernel's plain version. A YScale that a serving-dtype
    override cast to bf16 is widened to f32, as JAX's type promotion does."""
    x, w8, wscale = ins["X"][0], ins["Y"][0], ins["YScale"][0]
    ncol = ctx.attr("x_num_col_dims", 1) or 1
    lead = tuple(x.shape[:ncol])
    x2 = x.reshape(math.prod(lead), -1)
    N = w8.shape[1]
    if ctx.abstract:
        out = x2.new_empty((x2.shape[0], N))
    else:
        out = int8_matmul(x2.contiguous(), w8, wscale.float())
    return {"Out": [out.reshape(lead + (N,))]}


@register("dequantize_weight", grad=None, nondiff_inputs=("X", "Scale"))
def dequantize_weight(ctx, ins):
    """int8 weight * per-channel scale (in f32) -> ``out_dtype``."""
    w8, scale = ins["X"][0], ins["Scale"][0]
    axis = int(ctx.attr("channel_axis", -1))
    shape = [1] * w8.ndim
    shape[axis] = w8.shape[axis]
    out = w8.float() * scale.float().reshape(shape)
    return {"Out": [out.to(torch_dtype(ctx.attr("out_dtype", "float32")))]}


def _as_numpy(w):
    """A scope value as numpy: a bf16 tensor as its exact f32 widening
    (flagged), anything else in its own dtype. Returns (array, is_bf16)."""
    if isinstance(w, torch.Tensor):
        w = w.detach()
        if w.dtype == torch.bfloat16:
            return w.float().cpu().numpy(), True
        return w.cpu().numpy(), False
    w = np.asarray(w)
    return w, w.dtype.name == "bfloat16"


def _like(value, array):
    """numpy array -> tensor on the device of the scope value it replaces."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    return t.to(value.device) if isinstance(value, torch.Tensor) else t


def _quantize_array(w: np.ndarray, channel_axis: int, bits: int):
    qmax = 2 ** (bits - 1) - 1
    red = tuple(i for i in range(w.ndim) if i != channel_axis)
    scale = np.max(np.abs(w), axis=red).astype("float32") / qmax
    scale = np.maximum(scale, 1e-12)
    shape = [1] * w.ndim
    shape[channel_axis] = w.shape[channel_axis]
    q = np.clip(np.round(w / scale.reshape(shape)), -qmax - 1, qmax)
    return q.astype("int8"), scale


def quantize_weights(program: Program, scope, weight_bits: int = 8,
                     quantizable_op_type: Optional[Sequence[str]] = None,
                     min_elements: int = 1024,
                     int8_compute: bool = False) -> Dict[str, Tuple[int, str]]:
    """Weight-only PTQ rewrite (the quant_transpiler analog).

    For each weight input of a quantizable op: store the int8 array +
    per-output-channel scale in the scope, and insert a dequantize_weight op
    ahead of the consumer. Params smaller than ``min_elements`` are skipped
    (no memory win, pure accuracy cost). Returns {param_name: (bits,
    scale_var_name)}. Run on an inference program (clone(for_test=True) or a
    loaded inference model); training through quantized weights is QAT,
    which this pass does not do.

    ``int8_compute=True`` additionally swaps ``mul`` ops whose weight was
    quantized for ``quantized_mul`` (dynamic per-row activation scales, the
    int8 x int8 CUDA kernel on the card). The scope's values may be torch
    tensors on any device (bf16 quantized from their f32 view) or numpy
    arrays; the codes and scales replace them on the same device.
    """
    ops = set(quantizable_op_type or _WEIGHT_SLOTS)
    block = program.global_block()
    done: Dict[str, Tuple[int, str]] = {}
    insertions = []   # (op_index, weight_name, deq_name)

    for idx, op in enumerate(block.ops):
        slot = _WEIGHT_SLOTS.get(op.type)
        if op.type not in ops or slot is None:
            continue
        for i, name in enumerate(op.inputs.get(slot, [])):
            v = block.find_var_recursive(name)
            w = scope.find_var(name)
            if v is None or w is None or not getattr(v, "persistable", False):
                continue
            value = w
            w, is_bf16 = _as_numpy(w)
            if w.size < min_elements or (w.dtype.kind != "f" and not is_bf16):
                continue
            if is_bf16:
                w = w.astype("float32")
            # output channels: matmul weights last dim; conv filters dim 0;
            # transpose-conv filters [C_in, C_out, ...] -> dim 1
            if "transpose" in op.type:
                ch = 1
            elif "conv" in op.type:
                ch = 0
            else:
                ch = w.ndim - 1
            deq_name = name + "@deq"
            if name not in done:
                q, scale = _quantize_array(w, ch, weight_bits)
                scope.set_var(name, _like(value, q))
                scope.set_var(name + "@scale", _like(value, scale))
                v.dtype = "int8"
                sv = block.create_var(name + "@scale", tuple(scale.shape),
                                      "float32")
                sv.persistable = True
                dv = block.create_var(deq_name, tuple(w.shape),
                                      "bfloat16" if is_bf16
                                      else str(w.dtype))
                dv.stop_gradient = True
                done[name] = (weight_bits, name + "@scale")
                insertions.append((idx, name, ch, str(dv.dtype)))
            if (int8_compute and op.type == "mul" and weight_bits == 8
                    and w.ndim == 2):
                # the int8 kernel consumes the int8 weight + scale directly,
                # no dequant op needed for this consumer
                op.type = "quantized_mul"
                op.inputs["YScale"] = [name + "@scale"]
            else:
                op.inputs[slot][i] = deq_name

    # Every OTHER consumer of a quantized weight (any op outside
    # _WEIGHT_SLOTS, e.g. a tied-embedding lookup) must read the dequantized
    # view too -- the original name now holds raw int8 codes.
    deq_ops = {"dequantize_weight", "quantized_mul"}
    for op in block.ops:
        if op.type in deq_ops:
            continue
        for slot, names in op.inputs.items():
            for i, n in enumerate(names):
                if n in done and not (
                        _WEIGHT_SLOTS.get(op.type) == slot):
                    names[i] = n + "@deq"

    # insert dequantize ops (reverse order keeps indices valid) for any
    # consumer still reading the dequantized view
    needed = {n for op in block.ops for n in op.input_arg_names()}
    for idx, name, ch, dtype in sorted(insertions, reverse=True):
        if name + "@deq" not in needed:
            continue
        block.insert_op(
            idx, "dequantize_weight",
            inputs={"X": [name], "Scale": [name + "@scale"]},
            outputs={"Out": [name + "@deq"]},
            attrs={"channel_axis": ch, "out_dtype": dtype},
            infer_shape=False)
    program._bump()
    return done


class QuantizeTranspiler:
    """Facade with the surface of Fluid's contrib.quantize.QuantizeTranspiler."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000):
        if activation_quantize_type not in (None, "abs_max"):
            raise NotImplementedError(
                "activation quantization: post-training quantization here is "
                "weight-only; activations stay in their float dtype")
        self.weight_bits = weight_bits

    def training_transpile(self, program=None, startup_program=None):
        raise NotImplementedError(
            "QAT fake-quant training is not built; train in bf16 and use "
            "quantize_weights() for serving")

    def freeze_program(self, program, place=None, scope=None):
        from ..core.executor import global_scope
        return quantize_weights(program, scope or global_scope(),
                                self.weight_bits)
