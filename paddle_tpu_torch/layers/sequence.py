"""Sequence layers over padded data plus lengths (the port's copy of
``_seq_op``, ``_need``, ``sequence_pool``, ``sequence_first_step``,
``sequence_last_step``, ``sequence_reverse``, ``sequence_conv`` and
``sequence_unpad`` from ``paddle_tpu/layers/sequence.py``).

The reference's LoD tensors are a dense padded [B, T, ...] tensor plus an
explicit int ``length`` [B]: each function takes a ``length=`` keyword
where the reference consumed LoD.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import _out, _var


def _seq_op(op_type, x, length, attrs=None, out_slot="Out", extra_inputs=None,
            out_dtype=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = _out(helper, out_dtype or x.dtype)
    inputs = {"X": [x]}
    if length is not None:
        inputs["Length"] = [length]
    inputs.update(extra_inputs or {})
    helper.append_op(op_type, inputs=inputs, outputs={out_slot: [out]},
                     attrs=attrs or {})
    return _var(helper, out)


def _need(length, fn):
    if length is None:
        raise ValueError(f"{fn} needs `length` ([B] int tensor): the "
                         f"reference's LoD is replaced by padded+lengths")
    return length


def sequence_pool(input, pool_type, is_test=False, pad_value=0.0, length=None):
    return _seq_op("sequence_pool", input, _need(length, "sequence_pool"),
                   {"pooltype": pool_type.upper()})


def sequence_first_step(input, length=None):
    return sequence_pool(input, "FIRST", length=length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "LAST", length=length)


def sequence_reverse(x, name=None, length=None):
    return _seq_op("sequence_reverse", x, _need(length, "sequence_reverse"),
                   out_slot="Y", name=name)


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, bias_attr=None,
                  param_attr=None, act=None, name=None, length=None):
    """Context-window projection: a [filter_size * D, num_filters] filter
    and a [num_filters] bias, as the JAX layer creates them."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    D = input.shape[-1]
    f = helper.create_parameter(param_attr, [int(filter_size) * int(D), num_filters],
                                input.dtype)
    cstart = (padding_start if padding_start is not None
              else -((filter_size - 1) // 2))
    out = _out(helper, input.dtype)
    inputs = {"X": [input], "Filter": [f]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op("sequence_conv", inputs=inputs, outputs={"Out": [out]},
                     attrs={"context_length": int(filter_size),
                            "context_start": int(cstart)})
    out = helper.append_bias_op(_var(helper, out), dim_start=2, bias_attr=bias_attr)
    return helper.append_activation(out)


def sequence_unpad(x, length=None, name=None):
    return _seq_op("sequence_unpad", x, _need(length, "sequence_unpad"), name=name)
