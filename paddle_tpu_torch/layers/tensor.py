"""Tensor layers (the port's copy of ``cast`` and ``create_parameter`` from
``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

from ..framework import convert_dtype
from ..layer_helper import LayerHelper, ParamAttr


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return helper.main_program.current_block().var(out.name)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter")
    attr = ParamAttr._to_attr(attr)
    if name:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)
