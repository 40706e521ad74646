"""Tensor layers (the port's copy of ``cast``, ``concat``, ``sums``,
``create_parameter``, ``fill_constant``, ``fill_constant_batch_size_like``
and ``assign`` from
``paddle_tpu/layers/tensor.py``)."""
from __future__ import annotations

import numpy as np

from ..framework import convert_dtype
from ..layer_helper import LayerHelper, ParamAttr


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return helper.main_program.current_block().var(out.name)


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op("concat", inputs={"X": list(input)}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return helper.main_program.current_block().var(out.name)


def _append_sum(layer, xs, out=None):
    """One ``sum`` op over the list ``xs``; ``layer`` names the output
    variable (``sums`` and ``extras.sum`` differ only in that name)."""
    helper = LayerHelper(layer)
    if out is None:
        out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op("sum", inputs={"X": list(xs)}, outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def sums(input, out=None):
    return _append_sum("sums", input, out)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter")
    attr = ParamAttr._to_attr(attr)
    if name:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": convert_dtype(dtype), "value": float(value)})
    return helper.main_program.current_block().var(out.name)


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    helper.append_op("fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": convert_dtype(dtype), "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return helper.main_program.current_block().var(out.name)


def assign(input, output=None):
    """A numpy array becomes an ``assign_value`` op holding its values; a
    Variable is copied by an ``assign`` op."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(str(input.dtype))
        helper.append_op("assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": convert_dtype(str(input.dtype)),
                                "values": input.reshape(-1).tolist()})
    else:
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op("assign", inputs={"X": [input]}, outputs={"Out": [output]})
    return helper.main_program.current_block().var(output.name)
