"""Tensor layers (the port's copy of ``paddle_tpu/layers/tensor.py``).

``range`` and ``linspace`` pass their bounds as tensors, as the JAX
package's do, so shape inference refuses them there as in the JAX package:
a tensor cannot set an output shape."""
from __future__ import annotations

import numpy as np

from .. import unique_name
from ..framework import Variable, convert_dtype, default_main_program
from ..layer_helper import LayerHelper, ParamAttr


def _out(helper, dtype="float32", stop_gradient=False):
    return helper.create_variable_for_type_inference(dtype, stop_gradient)


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


def create_tensor(dtype="float32", name=None, persistable=False):
    block = default_main_program().current_block()
    return block.create_var(name or unique_name.generate("tensor"), (), dtype,
                            persistable=persistable)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False,
                      name=None):
    from ..initializer import Constant
    helper = LayerHelper("global_var", name=name)
    return helper.create_global_variable(shape, dtype, persistable=persistable,
                                         name=name, initializer=Constant(value))


def argmax(x, axis=0):
    helper = LayerHelper("argmax")
    out = _out(helper, "int64", stop_gradient=True)
    helper.append_op("arg_max", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return helper.main_program.current_block().var(out.name)


def argmin(x, axis=0):
    helper = LayerHelper("argmin")
    out = _out(helper, "int64", stop_gradient=True)
    helper.append_op("arg_min", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return helper.main_program.current_block().var(out.name)


def argsort(x, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = _out(helper, x.dtype)
    ids = _out(helper, "int64", stop_gradient=True)
    helper.append_op("argsort", inputs={"X": [x]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis, "descending": descending})
    blk = helper.main_program.current_block()
    return blk.var(out.name), blk.var(ids.name)


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = _out(helper, x.dtype)
    helper.append_op("fill_any_like", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"value": 1.0})
    return helper.main_program.current_block().var(out.name)


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = _out(helper, x.dtype)
    helper.append_op("fill_zeros_like", inputs={"X": [x]}, outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def range(start, end, step, dtype):
    helper = LayerHelper("range")
    dtype = convert_dtype(dtype)

    def _c(v):
        return fill_constant([1], dtype, float(v)) if not isinstance(v, Variable) else v

    start, end, step = _c(start), _c(end), _c(step)
    out = _out(helper, dtype, stop_gradient=True)
    helper.append_op("range", inputs={"Start": [start], "End": [end],
                                      "Step": [step]}, outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")

    def _c(v, dt):
        return fill_constant([1], dt, float(v)) if not isinstance(v, Variable) else v

    start, stop = _c(start, dtype), _c(stop, dtype)
    num = _c(num, "int32")
    out = _out(helper, dtype, stop_gradient=True)
    helper.append_op("linspace", inputs={"Start": [start], "Stop": [stop],
                                         "Num": [num]}, outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def diag(diagonal):
    helper = LayerHelper("diag")
    out = _out(helper, diagonal.dtype)
    helper.append_op("diag", inputs={"Diagonal": [diagonal]},
                     outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    out = _out(helper, dtype, stop_gradient=True)
    helper.append_op("eye", outputs={"Out": [out]},
                     attrs={"num_rows": num_rows,
                            "num_columns": num_columns or num_rows,
                            "dtype": convert_dtype(dtype)})
    return helper.main_program.current_block().var(out.name)


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = _out(helper, x.dtype)
    helper.append_op("reverse", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis if isinstance(axis, (list, tuple))
                            else [axis]})
    return helper.main_program.current_block().var(out.name)


def isfinite(x):
    """Reference tensor.py:isfinite -- scalar [1] bool-ish all-finite check."""
    helper = LayerHelper("isfinite")
    out = _out(helper, "bool", stop_gradient=True)
    helper.append_op("isfinite", inputs={"X": [x]}, outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def has_nan(x):
    from . import nn as _nn
    from .control_flow import equal
    from .extras import logical_not
    # any(x != x) is the NaN test; finite check excludes inf
    neq = _nn.cast(logical_not(equal(x, x)), "float32")
    s = _nn.reduce_sum(neq)
    return _nn.cast(_nn.reshape(s, [1]), "bool")


def has_inf(x):
    from . import nn as _nn
    from .control_flow import equal
    # |x| == inf elementwise: inf is detected even when NaNs coexist
    inf = fill_constant([1], x.dtype, float("inf"))
    eq = _nn.cast(equal(_nn.abs(x), inf), "float32")
    return _nn.cast(_nn.reshape(_nn.reduce_sum(eq), [1]), "bool")


def tensor_array_to_tensor(input, axis=1, name=None):
    """A TensorArray (a fixed-capacity stacked buffer) concatenated along
    ``axis``: every slot read and concatenated. Returns (out, the [capacity]
    int32 size of each slot along ``axis``), as the reference's (Out,
    OutIndex)."""
    import builtins
    from .control_flow import array_read
    cap = int(input.shape[0])
    reads = [array_read(input, fill_constant([1], "int32", t))
             for t in builtins.range(cap)]   # this module's range() shadows the builtin
    out = concat(reads, axis=axis)
    sizes = fill_constant([cap], "int32",
                          float(reads[0].shape[axis] if reads[0].shape[axis] != -1 else 1))
    return out, sizes
