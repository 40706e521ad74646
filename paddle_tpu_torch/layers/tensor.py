"""Tensor layers (the port's copy of ``paddle_tpu/layers/tensor.py``; this
slice needs ``cast``)."""
from __future__ import annotations

from ..framework import convert_dtype
from ..layer_helper import LayerHelper


def cast(x, dtype):
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return helper.main_program.current_block().var(out.name)
