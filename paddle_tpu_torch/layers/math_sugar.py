"""Operator-overload sugar for Variable (+, -, *, /, **, comparisons,
slicing): the port's copy of ``paddle_tpu/layers/math_sugar.py``. Each
operator appends the op the JAX package's does, with the same slots and
attrs; a Python number becomes a ``fill_constant`` of shape [1] in the
Variable's dtype.

Reference: python/paddle/fluid/layers/math_op_patch.py (monkey_patch_variable).
"""
from __future__ import annotations

import numpy as np

from .. import unique_name
from ..framework import Variable


def _block(var: Variable):
    return var.block.program.current_block()


def _tmp(var: Variable, dtype=None):
    return _block(var).create_var(unique_name.generate("tmp"), (), dtype or var.dtype)


def _to_var(block, value, like: Variable):
    if isinstance(value, Variable):
        return value
    out = block.create_var(unique_name.generate("const"), (), like.dtype,
                           stop_gradient=True)
    block.append_op("fill_constant", outputs={"Out": [out]},
                    attrs={"shape": [1], "dtype": like.dtype, "value": float(value)})
    return out


def binary(x: Variable, other, op_type: str, reverse=False) -> Variable:
    block = _block(x)
    y = _to_var(block, other, x)
    if reverse:
        x, y = y, x
    out = _tmp(x)
    block.append_op(op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                    attrs={"axis": -1})
    return block.var(out.name)


def scale(x: Variable, s: float, bias: float = 0.0) -> Variable:
    block = _block(x)
    out = _tmp(x)
    block.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                    attrs={"scale": float(s), "bias": float(bias), "bias_after_scale": True})
    return block.var(out.name)


def getitem(x: Variable, item) -> Variable:
    """``x[...]`` as a ``slice`` op over the sliced axes (an int index also
    squeezes its axis with ``squeeze2``); strides other than 1 raise, as in
    the JAX package."""
    if not isinstance(item, tuple):
        item = (item,)
    axes, starts, ends, squeeze_axes = [], [], [], []
    for i, it in enumerate(item):
        if isinstance(it, slice):
            if it.step not in (None, 1):
                raise NotImplementedError("strided slicing not supported in sugar")
            if it.start is None and it.stop is None:
                continue
            axes.append(i)
            starts.append(0 if it.start is None else it.start)
            ends.append(np.iinfo(np.int32).max if it.stop is None else it.stop)
        elif isinstance(it, int):
            axes.append(i)
            starts.append(it)
            ends.append(it + 1 if it != -1 else np.iinfo(np.int32).max)
            squeeze_axes.append(i)
        else:
            raise TypeError(f"unsupported index {it!r}")
    block = _block(x)
    out = _tmp(x)
    block.append_op("slice", inputs={"Input": [x]}, outputs={"Out": [out]},
                    attrs={"axes": axes, "starts": starts, "ends": ends})
    cur = block.var(out.name)
    if squeeze_axes:
        out2 = _tmp(x)
        block.append_op("squeeze2", inputs={"X": [cur]}, outputs={"Out": [out2]},
                        attrs={"axes": squeeze_axes})
        cur = block.var(out2.name)
    return cur
