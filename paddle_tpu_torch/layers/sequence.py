"""Sequence layers over padded data plus lengths (the port's copy of
``paddle_tpu/layers/sequence.py``).

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


def sequence_softmax(input, use_cudnn=False, name=None, length=None):
    return _seq_op("sequence_softmax", input, _need(length, "sequence_softmax"), name=name)


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = _out(helper, input[0].dtype)
    helper.append_op("sequence_concat", inputs={"X": list(input)}, outputs={"Out": [out]})
    return _var(helper, out)


def sequence_expand(x, y, ref_level=-1, name=None, ref_lengths=None, expand_times=None):
    """Row expansion by static counts (``ref_lengths`` per row, or
    ``expand_times`` for all): a Length tensor cannot set the output's
    rows."""
    attrs = {}
    if ref_lengths is not None:
        attrs["ref_lengths"] = [int(v) for v in ref_lengths]
    if expand_times is not None:
        attrs["expand_times"] = int(expand_times)
    return _seq_op("sequence_expand", x, None, attrs, name=name)


def sequence_expand_as(x, y, name=None, ref_lengths=None):
    attrs = {}
    if ref_lengths is not None:
        attrs["ref_lengths"] = [int(v) for v in ref_lengths]
    helper = LayerHelper("sequence_expand_as", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("sequence_expand_as", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs=attrs)
    return _var(helper, out)


def sequence_pad(x, pad_value=0.0, maxlen=None, name=None, length=None):
    """(padded, length), as the reference's Out and Length; ``pad_value`` a
    float or a [1] Variable."""
    extra, attrs = {}, {}
    if hasattr(pad_value, "name"):
        extra["PadValue"] = [pad_value]
    else:
        attrs["pad_value"] = float(pad_value)
    out = _seq_op("sequence_pad", x, _need(length, "sequence_pad"), attrs,
                  extra_inputs=extra, name=name)
    return out, length


def sequence_slice(input, offset, length, name=None, out_len=None):
    """x[b, offset[b] : offset[b] + out_len]: the slice length is static
    (``out_len``), the offsets a tensor."""
    if out_len is None:
        raise ValueError("sequence_slice needs out_len (a static slice length; a tensor "
                         "cannot give ragged rows)")
    helper = LayerHelper("sequence_slice", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("sequence_slice", inputs={"X": [input], "Offset": [offset]},
                     outputs={"Out": [out]}, attrs={"out_len": int(out_len)})
    return _var(helper, out)


def sequence_enumerate(input, win_size, pad_value=0, name=None, length=None):
    return _seq_op("sequence_enumerate", input, length,
                   {"win_size": int(win_size), "pad_value": int(pad_value)}, name=name)


def sequence_erase(input, tokens, name=None, length=None):
    """(erased [B, T], the new lengths [B])."""
    helper = LayerHelper("sequence_erase", name=name)
    out = _out(helper, input.dtype, stop_gradient=True)
    out_len = _out(helper, "int64", stop_gradient=True)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    helper.append_op("sequence_erase", inputs=inputs,
                     outputs={"Out": [out], "OutLength": [out_len]},
                     attrs={"tokens": [int(t) for t in tokens]})
    return _var(helper, out), _var(helper, out_len)


def sequence_reshape(input, new_dim):
    return _seq_op("sequence_reshape", input, None, {"new_dim": int(new_dim)})


def sequence_scatter(input, index, updates, name=None):
    helper = LayerHelper("sequence_scatter", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("sequence_scatter",
                     inputs={"X": [input], "Ids": [index], "Updates": [updates]},
                     outputs={"Out": [out]})
    return _var(helper, out)
