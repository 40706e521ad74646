"""The extended surface (the port's copy of ``dynamic_lstm``, ``dynamic_gru``,
``_seq_reverse``, ``_mask_padded``, ``linear_chain_crf``, ``crf_decoding``,
``sum``, the logical layers, ``shard_index``, ``mse_loss``, ``rank``,
``autoincreased_step_counter``, ``strided_slice``, ``scatter_nd_add``,
``scatter_nd`` and ``expand_as`` from ``paddle_tpu/layers/extras.py``;
reference: python/paddle/fluid/layers/nn.py linear_chain_crf:1589,
crf_decoding:1650, dynamic_lstm:466, dynamic_gru:868).

Sequences are padded [B, T, ...] tensors plus a ``length`` [B]. A reverse
layer reverses each row's first ``length`` steps, runs the forward
recurrence and reverses back; a row's steps past its length are zeroed.
"""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper
from .nn import _out, _var
from .tensor import _append_sum


def linear_chain_crf(input, label, param_attr=None, length=None):
    """Reference nn.py:1589. Returns the negative log-likelihood [B, 1]
    (the reference kernel's convention: minimise it as it is). The
    transition parameter is [N+2, N]: start, stop, then pairwise scores."""
    if length is None:
        raise ValueError("linear_chain_crf needs `length` (padded+lengths replaces LoD)")
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    N = input.shape[-1]
    trans = helper.create_parameter(param_attr, [N + 2, N], input.dtype)
    ll = _out(helper, input.dtype)
    helper.append_op("linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [trans],
                             "Label": [label], "Length": [length]},
                     outputs={"LogLikelihood": [ll]})
    return _var(helper, ll)


def crf_decoding(input, param_attr, label=None, length=None):
    """Reference nn.py:1650. Viterbi path [B, T] (0 past each row's
    length), over the transition parameter that ``linear_chain_crf``
    created under the same ``ParamAttr`` name."""
    helper = LayerHelper("crf_decoding")
    trans = default_main_program().global_block().var(
        param_attr.name if not isinstance(param_attr, str) else param_attr)
    out = _out(helper, "int64", stop_gradient=True)
    if length is None:
        raise ValueError("crf_decoding needs `length`")
    helper.append_op("crf_decoding",
                     inputs={"Emission": [input], "Transition": [trans],
                             "Length": [length]},
                     outputs={"ViterbiPath": [out]})
    return _var(helper, out)


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=False, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None,
                 length=None):
    """Reference nn.py:466 (LoD dynamic LSTM). Padded [B, T, 4H]-projected
    input + optional `length` masking; returns (hidden [B, T, H], cell)."""
    from .rnn import simple_lstm
    if use_peepholes:
        raise NotImplementedError("peephole connections: use simple_lstm + "
                                  "custom cell (rare in practice)")
    H = size // 4
    x = input
    if is_reverse:
        x = _seq_reverse(x, length)
    h, c = simple_lstm(x, H, param_attr=param_attr, bias_attr=bias_attr,
                       h0=h_0, c0=c_0, return_cell=True)
    if length is not None:
        h = _mask_padded(h, length)
        c = _mask_padded(c, length)
    if is_reverse:
        h = _seq_reverse(h, length)
        c = _seq_reverse(c, length)
    return h, c


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, origin_mode=False,
                length=None):
    """Reference nn.py:868. Padded + masked GRU; returns hidden [B, T, H]."""
    from .rnn import simple_gru
    x = input
    if is_reverse:
        x = _seq_reverse(x, length)
    h = simple_gru(x, size, param_attr=param_attr, bias_attr=bias_attr, h0=h_0)
    if length is not None:
        h = _mask_padded(h, length)
    if is_reverse:
        h = _seq_reverse(h, length)
    return h


def _seq_reverse(x, length):
    from .sequence import sequence_reverse
    if length is None:
        from .tensor import fill_constant_batch_size_like
        length = fill_constant_batch_size_like(x, [-1], "int64", float(x.shape[1]))
    return sequence_reverse(x, length=length)


def _mask_padded(x, length):
    from .sequence import sequence_unpad
    return sequence_unpad(x, length=length)


def sum(x):
    """Reference nn.py:sum -- elementwise sum of a tensor list."""
    return _append_sum("sum", x if isinstance(x, (list, tuple)) else [x])


# -- logical / tensor utility wrappers --------------------------------------------------

def _logical(op_type):
    def layer(x, y=None, out=None, name=None):
        helper = LayerHelper(op_type, name=name)
        o = out or _out(helper, "bool", stop_gradient=True)
        inputs = {"X": [x]} if y is None else {"X": [x], "Y": [y]}
        helper.append_op(op_type, inputs=inputs, outputs={"Out": [o]})
        return _var(helper, o)
    layer.__name__ = op_type
    return layer


logical_and = _logical("logical_and")
logical_or = _logical("logical_or")
logical_xor = _logical("logical_xor")
logical_not = _logical("logical_not")


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    helper = LayerHelper("shard_index")
    out = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("shard_index", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"index_num": index_num, "nshards": nshards,
                            "shard_id": shard_id, "ignore_value": ignore_value})
    return _var(helper, out)


def mse_loss(input, label):
    from . import nn as _nn
    return _nn.reduce_mean(_nn.square_error_cost(input, label))


def rank(input):
    from .tensor import fill_constant
    return fill_constant([1], "int32", len(input.shape))


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Reference nn.py:autoincreased_step_counter: a persistable int counter
    incremented by `step` on every run."""
    from ..framework import default_startup_program
    from ..initializer import Constant
    main = default_main_program()
    block = main.global_block()
    name = counter_name or "@STEP_COUNTER@"
    if name in block.vars:
        counter = block.vars[name]
    else:
        counter = block.create_var(name, (1,), "int64")
        counter.persistable = True
        counter.stop_gradient = True
        sb = default_startup_program().global_block()
        sv = sb.create_var(name, (1,), "int64")
        sv.persistable = True
        sb.append_op("fill_constant", outputs={"Out": [name]},
                     attrs={"shape": [1], "dtype": "int64",
                            "value": float(begin - step)},
                     infer_shape=False)
    block.append_op("increment", inputs={"X": [counter]},
                    outputs={"Out": [counter]}, attrs={"step": float(step)},
                    infer_shape=False)
    return counter


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice")
    out = _out(helper, input.dtype)
    helper.append_op("strided_slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "strides": list(strides)})
    return _var(helper, out)


def scatter_nd_add(ref, index, updates, name=None):
    helper = LayerHelper("scatter_nd_add", name=name)
    out = _out(helper, ref.dtype)
    helper.append_op("scatter_nd_add",
                     inputs={"X": [ref], "Index": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return _var(helper, out)


def scatter_nd(index, updates, shape, name=None):
    """Reference nn.py:scatter_nd = scatter_nd_add into zeros."""
    from .tensor import fill_constant
    zeros = fill_constant(list(shape), updates.dtype, 0.0)
    return scatter_nd_add(zeros, index, updates, name=name)


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("expand_as",
                     inputs={"X": [x], "target_tensor": [target_tensor]},
                     outputs={"Out": [out]})
    return _var(helper, out)
