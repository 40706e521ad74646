"""The extended surface (the port's copy of ``paddle_tpu/layers/extras.py``:
losses, vision rearranges, the sampled and hierarchical output layers, CTC
and the CRF, the fused RNN layers, the 3-D conv and pool family, the stateful
normalisations, ``py_func``, ``tree_conv`` and the tensor utilities;
reference: python/paddle/fluid/layers/nn.py nce:7486, hsigmoid:7715,
warpctc:7294, linear_chain_crf:1589, crf_decoding:1650, dynamic_lstm:466,
dynamic_gru:868, lstm:652).

Sequences are padded [B, T, ...] tensors plus a ``length`` [B]. A reverse
layer reverses each row's first ``length`` steps, runs the forward
recurrence and reverses back; a row's steps past its length are zeroed.
"""
from __future__ import annotations

from ..framework import convert_dtype, default_main_program
from ..layer_helper import LayerHelper
from .nn import _out, _var
from .tensor import _append_sum


def _int_tuple(v, n):
    """int-or-sequence -> list of n ints (the conv / pool size normaliser)."""
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


def _simple(op_type, x, name=None, out_slot="Out", **attrs):
    """One X input, one output in X's dtype, the attrs that are not None."""
    helper = LayerHelper(op_type, name=name)
    out = _out(helper, x.dtype)
    helper.append_op(op_type, inputs={"X": [x]}, outputs={out_slot: [out]},
                     attrs={k: v for k, v in attrs.items() if v is not None})
    return _var(helper, out)


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


def host_embedding(input, size, name, optimizer="adagrad", learning_rate=0.05,
                   dtype="float32", initializer=None, mmap_dir=None,
                   async_updates=False, seed=0, row_shard_axis=None):
    """Embedding lookup against a host-RAM (or memmapped) table, the path
    for tables that outgrow the card (reference: the distributed lookup
    table, transpiler/distribute_transpiler.py:1594).

    The table is not a Program parameter: it lives on the host
    (``ops/host_table.py``) and is updated there on each gradient push with
    its own ``optimizer`` ('sgd' | 'adagrad') at ``learning_rate``. The
    Program carries a [1]-float anchor parameter that hangs the push op in
    the backward pass. ``name`` is required and process-global: it keys the
    table for ``host_table.save_all`` and re-use across programs.
    ``row_shard_axis`` (a table partitioned across processes) raises: it
    comes with the distributed stack (ROADMAP item 13).
    """
    from ..initializer import Constant
    from ..layer_helper import ParamAttr
    from ..ops import host_table as ht

    if row_shard_axis is not None:
        raise NotImplementedError(
            "host_embedding(row_shard_axis=...) partitions the table across processes, "
            "which comes with the distributed stack (ROADMAP item 13)")
    ht.create_table(name, size[0], size[1], optimizer=optimizer, lr=learning_rate,
                    initializer=initializer, mmap_dir=mmap_dir,
                    async_updates=async_updates, seed=seed)
    helper = LayerHelper("host_embedding", name=name + ".anchor")
    anchor = helper.create_parameter(
        ParamAttr(name=name + ".anchor", initializer=Constant(0.0)), [1], "float32")
    out = _out(helper, dtype)
    helper.append_op("host_lookup_table",
                     inputs={"Ids": [input], "Anchor": [anchor]},
                     outputs={"Out": [out]},
                     attrs={"table_name": name, "dtype": dtype, "shard_axis": None})
    return _var(helper, out)


def space_to_depth(x, blocksize, name=None):
    """NCHW [B, C, H, W] -> [B, C blocksize^2, H / blocksize, W / blocksize]."""
    helper = LayerHelper("space_to_depth", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("space_to_depth", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"blocksize": blocksize})
    return _var(helper, out)


def fsp_matrix(x, y):
    """The [B, C1, C2] flow-of-solution-procedure matrix of two NCHW maps."""
    helper = LayerHelper("fsp")
    out = _out(helper, x.dtype)
    helper.append_op("fsp", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]})
    return _var(helper, out)


# -- vision / tensor rearranges ---------------------------------------------------------

def maxout(x, groups, name=None, axis=1):
    return _simple("maxout", x, name=name, groups=groups, axis=axis)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None, data_format="NCHW"):
    return _simple("lrn", input, name=name, n=n, k=k, alpha=alpha, beta=beta)


def pixel_shuffle(x, upscale_factor):
    return _simple("pixel_shuffle", x, upscale_factor=upscale_factor)


def shuffle_channel(x, group, name=None):
    return _simple("shuffle_channel", x, name=name, group=group)


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    return _simple("temporal_shift", x, name=name, seg_num=seg_num, shift_ratio=shift_ratio)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    return _simple("unfold", x, name=name, kernel_sizes=_int_tuple(kernel_sizes, 2),
                   strides=_int_tuple(strides, 2), paddings=_int_tuple(paddings, 2),
                   dilations=_int_tuple(dilations, 2))


def affine_channel(x, scale=None, bias=None, data_layout="NCHW", name=None, act=None):
    helper = LayerHelper("affine_channel", name=name, act=act)
    out = _out(helper, x.dtype)
    helper.append_op("affine_channel", inputs={"X": [x], "Scale": [scale], "Bias": [bias]},
                     outputs={"Out": [out]})
    return helper.append_activation(_var(helper, out))


def bilinear_tensor_product(x, y, size, act=None, name=None, param_attr=None,
                            bias_attr=None):
    """out[b, k] = x[b] W[k] y[b] (+ bias), W [size, M, N]."""
    helper = LayerHelper("bilinear_tensor_product", name=name, act=act,
                         param_attr=param_attr, bias_attr=bias_attr)
    M, N = x.shape[-1], y.shape[-1]
    w = helper.create_parameter(param_attr, [size, M, N], x.dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, [1, size], x.dtype, is_bias=True)]
    out = _out(helper, x.dtype)
    helper.append_op("bilinear_tensor_product", inputs=inputs, outputs={"Out": [out]})
    return helper.append_activation(_var(helper, out))


def add_position_encoding(input, alpha=1.0, beta=1.0, name=None):
    return _simple("add_position_encoding", input, name=name, alpha=alpha, beta=beta)


def multiplex(inputs, index):
    helper = LayerHelper("multiplex")
    out = _out(helper, inputs[0].dtype)
    helper.append_op("multiplex", inputs={"X": list(inputs), "Ids": [index]},
                     outputs={"Out": [out]})
    return _var(helper, out)


def crop_tensor(x, shape=None, offsets=None, name=None):
    """A static ``shape`` window at ``offsets`` (a Variable shape cannot set
    an output shape)."""
    if shape is None:
        raise ValueError("crop_tensor needs a static `shape` list (a Variable shape "
                         "cannot set an output shape)")
    helper = LayerHelper("crop_tensor", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("crop_tensor", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": list(shape),
                            "offsets": list(offsets or [0] * len(x.shape))})
    return _var(helper, out)


crop = crop_tensor   # reference `crop` with a static shape


def pad_constant_like(x, y, pad_value=0.0, name=None):
    helper = LayerHelper("pad_constant_like", name=name)
    out = _out(helper, y.dtype)
    helper.append_op("pad_constant_like", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"pad_value": pad_value})
    return _var(helper, out)


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    f = helper.create_parameter(param_attr, [future_context_size + 1, input.shape[-1]],
                                input.dtype)
    out = _out(helper, input.dtype)
    helper.append_op("row_conv", inputs={"X": [input], "Filter": [f]}, outputs={"Out": [out]})
    return helper.append_activation(_var(helper, out))


def uniform_random_batch_size_like(input, shape, dtype="float32", input_dim_idx=0,
                                   output_dim_idx=0, min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like")
    out = _out(helper, dtype, stop_gradient=True)
    helper.append_op("uniform_random_batch_size_like", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                            "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx,
                            "min": min, "max": max})
    return _var(helper, out)


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0, output_dim_idx=0,
                                    mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like")
    out = _out(helper, dtype, stop_gradient=True)
    helper.append_op("gaussian_random_batch_size_like", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": convert_dtype(dtype),
                            "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx,
                            "mean": mean, "std": std})
    return _var(helper, out)


def selu(x, scale=None, alpha=None, name=None):
    """scale * elu(x, alpha), built from ``elu`` and ``scale`` as in the JAX
    package."""
    from . import nn as _nn
    scale = 1.0507009873554805 if scale is None else scale
    alpha = 1.6732632423543772 if alpha is None else alpha
    return _nn.scale(_nn.elu(x, alpha=alpha), scale)


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou")
    miou = _out(helper, "float32", stop_gradient=True)
    wrong = _out(helper, "int32", stop_gradient=True)
    correct = _out(helper, "int32", stop_gradient=True)
    helper.append_op("mean_iou", inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [miou], "OutWrong": [wrong],
                              "OutCorrect": [correct]},
                     attrs={"num_classes": num_classes})
    return _var(helper, miou), _var(helper, wrong), _var(helper, correct)


# -- ranking / distillation losses ------------------------------------------------------

def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", name=name)
    out = _out(helper, left.dtype)
    helper.append_op("rank_loss", inputs={"Label": [label], "Left": [left], "Right": [right]},
                     outputs={"Out": [out]})
    return _var(helper, out)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", name=name)
    out = _out(helper, left.dtype)
    helper.append_op("margin_rank_loss", inputs={"Label": [label], "X1": [left], "X2": [right]},
                     outputs={"Out": [out]}, attrs={"margin": margin})
    return _var(helper, out)


def bpr_loss(input, label, name=None):
    helper = LayerHelper("bpr_loss", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("bpr_loss", inputs={"X": [input], "Label": [label]}, outputs={"Out": [out]})
    return _var(helper, out)


def kldiv_loss(x, target, reduction="mean", name=None):
    helper = LayerHelper("kldiv_loss", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("kldiv_loss", inputs={"X": [x], "Target": [target]},
                     outputs={"Loss": [out]}, attrs={"reduction": reduction})
    return _var(helper, out)


def dice_loss(input, label, epsilon=1e-5):
    """1 - 2 |X n Y| / (|X| + |Y|) over all but dim 0, averaged."""
    from . import nn as _nn
    from . import tensor as _tensor
    label_f = _tensor.cast(label, input.dtype)
    dims = list(range(1, len(input.shape)))
    inter = _nn.reduce_sum(_nn.elementwise_mul(input, label_f), dim=dims)
    union = _nn.elementwise_add(_nn.reduce_sum(input, dim=dims),
                                _nn.reduce_sum(label_f, dim=dims))
    num = _nn.scale(inter, 2.0, bias=float(epsilon))
    den = _nn.scale(union, 1.0, bias=float(epsilon))
    return _nn.reduce_mean(_nn.scale(_nn.elementwise_div(num, den), -1.0, bias=1.0))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Cross-entropy over the anchor-positive similarity logits against the
    label-equality targets, plus an l2 term on the embeddings."""
    from . import nn as _nn
    from . import tensor as _tensor
    from .control_flow import equal
    l2 = _nn.scale(_nn.elementwise_add(_nn.reduce_sum(_nn.square(anchor)),
                                       _nn.reduce_sum(_nn.square(positive))),
                   float(l2_reg) / 4.0)
    sim = _nn.matmul(anchor, positive, transpose_y=True)
    lab = _nn.reshape(_tensor.cast(labels, "float32"), [-1, 1])
    tgt = _tensor.cast(equal(lab, _nn.transpose(lab, [1, 0])), "float32")
    tgt = _nn.elementwise_div(tgt, _nn.reduce_sum(tgt, dim=[1], keep_dim=True))
    ce = _nn.reduce_mean(_nn.reduce_sum(
        _nn.elementwise_mul(_nn.scale(_nn.log_softmax(sim), -1.0), tgt), dim=[1]))
    return _nn.elementwise_add(ce, l2)


def sampled_softmax_with_cross_entropy(logits, label, num_samples, **kw):
    """A full softmax cross-entropy, as in the JAX package (which samples
    nothing)."""
    from . import nn as _nn
    return _nn.softmax_with_cross_entropy(logits, label)


# -- sampled / hierarchical output layers ----------------------------------------------

def nce(input, label, num_total_classes, sample_weight=None, param_attr=None, bias_attr=None,
        num_neg_samples=10, name=None, sampler="uniform", custom_dist=None, seed=0,
        is_sparse=False):
    """Reference nn.py:7486: negatives drawn uniformly in the graph. Other
    samplers raise, as in the JAX package."""
    if sampler != "uniform" or custom_dist is not None:
        raise NotImplementedError(
            "nce supports the uniform sampler; custom_dist needs host-side alias tables "
            "(use the full softmax_with_cross_entropy)")
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr, name=name)
    w = helper.create_parameter(param_attr, [num_total_classes, input.shape[-1]], input.dtype)
    inputs = {"Input": [input], "Label": [label], "Weight": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, [num_total_classes], input.dtype,
                                                  is_bias=True)]
    cost = _out(helper, input.dtype)
    helper.append_op("nce", inputs=inputs, outputs={"Cost": [cost]},
                     attrs={"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg_samples})
    return _var(helper, cost)


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None, name=None,
             path_table=None, path_code=None, is_custom=False, is_sparse=False):
    """Reference nn.py:7715 over the complete binary tree; custom path
    tables raise, as in the JAX package."""
    if is_custom or path_table is not None or path_code is not None:
        raise NotImplementedError(
            "hsigmoid uses the complete binary tree; custom path tables would need ragged "
            "gathers (match via relabeling classes)")
    from ..ops.sampled_ops import hsigmoid_num_nodes
    helper = LayerHelper("hsigmoid", param_attr=param_attr, bias_attr=bias_attr, name=name)
    n_nodes = hsigmoid_num_nodes(num_classes)
    w = helper.create_parameter(param_attr, [n_nodes, input.shape[-1]], input.dtype)
    inputs = {"Input": [input], "Label": [label], "W": [w]}
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, [n_nodes, 1], input.dtype,
                                                  is_bias=True)]
    cost = _out(helper, input.dtype)
    pre = _out(helper, input.dtype)
    helper.append_op("hsigmoid", inputs=inputs, outputs={"Cost": [cost], "PreOut": [pre]},
                     attrs={"num_classes": num_classes})
    return _var(helper, cost)


# -- CTC and the evaluator --------------------------------------------------------------

def warpctc(input, label, blank=0, norm_by_times=False, input_length=None, label_length=None):
    """Reference nn.py:7294: input [B, T, C] logits, label [B, L] padded,
    with the length tensors in place of LoD. Loss [B, 1]."""
    if input_length is None or label_length is None:
        raise ValueError("warpctc needs input_length and label_length tensors (padded + "
                         "lengths replaces LoD)")
    helper = LayerHelper("warpctc")
    loss = _out(helper, input.dtype)
    helper.append_op("warpctc",
                     inputs={"Logits": [input], "Label": [label],
                             "LogitsLength": [input_length], "LabelLength": [label_length]},
                     outputs={"Loss": [loss]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    return _var(helper, loss)


def ctc_greedy_decoder(input, blank, input_length=None, padding_value=0, name=None):
    """The greedy CTC decode (``ctc_align``): (decoded [B, T] int32, padded
    with ``padding_value``; their lengths [B] int64)."""
    helper = LayerHelper("ctc_greedy_decoder", name=name)
    out = _out(helper, "int32", stop_gradient=True)
    out_len = _out(helper, "int64", stop_gradient=True)
    if input_length is None:
        raise ValueError("ctc_greedy_decoder needs input_length (padded + lengths replaces "
                         "LoD)")
    helper.append_op("ctc_align", inputs={"Input": [input], "InputLength": [input_length]},
                     outputs={"Output": [out], "OutputLength": [out_len]},
                     attrs={"blank": blank, "padding_value": padding_value})
    return _var(helper, out), _var(helper, out_len)


def edit_distance(input, label, normalized=True, ignored_tokens=None, input_length=None,
                  label_length=None):
    """Reference nn.py:edit_distance: (distance [B, 1], sequence_num [1])."""
    if input_length is None or label_length is None:
        raise ValueError("edit_distance needs input_length and label_length (padded + "
                         "lengths replaces LoD)")
    helper = LayerHelper("edit_distance")
    out = _out(helper, "float32", stop_gradient=True)
    seq_num = _out(helper, "int64", stop_gradient=True)
    helper.append_op("edit_distance",
                     inputs={"Hyps": [input], "Refs": [label], "HypsLength": [input_length],
                             "RefsLength": [label_length]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return _var(helper, out), _var(helper, seq_num)


# -- sampling / beam utilities ----------------------------------------------------------

def sampling_id(x, min=0.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("sampling_id")
    out = _out(helper, "int64", stop_gradient=True)
    helper.append_op("sampling_id", inputs={"X": [x]}, outputs={"Out": [out]})
    return _var(helper, out)


def gather_tree(ids, parents):
    helper = LayerHelper("gather_tree")
    out = _out(helper, ids.dtype, stop_gradient=True)
    helper.append_op("gather_tree", inputs={"Ids": [ids], "Parents": [parents]},
                     outputs={"Out": [out]})
    return _var(helper, out)


def size(input):
    """The element count of a static shape, an int64 [1] constant."""
    from .tensor import fill_constant
    n = 1
    for s in input.shape:
        if s == -1:
            raise ValueError("size() needs a static shape; dynamic dims are only the batch -- "
                             "use shape(input)")
        n *= int(s)
    return fill_constant([1], "int64", n)


def dynamic_lstmp(input, size, proj_size, **kw):
    """Reference nn.py:dynamic_lstmp: the LSTM, then an output projection."""
    from . import nn as _nn
    h, c = dynamic_lstm(input, size, **kw)
    return _nn.fc(h, proj_size, num_flatten_dims=2), c


def lstm(input, init_h, init_c, max_len, hidden_size, num_layers, dropout_prob=0.0,
         is_bidirec=False, is_test=False, name=None, default_initializer=None, seed=-1):
    """Reference nn.py:652 (the cuDNN LSTM): stacked, optionally
    bidirectional ``simple_lstm`` layers. init_h / init_c [num_layers *
    dirs, B, H] or None (zeros). Returns (out [B, T, H * dirs], last_h,
    last_c), the last two [num_layers * dirs, B, H]."""
    from . import nn as _nn
    from .rnn import simple_lstm
    from .tensor import concat

    def layer_init(v, idx):
        if v is None:
            return None
        return _nn.squeeze(_nn.slice(v, axes=[0], starts=[idx], ends=[idx + 1]), axes=[0])

    def last_step(seq, t):
        return _nn.squeeze(_nn.slice(seq, axes=[1], starts=[t], ends=[t + 1]), axes=[1])

    T = int(input.shape[1])
    x = input
    lasts_h, lasts_c = [], []
    for layer in range(num_layers):
        if is_bidirec:
            hf, cf = simple_lstm(x, hidden_size, h0=layer_init(init_h, 2 * layer),
                                 c0=layer_init(init_c, 2 * layer), return_cell=True)
            xr = _seq_reverse(x, None)
            hbr, cbr = simple_lstm(xr, hidden_size, h0=layer_init(init_h, 2 * layer + 1),
                                   c0=layer_init(init_c, 2 * layer + 1), return_cell=True)
            lasts_h += [last_step(hf, T - 1), last_step(hbr, T - 1)]
            lasts_c += [last_step(cf, T - 1), last_step(cbr, T - 1)]
            x = concat([hf, _seq_reverse(hbr, None)], axis=2)
        else:
            h, c = simple_lstm(x, hidden_size, h0=layer_init(init_h, layer),
                               c0=layer_init(init_c, layer), return_cell=True)
            lasts_h.append(last_step(h, T - 1))
            lasts_c.append(last_step(c, T - 1))
            x = h
        if dropout_prob and not is_test:
            x = _nn.dropout(x, dropout_prob)
    return x, _nn.stack(lasts_h, axis=0), _nn.stack(lasts_c, axis=0)


def im2sequence(input, filter_size=1, stride=1, padding=0, input_image_size=None,
                out_stride=1, name=None):
    """Each filter_size window (stride ``stride``, no padding) of an NCHW map
    as one step: [N, OH * OW, C * kh * kw]."""
    helper = LayerHelper("im2sequence", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("im2sequence", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"kernels": _int_tuple(filter_size, 2),
                            "strides": _int_tuple(stride, 2)})
    return _var(helper, out)


def hash(input, hash_size, num_hash=1, name=None):
    helper = LayerHelper("hash", name=name)
    out = _out(helper, "int64", stop_gradient=True)
    helper.append_op("hash", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"num_hash": num_hash, "mod_by": hash_size})
    return _var(helper, out)


def lod_reset(x, y=None, target_lod=None):
    """The identity: lengths are explicit tensors, so the data is unchanged;
    carry your lengths."""
    return x


def lod_append(x, level):
    """The identity, as ``lod_reset``."""
    return x


def get_tensor_from_selected_rows(x, name=None):
    raise NotImplementedError(
        "SelectedRows does not exist here: sparse gradients are dense scatter-adds; use "
        "the tensor directly")


def merge_selected_rows(x, name=None):
    raise NotImplementedError(
        "SelectedRows does not exist here: sparse gradients are dense scatter-adds; use "
        "the tensor directly")


def continuous_value_model(input, cvm, use_cvm=True):
    """Reference nn.py:continuous_value_model (the CTR show / click
    columns): the input as it is, or without its first two columns."""
    from . import nn as _nn
    if use_cvm:
        return input
    return _nn.slice(input, axes=[1], starts=[2], ends=[int(input.shape[1])])


#: key -> the Python callable of a ``py_func`` op (process-local, as the
#: reference keeps its callables)
_PYFUNC_TABLE = {}


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Reference nn.py:py_func: ``func`` runs on the host on the inputs'
    values at each run (a program holding it is not captured as a CUDA
    graph). ``backward_func`` raises, as in the JAX package."""
    if backward_func is not None:
        raise NotImplementedError(
            "py_func backward_func: a host callback is opaque to autograd; express the "
            "backward as ops")
    key = len(_PYFUNC_TABLE)
    _PYFUNC_TABLE[key] = func
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    helper.append_op("py_func", inputs={"X": list(xs)}, outputs={"Out": list(outs)},
                     attrs={"func_key": key, "out_shapes": [list(o.shape) for o in outs],
                            "out_dtypes": [o.dtype for o in outs]},
                     infer_shape=False)
    blk = default_main_program().current_block()
    res = [blk.var(o.name) for o in outs]
    return res if isinstance(out, (list, tuple)) else res[0]


# -- 3D conv / pool family --------------------------------------------------------------

def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1, groups=1,
           param_attr=None, bias_attr=None, use_cudnn=True, act=None, name=None,
           data_format="NCDHW"):
    helper = LayerHelper("conv3d", param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    groups = groups or 1
    w = helper.create_parameter(param_attr, [num_filters, input.shape[1] // groups]
                                + _int_tuple(filter_size, 3), input.dtype)
    out = _out(helper, input.dtype)
    helper.append_op("conv3d", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _int_tuple(stride, 3), "paddings": _int_tuple(padding, 3),
                            "dilations": _int_tuple(dilation, 3), "groups": groups})
    pre = _var(helper, out)
    if bias_attr is not False:
        pre = helper.append_bias_op(pre, dim_start=1, bias_attr=bias_attr)
    return helper.append_activation(pre)


def conv3d_transpose(input, num_filters, output_size=None, filter_size=None, padding=0,
                     stride=1, dilation=1, groups=1, param_attr=None, bias_attr=None,
                     use_cudnn=True, act=None, name=None):
    helper = LayerHelper("conv3d_transpose", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    w = helper.create_parameter(param_attr, [input.shape[1], num_filters // (groups or 1)]
                                + _int_tuple(filter_size, 3), input.dtype)
    out = _out(helper, input.dtype)
    helper.append_op("conv3d_transpose", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": _int_tuple(stride, 3), "paddings": _int_tuple(padding, 3),
                            "dilations": _int_tuple(dilation, 3), "groups": groups or 1})
    pre = _var(helper, out)
    if bias_attr is not False:
        pre = helper.append_bias_op(pre, dim_start=1, bias_attr=bias_attr)
    return helper.append_activation(pre)


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None, exclusive=True,
           adaptive=False):
    helper = LayerHelper("pool3d", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("pool3d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": _int_tuple(pool_size, 3),
                            "strides": _int_tuple(pool_stride, 3),
                            "paddings": _int_tuple(pool_padding, 3),
                            "global_pooling": global_pooling, "exclusive": exclusive,
                            "adaptive": adaptive})
    return _var(helper, out)


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False, name=None):
    return pool3d(input, pool_size, pool_type, adaptive=True, name=name)


def resize_trilinear(input, out_shape=None, scale=None, name=None, actual_shape=None,
                     align_corners=True, align_mode=1):
    helper = LayerHelper("trilinear_interp", name=name)
    out = _out(helper, input.dtype)
    if out_shape is None:
        out_shape = [int(s * scale) for s in input.shape[2:]]
    helper.append_op("trilinear_interp", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"out_d": int(out_shape[0]), "out_h": int(out_shape[1]),
                            "out_w": int(out_shape[2])})
    return _var(helper, out)


def image_resize_short(input, out_short_len, resample="BILINEAR"):
    """Resized so the short side is ``out_short_len``."""
    from . import nn as _nn
    h, w = int(input.shape[2]), int(input.shape[3])
    short = min(h, w)
    return _nn.image_resize(input, out_shape=[h * out_short_len // short,
                                              w * out_short_len // short],
                            resample=resample)


# -- stateful normalisation / losses ----------------------------------------------------

def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """Reference nn.py:spectral_norm: U and V, the power iteration's
    vectors, are persistable state that the op writes back."""
    from ..initializer import Normal
    helper = LayerHelper("spectral_norm", name=name)
    h = int(weight.shape[dim])
    w_size = 1
    for i, s in enumerate(weight.shape):
        if i != dim:
            w_size *= int(s)
    u = helper.create_global_variable([h], weight.dtype, name=None,
                                      initializer=Normal(0.0, 1.0), stop_gradient=True)
    v = helper.create_global_variable([w_size], weight.dtype, name=None,
                                      initializer=Normal(0.0, 1.0), stop_gradient=True)
    out = _out(helper, weight.dtype)
    helper.append_op("spectral_norm", inputs={"Weight": [weight], "U": [u], "V": [v]},
                     outputs={"Out": [out], "UOut": [u], "VOut": [v]},
                     attrs={"dim": dim, "power_iters": power_iters, "eps": eps})
    return _var(helper, out)


def data_norm(input, act=None, epsilon=1e-05, param_attr=None, data_layout="NCHW",
              in_place=False, name=None, moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=False):
    """Reference nn.py:data_norm: normalisation by accumulated statistics
    (CTR models), the accumulators persistable state the op writes back."""
    from ..initializer import Constant
    helper = LayerHelper("data_norm", name=name)
    D = int(input.shape[-1])
    bsize = helper.create_global_variable([D], input.dtype, initializer=Constant(1e4),
                                          stop_gradient=True)
    bsum = helper.create_global_variable([D], input.dtype, initializer=Constant(0.0),
                                         stop_gradient=True)
    bsq = helper.create_global_variable([D], input.dtype, initializer=Constant(1e4),
                                        stop_gradient=True)
    y = _out(helper, input.dtype)
    means = _out(helper, input.dtype, stop_gradient=True)
    scales = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("data_norm",
                     inputs={"X": [input], "BatchSize": [bsize], "BatchSum": [bsum],
                             "BatchSquareSum": [bsq]},
                     outputs={"Y": [y], "Means": [means], "Scales": [scales],
                              "BatchSizeOut": [bsize], "BatchSumOut": [bsum],
                              "BatchSquareSumOut": [bsq]},
                     attrs={"epsilon": epsilon})
    return helper.append_activation(_var(helper, y))


def center_loss(input, label, num_classes, alpha, param_attr=None, update_center=True):
    """Reference nn.py:center_loss: the centers are a persistable [C, D]
    state that the op updates."""
    from ..initializer import Constant
    from .tensor import fill_constant
    helper = LayerHelper("center_loss", param_attr=param_attr)
    D = int(input.shape[-1])
    centers = helper.create_global_variable([num_classes, D], input.dtype,
                                            initializer=Constant(0.0), stop_gradient=True)
    rate = fill_constant([1], "float32", float(alpha))
    loss = _out(helper, input.dtype)
    diff = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("center_loss",
                     inputs={"X": [input], "Label": [label], "Centers": [centers],
                             "CenterUpdateRate": [rate]},
                     outputs={"Loss": [loss], "SampleCenterDiff": [diff],
                              "CentersOut": [centers]},
                     attrs={"need_update": update_center})
    return _var(helper, loss)


def affine_grid(theta, out_shape, name=None):
    helper = LayerHelper("affine_grid", name=name)
    out = _out(helper, theta.dtype)
    helper.append_op("affine_grid", inputs={"Theta": [theta]}, outputs={"Output": [out]},
                     attrs={"output_shape": [int(s) for s in out_shape]})
    return _var(helper, out)


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("grid_sampler", inputs={"X": [x], "Grid": [grid]},
                     outputs={"Output": [out]})
    return _var(helper, out)


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop")
    out = _out(helper, x.dtype)
    helper.append_op("random_crop", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape]})
    return _var(helper, out)


def _unique_op(layer, x, dtype):
    helper = LayerHelper(layer)
    out = _out(helper, x.dtype, stop_gradient=True)
    index = _out(helper, dtype, stop_gradient=True)
    count = _out(helper, "int32", stop_gradient=True)
    ucount = _out(helper, "int32", stop_gradient=True)
    helper.append_op("unique_with_counts", inputs={"X": [x]},
                     outputs={"Out": [out], "Index": [index], "Count": [count],
                              "UniqueCount": [ucount]})
    return _var(helper, out), _var(helper, index), _var(helper, count)


def unique(x, dtype="int32"):
    """(the unique values padded to len(x), the index of each element)."""
    return _unique_op("unique", x, dtype)[:2]


def unique_with_counts(x, dtype="int32"):
    return _unique_op("unique_with_counts", x, dtype)


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0):
    helper = LayerHelper("teacher_student_sigmoid_loss")
    out = _out(helper, input.dtype)
    helper.append_op("teacher_student_sigmoid_loss", inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_max_up_bound": soft_max_up_bound,
                            "soft_max_lower_bound": soft_max_lower_bound})
    return _var(helper, out)


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1, max_depth=2, act="tanh",
              param_attr=None, bias_attr=None, name=None):
    """Reference nn.py:tree_conv (TBCNN): nodes [B, N, F] (or [N, F]), edges
    [B, E, 2] 1-indexed parent -> child ((0, 0) pads). [B, N, output_size,
    num_filters]."""
    helper = LayerHelper("tree_conv", param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    F = int(nodes_vector.shape[-1])
    filt = helper.create_parameter(param_attr, [F, 3, int(output_size), int(num_filters)],
                                   nodes_vector.dtype)
    out = _out(helper, nodes_vector.dtype)
    helper.append_op("tree_conv",
                     inputs={"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                             "Filter": [filt]},
                     outputs={"Out": [out]}, attrs={"max_depth": int(max_depth)})
    pre = _var(helper, out)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [int(num_filters)], nodes_vector.dtype,
                                    is_bias=True)
        out2 = _out(helper, nodes_vector.dtype)
        helper.append_op("elementwise_add", inputs={"X": [pre], "Y": [b]},
                         outputs={"Out": [out2]}, attrs={"axis": -1})
        pre = _var(helper, out2)
    return helper.append_activation(pre)
