"""Core NN layers DSL (the port's copy of ``paddle_tpu/layers/nn.py``: every
function but the vision layers ``adaptive_pool2d``, ``conv2d_transpose``,
``deformable_conv``, ``group_norm``, ``image_resize``, ``instance_norm``,
``prelu``, ``resize_bilinear``, ``resize_nearest`` and ``chunk_eval``,
``sequence_mask``, ``similarity_focus``, which are not ported yet).

Each function builds ops into the default main program and parameters into
the default startup program, with the same op types, slots, attrs and names
as the JAX package's DSL, so both build the same Program.
"""
from __future__ import annotations

import numpy as np

from ..framework import convert_dtype
from ..layer_helper import LayerHelper


def _out(helper, dtype="float32", stop_gradient=False):
    return helper.create_variable_for_type_inference(dtype, stop_gradient)


def _var(helper, v):
    return helper.main_program.current_block().var(v.name)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """y = act(x @ W + b), x flattened to 2D at ``num_flatten_dims``."""
    helper = LayerHelper("fc", param_attr=param_attr, bias_attr=bias_attr, act=act,
                         name=name)
    tail = tuple(input.shape[num_flatten_dims:])
    if any(d < 0 for d in tail):
        raise ValueError(
            f"fc: input {input.name} has a dynamic dim in the flattened tail "
            f"{tail} (num_flatten_dims={num_flatten_dims}); only dims before "
            f"num_flatten_dims may be -1")
    w = helper.create_parameter(param_attr, [int(np.prod(tail)), size], input.dtype)
    out = _out(helper, input.dtype)
    helper.append_op("mul", inputs={"X": [input], "Y": [w]}, outputs={"Out": [out]},
                     attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    pre_act = helper.append_bias_op(_var(helper, out), dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, list(size), dtype)
    out = _out(helper, dtype)
    helper.append_op("lookup_table_v2", inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": -1 if padding_idx is None else padding_idx,
                            "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return _var(helper, out)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True, act=None,
           name=None, data_format="NCHW"):
    """2-D convolution; the Filter parameter is [O, I/groups, kh, kw] in both
    layouts (``use_cudnn`` is accepted and ignored)."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    c_in = input.shape[1] if data_format == "NCHW" else input.shape[-1]
    fh, fw = (filter_size if isinstance(filter_size, (list, tuple))
              else (filter_size, filter_size))
    groups = groups or 1
    w = helper.create_parameter(param_attr, [num_filters, c_in // groups, fh, fw],
                                input.dtype)
    out = _out(helper, input.dtype)
    pair = lambda v: list(v) if isinstance(v, (list, tuple)) else [v, v]
    helper.append_op("conv2d", inputs={"Input": [input], "Filter": [w]},
                     outputs={"Output": [out]},
                     attrs={"strides": pair(stride), "paddings": pair(padding),
                            "dilations": pair(dilation), "groups": groups,
                            "data_format": data_format})
    pre_act = _var(helper, out)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype, is_bias=True)
        out2 = _out(helper, input.dtype)
        helper.append_op("elementwise_add", inputs={"X": [pre_act], "Y": [b]},
                         outputs={"Out": [out2]},
                         attrs={"axis": 1 if data_format == "NCHW" else -1})
        pre_act = _var(helper, out2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           exclusive=True, adaptive=False, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = _out(helper, input.dtype)
    pair = lambda v: [v, v] if isinstance(v, int) else list(v)
    helper.append_op("pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": pair(pool_size),
                            "strides": pair(pool_stride), "paddings": pair(pool_padding),
                            "global_pooling": global_pooling, "exclusive": exclusive,
                            "adaptive": adaptive, "data_format": data_format})
    return _var(helper, out)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False,
               use_global_stats=False, fuse_stats=False):
    """Batch normalization. ``fuse_stats=True`` marks the op for
    ``contrib.fuse_conv_bn_stats``, which folds a 1x1/s1 NHWC conv in front
    of it into ``conv2d_bn_fused`` (the CUDA 1x1-conv + statistics kernel on
    the card)."""
    from ..initializer import Constant
    helper = LayerHelper("batch_norm", act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype if input.dtype != "float16" else "float32"
    scale = helper.create_parameter(param_attr, [c], dtype,
                                    default_initializer=Constant(1.0))
    bias = helper.create_parameter(bias_attr, [c], dtype, is_bias=True)
    mean = helper.create_global_variable([c], "float32", persistable=True,
                                         name=moving_mean_name, initializer=Constant(0.0))
    variance = helper.create_global_variable([c], "float32", persistable=True,
                                             name=moving_variance_name,
                                             initializer=Constant(1.0))
    y = _out(helper, input.dtype)
    saved_mean = _out(helper, "float32", stop_gradient=True)
    saved_var = _out(helper, "float32", stop_gradient=True)
    helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias], "Mean": [mean],
                "Variance": [variance]},
        outputs={"Y": [y], "MeanOut": [mean], "VarianceOut": [variance],
                 "SavedMean": [saved_mean], "SavedVariance": [saved_var]},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout, "use_global_stats": use_global_stats,
               "fuse_stats": fuse_stats})
    return helper.append_activation(_var(helper, y))


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    from ..initializer import Constant
    helper = LayerHelper("layer_norm", act=act, name=name)
    nshape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(param_attr, nshape, input.dtype,
                                                   default_initializer=Constant(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(bias_attr, nshape, input.dtype,
                                                  is_bias=True)]
    y = _out(helper, input.dtype)
    mean = _out(helper, "float32", stop_gradient=True)
    var = _out(helper, "float32", stop_gradient=True)
    helper.append_op("layer_norm", inputs=inputs,
                     outputs={"Y": [y], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(_var(helper, y))


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = _out(helper, x.dtype)
    mask = _out(helper, x.dtype, stop_gradient=True)
    helper.append_op("dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed if seed is not None else 0,
                            "dropout_implementation": dropout_implementation})
    return _var(helper, out)


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = _out(helper, x.dtype)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                         outputs={"Out": [out]}, attrs={"axis": axis})
        return helper.append_activation(_var(helper, out))
    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_max = _elementwise("elementwise_max")
elementwise_min = _elementwise("elementwise_min")
elementwise_pow = _elementwise("elementwise_pow")
elementwise_mod = _elementwise("elementwise_mod")
elementwise_floordiv = _elementwise("elementwise_floordiv")


def _reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = _out(helper, input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            attrs = {"dim": dim if isinstance(dim, (list, tuple)) else [dim],
                     "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(op_type, inputs={"X": [input]}, outputs={"Out": [out]},
                         attrs=attrs)
        return _var(helper, out)
    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")
reduce_all = _reduce("reduce_all")
reduce_any = _reduce("reduce_any")


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = _out(helper, "float32")
    helper.append_op("one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"depth": depth})
    return _var(helper, out)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    out = _out(helper, dtype)
    helper.append_op("label_smooth", inputs=inputs, outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return _var(helper, out)


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("log_softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return _var(helper, out)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("squeeze2", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axes": list(axes)})
    return _var(helper, out)


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("expand", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"expand_times": list(expand_times)})
    return _var(helper, out)


def _unary(op_type):
    def layer(x, name=None, **kw):
        helper = LayerHelper(op_type, name=name)
        out = _out(helper, x.dtype)
        helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                         attrs={k: v for k, v in kw.items() if v is not None})
        return _var(helper, out)
    layer.__name__ = op_type
    return layer


sigmoid = _unary("sigmoid")
tanh = _unary("tanh")
square = _unary("square")
sqrt = _unary("sqrt")
logsigmoid = _unary("logsigmoid")
tanh_shrink = _unary("tanh_shrink")
exp = _unary("exp")
log = _unary("log")
rsqrt = _unary("rsqrt")
abs = _unary("abs")
reciprocal = _unary("reciprocal")
softplus = _unary("softplus")
softsign = _unary("softsign")
ceil = _unary("ceil")
floor = _unary("floor")
round = _unary("round")
sign = _unary("sign")
erf = _unary("erf")
cos = _unary("cos")
sin = _unary("sin")
acos = _unary("acos")
asin = _unary("asin")
atan = _unary("atan")
cosh = _unary("cosh")
sinh = _unary("sinh")
mish = _unary("mish")
hard_swish = _unary("hard_swish")
hard_sigmoid = _unary("hard_sigmoid")
relu6 = _unary("relu6")
soft_relu = _unary("soft_relu")
stanh = _unary("stanh")
hard_shrink = _unary("hard_shrink")
softshrink = _unary("softshrink")
thresholded_relu = _unary("thresholded_relu")
brelu = _unary("brelu")


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return _var(helper, out)


def gelu(x, name=None, approximate=None):
    helper = LayerHelper("gelu", name=name)
    out = _out(helper, x.dtype)
    attrs = {} if approximate is None else {"approximate": approximate}
    helper.append_op("gelu", inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs)
    return _var(helper, out)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = _out(helper, x.dtype)
    helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(_var(helper, out))


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return _var(helper, out)


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("clip_by_norm", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return _var(helper, out)


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", act=act, name=name)
    out = _out(helper, x.dtype)
    helper.append_op("reshape2", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(_var(helper, out))


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("transpose2", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": list(perm)})
    return _var(helper, out)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("unsqueeze2", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axes": list(axes)})
    return _var(helper, out)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    axis = dim % len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "sections": [], "axis": axis}
    else:
        n = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": axis}
    outs = [_out(helper, input.dtype) for _ in range(n)]
    helper.append_op("split", inputs={"X": [input]}, outputs={"Out": outs}, attrs=attrs)
    blk = helper.main_program.current_block()
    return [blk.var(o.name) for o in outs]


def cast(x, dtype):
    from .tensor import cast as _cast
    return _cast(x, dtype)


def fused_attention(q, k, v, bias=None, scale=None, dropout_prob=0.0,
                    causal=False, is_test=False, impl="auto", name=None):
    """Fused scaled-dot-product attention over head-split tensors.

    q/k/v: [B, heads, S, D]; bias: optional [B, 1, 1, S] additive mask. On a
    CUDA device it lowers to the port's flash-attention kernel
    (ops/flash_attention.py); on the CPU to its plain version.
    """
    helper = LayerHelper("fused_attention", name=name)
    out = _out(helper, q.dtype)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if bias is not None:
        inputs["Bias"] = [bias]
    helper.append_op("fused_attention", inputs=inputs, outputs={"Out": [out]},
                     attrs={"scale": float(scale) if scale else 0.0,
                            "dropout_prob": float(dropout_prob),
                            "causal": bool(causal), "is_test": bool(is_test),
                            "impl": impl})
    return _var(helper, out)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return _var(helper, out)


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("softmax", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return _var(helper, out)


def softmax_with_cross_entropy(logits, label, soft_label=False, ignore_index=-100,
                               numeric_stable_mode=True, return_softmax=False,
                               axis=-1):
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = _out(helper, logits.dtype)
    loss = _out(helper, logits.dtype)
    helper.append_op("softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index,
                            "axis": axis})
    if return_softmax:
        return _var(helper, loss), _var(helper, softmax_out)
    return _var(helper, loss)


def cross_entropy(input, label, soft_label=False, ignore_index=-100):
    helper = LayerHelper("cross_entropy")
    out = _out(helper, input.dtype)
    helper.append_op("cross_entropy", inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index})
    return _var(helper, out)


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]}, outputs={"Out": [out]},
                     attrs={"ignore_index": ignore_index, "normalize": normalize})
    return _var(helper, out)


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost")
    out = _out(helper, input.dtype)
    helper.append_op("square_error_cost",
                     inputs={"X": [input], "Y": [label]}, outputs={"Out": [out]})
    return _var(helper, out)


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = _out(helper, X.dtype)
    xn = _out(helper, X.dtype, stop_gradient=True)
    yn = _out(helper, X.dtype, stop_gradient=True)
    helper.append_op("cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xn], "YNorm": [yn]})
    return _var(helper, out)


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return _var(helper, out)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = _out(helper, input.dtype)
    helper.append_op("slice", inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return _var(helper, out)


def gather(input, index, overwrite=True, axis=0):
    helper = LayerHelper("gather")
    out = _out(helper, input.dtype)
    helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]}, attrs={"axis": int(axis)})
    return _var(helper, out)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = _out(helper, input.dtype)
    indices = _out(helper, "int64", stop_gradient=True)
    helper.append_op("top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    blk = helper.main_program.current_block()
    return blk.var(values.name), blk.var(indices.name)


def accuracy(input, label, k=1, correct=None, total=None):
    """topk + the accuracy op."""
    helper = LayerHelper("accuracy")
    _, indices = topk(input, k)
    acc = _out(helper, "float32", stop_gradient=True)
    correct = correct or _out(helper, "int32", stop_gradient=True)
    total = total or _out(helper, "int32", stop_gradient=True)
    helper.append_op("accuracy",
                     inputs={"Indices": [indices], "Label": [label]},
                     outputs={"Accuracy": [acc], "Correct": [correct],
                              "Total": [total]})
    return _var(helper, acc)


def auc(input, label, curve="ROC", num_thresholds=4095, topk=1, slide_steps=1):
    """The streaming AUC of ``input`` ([N, 2] probabilities of the negative
    and the positive class) against ``label``, over two persistable
    histograms of ``num_thresholds + 1`` buckets. Returns (auc, None,
    [stat_pos, stat_neg])."""
    from ..initializer import Constant
    helper = LayerHelper("auc")
    stat_pos = helper.create_global_variable([num_thresholds + 1], "float32",
                                             initializer=Constant(0.0))
    stat_neg = helper.create_global_variable([num_thresholds + 1], "float32",
                                             initializer=Constant(0.0))
    auc_out = _out(helper, "float64", stop_gradient=True)
    helper.append_op("auc",
                     inputs={"Predict": [input], "Label": [label],
                             "StatPos": [stat_pos], "StatNeg": [stat_neg]},
                     outputs={"AUC": [auc_out], "StatPosOut": [stat_pos],
                              "StatNegOut": [stat_neg]},
                     attrs={"num_thresholds": num_thresholds})
    return _var(helper, auc_out), None, [stat_pos, stat_neg]


# -- beam search over dense [B, K] beams (ops/beam_ops.py) ------------------------------

def beam_search(pre_ids, pre_scores, scores, finished, beam_size, end_id,
                name=None):
    """One beam step over [B, K] beams; ``scores`` are the step's log-probs
    [B, K, V] (or [B*K, V]). Returns (selected_ids, selected_scores,
    parent_idx, finished)."""
    helper = LayerHelper("beam_search", name=name)
    sel_ids = _out(helper, "int64", stop_gradient=True)
    sel_scores = _out(helper, scores.dtype, stop_gradient=True)
    parent = _out(helper, "int32", stop_gradient=True)
    fin = _out(helper, "bool", stop_gradient=True)
    helper.append_op("beam_search",
                     inputs={"PreIds": [pre_ids], "PreScores": [pre_scores],
                             "Scores": [scores], "Finished": [finished]},
                     outputs={"SelectedIds": [sel_ids], "SelectedScores": [sel_scores],
                              "ParentIdx": [parent], "FinishedOut": [fin]},
                     attrs={"beam_size": int(beam_size), "end_id": int(end_id)})
    blk = helper.main_program.current_block()
    return (blk.var(sel_ids.name), blk.var(sel_scores.name),
            blk.var(parent.name), blk.var(fin.name))


def beam_append(ids_buf, parent, new_ids, step_idx, name=None):
    """The [B, K, T] token buffer reordered by the parent pointers, with
    ``new_ids`` written at column ``step_idx``."""
    helper = LayerHelper("beam_append", name=name)
    out = _out(helper, ids_buf.dtype, stop_gradient=True)
    helper.append_op("beam_append",
                     inputs={"IdsBuf": [ids_buf], "Parent": [parent],
                             "NewIds": [new_ids], "StepIdx": [step_idx]},
                     outputs={"Out": [out]})
    return _var(helper, out)


def beam_search_decode(ids, parents, scores, beam_size=None, end_id=1, name=None):
    """The per-step selections [B, T, K] backtracked into sentences [B, K,
    T], sorted best-first."""
    helper = LayerHelper("beam_search_decode", name=name)
    sent = _out(helper, "int64", stop_gradient=True)
    sscores = _out(helper, scores.dtype, stop_gradient=True)
    helper.append_op("beam_search_decode",
                     inputs={"Ids": [ids], "Parents": [parents], "Scores": [scores]},
                     outputs={"SentenceIds": [sent], "SentenceScores": [sscores]},
                     attrs={"end_id": int(end_id)})
    blk = helper.main_program.current_block()
    return blk.var(sent.name), blk.var(sscores.name)


# -- the dense op families' layers ---------------------------------------------------

def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("mul", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return _var(helper, out)


def leaky_relu(x, alpha=0.02, name=None):
    helper = LayerHelper("leaky_relu", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("leaky_relu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha})
    return _var(helper, out)


def elu(x, alpha=1.0, name=None):
    helper = LayerHelper("elu", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("elu", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"alpha": alpha})
    return _var(helper, out)


def swish(x, beta=1.0, name=None):
    helper = LayerHelper("swish", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("swish", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"beta": beta})
    return _var(helper, out)


def pow(x, factor=1.0, name=None):
    helper = LayerHelper("pow", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("pow", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"factor": factor})
    return _var(helper, out)


def cross_entropy2(input, label, ignore_index=-100):
    """Reference nn.py:1917 -- hard-label CE variant whose kernel saves the
    matched probability (MatchX) for its grad."""
    helper = LayerHelper("cross_entropy2")
    out = _out(helper, input.dtype)
    match_x = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("cross_entropy2",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out], "MatchX": [match_x]},
                     attrs={"ignore_index": ignore_index})
    return _var(helper, out)


def huber_loss(input, label, delta):
    helper = LayerHelper("huber_loss")
    out = _out(helper, input.dtype)
    residual = _out(helper, input.dtype, stop_gradient=True)
    helper.append_op("huber_loss", inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": delta})
    return _var(helper, out)


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    out = _out(helper, x.dtype)
    diff = _out(helper, x.dtype, stop_gradient=True)
    helper.append_op("smooth_l1_loss", inputs=inputs,
                     outputs={"Out": [out], "Diff": [diff]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return _var(helper, out)


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("log_loss", inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [out]}, attrs={"epsilon": epsilon})
    return _var(helper, out)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("flatten2", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"axis": axis})
    return _var(helper, out)


def stack(x, axis=0):
    helper = LayerHelper("stack")
    xs = x if isinstance(x, (list, tuple)) else [x]
    out = _out(helper, xs[0].dtype)
    helper.append_op("stack", inputs={"X": list(xs)}, outputs={"Y": [out]},
                     attrs={"axis": axis})
    return _var(helper, out)


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    n = num if num is not None else x.shape[axis]
    outs = [_out(helper, x.dtype) for _ in range(n)]
    helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                     attrs={"axis": axis})
    blk = helper.main_program.current_block()
    return [blk.var(o.name) for o in outs]


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("gather_nd", inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return _var(helper, out)


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("scatter",
                     inputs={"X": [input], "Ids": [index], "Updates": [updates]},
                     outputs={"Out": [out]}, attrs={"overwrite": overwrite})
    return _var(helper, out)


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = _out(helper, x.dtype)
    helper.append_op("pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "pad_value": pad_value})
    return _var(helper, out)


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = _out(helper, input.dtype)
    helper.append_op("pad2d", inputs={"X": [input]}, outputs={"Out": [out]},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": pad_value, "data_format": data_format})
    return _var(helper, out)


def shape(input):
    helper = LayerHelper("shape")
    out = _out(helper, "int32", stop_gradient=True)
    helper.append_op("shape", inputs={"Input": [input]}, outputs={"Out": [out]})
    return _var(helper, out)


def where(condition, x=None, y=None):
    helper = LayerHelper("where")
    out = _out(helper, x.dtype)
    helper.append_op("where", inputs={"Condition": [condition], "X": [x],
                                      "Y": [y]}, outputs={"Out": [out]})
    return _var(helper, out)


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = _out(helper, x.dtype)
    norm = _out(helper, x.dtype, stop_gradient=True)
    helper.append_op("l2_normalize", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": axis, "epsilon": epsilon})
    return _var(helper, out)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = _out(helper, dtype, stop_gradient=True)
    helper.append_op("uniform_random", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": convert_dtype(dtype), "min": min,
                            "max": max, "seed": seed})
    return _var(helper, out)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random")
    out = _out(helper, dtype, stop_gradient=True)
    helper.append_op("gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": convert_dtype(dtype), "mean": mean,
                            "std": std, "seed": seed})
    return _var(helper, out)
