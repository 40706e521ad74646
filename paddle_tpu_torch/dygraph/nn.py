"""Dygraph Layer classes (reference: python/paddle/fluid/dygraph/nn.py:
Conv2D:35, Pool2D:759, FC:919, BatchNorm, Embedding, LayerNorm, ...).

The port's copy of ``paddle_tpu/dygraph/nn.py``: the same classes, op types,
attrs and parameter names (from ``unique_name``), so a model built under
``unique_name.guard()`` in either package has the same ``state_dict`` keys.
``_init_array`` is the JAX package's: numpy draws seeded from the shape, so
both packages start a layer from the same values (a bfloat16 parameter is
drawn in float32 and rounded). Parameters live on the guard's device
(``base.guard``). ``state_dict()`` returns numpy arrays, a bfloat16
parameter widened to float32 (exact); ``set_dict`` copies arrays onto each
parameter's device in its dtype.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .. import unique_name
from ..core.executor import tensor_from_numpy
from ..core.registry import torch_dtype
from ..framework import convert_dtype
from .base import VarBase, _device, trace_op, no_grad


def _init_array(shape, dtype, initializer, fan_in=None, seed=0):
    rng = np.random.RandomState(seed + abs(hash(tuple(shape))) % 100000)
    if initializer == "zeros":
        return np.zeros(shape, dtype)
    if initializer == "ones":
        return np.ones(shape, dtype)
    if initializer == "xavier":
        if len(shape) >= 2:
            fin = int(np.prod(shape[1:])) if len(shape) > 2 else shape[0]
            fout = shape[0] if len(shape) > 2 else shape[1]
        else:
            fin = fout = shape[0] if shape else 1
        limit = np.sqrt(6.0 / (fin + fout))
        return rng.uniform(-limit, limit, shape).astype(dtype)
    if initializer == "normal":
        return (rng.randn(*shape) * 0.02).astype(dtype)
    raise ValueError(initializer)


class Layer:
    """Reference dygraph/layers.py Layer."""

    def __init__(self, name_scope=None, dtype="float32"):
        self._dtype = convert_dtype(dtype)
        self._parameters: Dict[str, VarBase] = {}
        self._sub_layers: Dict[str, "Layer"] = {}
        self._full_name = unique_name.generate(
            name_scope or self.__class__.__name__.lower())
        self.training = True

    def full_name(self):
        return self._full_name

    def create_parameter(self, shape, dtype=None, initializer="xavier",
                         is_bias=False, name=None) -> VarBase:
        dtype = convert_dtype(dtype or self._dtype)
        if is_bias and initializer == "xavier":
            initializer = "zeros"
        arr = _init_array(tuple(int(s) for s in shape),
                          "float32" if dtype == "bfloat16" else dtype, initializer)
        p = VarBase(torch.from_numpy(arr).to(device=_device(), dtype=torch_dtype(dtype)),
                    stop_gradient=False,
                    name=name or unique_name.generate(
                        self._full_name + (".b" if is_bias else ".w")))
        key = p.name
        self._parameters[key] = p
        return p

    def __setattr__(self, name, value):
        if isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", {})[name] = value
        object.__setattr__(self, name, value)

    def parameters(self, include_sublayers=True) -> List[VarBase]:
        out = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.parameters())
        return out

    def named_parameters(self, prefix=""):
        for k, p in self._parameters.items():
            yield (prefix + k, p)
        for n, l in self._sub_layers.items():
            yield from l.named_parameters(prefix + n + ".")

    def sublayers(self):
        return list(self._sub_layers.values())

    def train(self):
        self.training = True
        for l in self._sub_layers.values():
            l.train()

    def eval(self):
        self.training = False
        for l in self._sub_layers.values():
            l.eval()

    def state_dict(self):
        return {n: p.numpy() for n, p in self.named_parameters()}

    def set_dict(self, state, use_structured_name=True):
        """Load numpy arrays (or tensors) by name, each onto its parameter's
        device in its dtype. A numpy bfloat16 array (the JAX package's
        ``ml_dtypes`` type) is read bit for bit."""
        named = dict(self.named_parameters())
        for n, v in state.items():
            if n in named:
                p = named[n]
                t = v if isinstance(v, torch.Tensor) else tensor_from_numpy(v)
                p.value = t.detach().to(device=p.value.device, dtype=p.value.dtype,
                                        copy=True)

    load_dict = set_dict

    def __call__(self, *args, **kw):
        return self.forward(*args, **kw)

    def forward(self, *args, **kw):
        raise NotImplementedError


class Linear(Layer):
    """Reference dygraph FC (nn.py:919) / Linear."""

    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter([input_dim, output_dim])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([output_dim], is_bias=True))
        self._act = act

    def forward(self, x):
        out = trace_op("mul", {"X": [x], "Y": [self.weight]},
                       {"x_num_col_dims": len(x.shape) - 1,
                        "y_num_col_dims": 1}, ["Out"])["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": -1}, ["Out"])["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out


FC = Linear


class Conv2D(Layer):
    """Reference dygraph/nn.py:35."""

    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        fh, fw = (filter_size if isinstance(filter_size, (list, tuple))
                  else (filter_size, filter_size))
        self.weight = self.create_parameter(
            [num_filters, num_channels // (groups or 1), fh, fw])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([num_filters], is_bias=True))
        self._attrs = {
            "strides": [stride, stride] if isinstance(stride, int)
            else list(stride),
            "paddings": [padding, padding] if isinstance(padding, int)
            else list(padding),
            "dilations": [dilation, dilation] if isinstance(dilation, int)
            else list(dilation),
            "groups": groups or 1}
        self._act = act

    def forward(self, x):
        out = trace_op("conv2d", {"Input": [x], "Filter": [self.weight]},
                       self._attrs, ["Output"])["Output"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1}, ["Out"])["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out


class Pool2D(Layer):
    """Reference dygraph/nn.py:759."""

    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, dtype="float32"):
        super().__init__(dtype=dtype)
        self._attrs = {
            "pooling_type": pool_type,
            "ksize": [pool_size, pool_size] if isinstance(pool_size, int)
            else list(pool_size),
            "strides": [pool_stride, pool_stride]
            if isinstance(pool_stride, int) else list(pool_stride),
            "paddings": [pool_padding, pool_padding]
            if isinstance(pool_padding, int) else list(pool_padding),
            "global_pooling": global_pooling}

    def forward(self, x):
        return trace_op("pool2d", {"X": [x]}, self._attrs, ["Out"])["Out"][0]


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, padding_idx=None,
                 param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(list(size), initializer="normal")
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, ids):
        return trace_op("lookup_table_v2",
                        {"W": [self.weight], "Ids": [ids]},
                        {"padding_idx": self._padding_idx}, ["Out"])["Out"][0]


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 dtype="float32", data_layout="NCHW"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter([num_channels],
                                            initializer="ones")
        self.bias = self.create_parameter([num_channels], is_bias=True)
        self._mean = VarBase(torch.zeros([num_channels], device=_device()),
                             stop_gradient=True)
        self._variance = VarBase(torch.ones([num_channels], device=_device()),
                                 stop_gradient=True)
        self._attrs = {"momentum": momentum, "epsilon": epsilon,
                       "data_layout": data_layout}
        self._act = act

    def forward(self, x):
        attrs = dict(self._attrs, is_test=not self.training)
        outs = trace_op(
            "batch_norm",
            {"X": [x], "Scale": [self.weight], "Bias": [self.bias],
             "Mean": [self._mean], "Variance": [self._variance]},
            attrs, ["Y", "MeanOut", "VarianceOut"])
        if self.training:
            with no_grad():
                self._mean = outs["MeanOut"][0].detach()
                self._variance = outs["VarianceOut"][0].detach()
        y = outs["Y"][0]
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {}, ["Out"])["Out"][0]
        return y


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, dtype="float32"):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.weight = self.create_parameter(list(normalized_shape),
                                            initializer="ones")
        self.bias = self.create_parameter(list(normalized_shape), is_bias=True)
        self._epsilon = epsilon

    def forward(self, x):
        return trace_op(
            "layer_norm",
            {"X": [x], "Scale": [self.weight], "Bias": [self.bias]},
            {"epsilon": self._epsilon, "begin_norm_axis": len(x.shape) - 1},
            ["Y"])["Y"][0]


class Dropout(Layer):
    def __init__(self, p=0.5, dtype="float32"):
        super().__init__(dtype=dtype)
        self._p = p

    def forward(self, x):
        return trace_op("dropout", {"X": [x]},
                        {"dropout_prob": self._p,
                         "is_test": not self.training,
                         "dropout_implementation": "upscale_in_train"},
                        ["Out"])["Out"][0]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        for i, l in enumerate(layers):
            setattr(self, f"l{i}", l)
        self._order = [f"l{i}" for i in range(len(layers))]

    def forward(self, x):
        for n in self._order:
            x = self._sub_layers[n](x)
        return x


def _tuple_n(v, n):
    return list(v) if isinstance(v, (list, tuple)) else [v] * n


class _ConvNd(Layer):
    """Shared machinery for the conv family (reference dygraph/nn.py Conv2D
    :35, Conv3D, Conv2DTranspose, Conv3DTranspose)."""

    def __init__(self, op_type, ndim, transpose, num_channels, num_filters,
                 filter_size, stride=1, padding=0, dilation=1, groups=1,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        fs = _tuple_n(filter_size, ndim)
        if transpose:
            wshape = [num_channels, num_filters // (groups or 1)] + fs
        else:
            wshape = [num_filters, num_channels // (groups or 1)] + fs
        self.weight = self.create_parameter(wshape)
        self.bias = (None if bias_attr is False
                     else self.create_parameter([num_filters], is_bias=True))
        self._op_type = op_type
        self._attrs = {"strides": _tuple_n(stride, ndim),
                       "paddings": _tuple_n(padding, ndim),
                       "dilations": _tuple_n(dilation, ndim),
                       "groups": groups or 1}
        self._act = act

    def forward(self, x):
        out = trace_op(self._op_type,
                       {"Input": [x], "Filter": [self.weight]},
                       self._attrs, ["Output"])["Output"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1}, ["Out"])["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out


class Conv2DTranspose(_ConvNd):
    def __init__(self, num_channels, num_filters, filter_size, **kw):
        super().__init__("conv2d_transpose", 2, True, num_channels,
                         num_filters, filter_size, **kw)


class Conv3D(_ConvNd):
    def __init__(self, num_channels, num_filters, filter_size, **kw):
        super().__init__("conv3d", 3, False, num_channels, num_filters,
                         filter_size, **kw)


class Conv3DTranspose(_ConvNd):
    def __init__(self, num_channels, num_filters, filter_size, **kw):
        super().__init__("conv3d_transpose", 3, True, num_channels,
                         num_filters, filter_size, **kw)


class GroupNorm(Layer):
    """Reference dygraph/nn.py GroupNorm."""

    def __init__(self, channels, groups=32, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter([channels], initializer="ones")
        self.bias = self.create_parameter([channels], is_bias=True)
        self._attrs = {"groups": groups, "epsilon": epsilon}
        self._act = act

    def forward(self, x):
        out = trace_op("group_norm",
                       {"X": [x], "Scale": [self.weight],
                        "Bias": [self.bias]},
                       self._attrs, ["Y"])["Y"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out


class PRelu(Layer):
    """Reference dygraph/nn.py PRelu."""

    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [int(channel)]
        else:
            shape = [int(np.prod(input_shape[1:]))]
        self.weight = self.create_parameter(shape, initializer="zeros")
        self._mode = mode

    def forward(self, x):
        return trace_op("prelu", {"X": [x], "Alpha": [self.weight]},
                        {"mode": self._mode}, ["Out"])["Out"][0]


class BilinearTensorProduct(Layer):
    """Reference dygraph/nn.py BilinearTensorProduct."""

    def __init__(self, input1_dim, input2_dim, output_dim, name=None,
                 act=None, param_attr=None, bias_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([1, output_dim],
                                                is_bias=True))
        self._act = act

    def forward(self, x, y):
        ins = {"X": [x], "Y": [y], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = trace_op("bilinear_tensor_product", ins, {}, ["Out"])["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out


class RowConv(Layer):
    """Reference dygraph/nn.py RowConv (lookahead convolution)."""

    def __init__(self, input_dim, future_context_size, param_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [future_context_size + 1, input_dim])
        self._act = act

    def forward(self, x):
        out = trace_op("row_conv", {"X": [x], "Filter": [self.weight]},
                       {}, ["Out"])["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out


class GRUUnit(Layer):
    """Reference dygraph/nn.py GRUUnit: one GRU step over pre-projected
    gate input [B, 3H] + hidden [B, H]; returns (hidden, reset_hidden, gate).
    Composed from registry ops on the tape. Gate math matches
    operators/gru_unit_op.h: u, r see h @ W_ur; the candidate sees
    (r*h) @ W_c only (NOT h @ W_c); origin_mode flips the update mix."""

    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid",
                 origin_mode=False, dtype="float32"):
        super().__init__(dtype=dtype)
        H = size // 3
        self._h = H
        self._origin = origin_mode
        self.weight = self.create_parameter([H, 3 * H])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([3 * H], is_bias=True))
        self._act, self._gate_act = activation, gate_activation

    def forward(self, gate_input, hidden):
        H = self._h

        def op(t, ins, attrs, outs=("Out",)):
            return trace_op(t, ins, attrs, list(outs))[outs[0]][0]

        def sl(x, lo, hi, axis=1):
            return op("slice", {"Input": [x]},
                      {"axes": [axis], "starts": [lo], "ends": [hi]})

        w_ur = sl(self.weight, 0, 2 * H)
        w_c = sl(self.weight, 2 * H, 3 * H)
        ur_in = op("elementwise_add",
                   {"X": [sl(gate_input, 0, 2 * H)],
                    "Y": [op("mul", {"X": [hidden], "Y": [w_ur]},
                             {"x_num_col_dims": 1, "y_num_col_dims": 1})]},
                   {"axis": -1})
        if self.bias is not None:
            ur_in = op("elementwise_add",
                       {"X": [ur_in], "Y": [sl(self.bias, 0, 2 * H, axis=0)]},
                       {"axis": 1})
        u = op(self._gate_act, {"X": [sl(ur_in, 0, H)]}, {})
        r = op(self._gate_act, {"X": [sl(ur_in, H, 2 * H)]}, {})
        rh = op("elementwise_mul", {"X": [r], "Y": [hidden]}, {"axis": -1})
        c_in = op("elementwise_add",
                  {"X": [sl(gate_input, 2 * H, 3 * H)],
                   "Y": [op("mul", {"X": [rh], "Y": [w_c]},
                            {"x_num_col_dims": 1, "y_num_col_dims": 1})]},
                  {"axis": -1})
        if self.bias is not None:
            c_in = op("elementwise_add",
                      {"X": [c_in],
                       "Y": [sl(self.bias, 2 * H, 3 * H, axis=0)]},
                      {"axis": 1})
        c = op(self._act, {"X": [c_in]}, {})
        one_minus_u = op("scale", {"X": [u]}, {"scale": -1.0, "bias": 1.0})
        if self._origin:     # h = (1-u)*h + u*c (original-paper convention)
            a, b = one_minus_u, u
        else:                # h = u*h + (1-u)*c (paddle default)
            a, b = u, one_minus_u
        nh = op("elementwise_add",
                {"X": [op("elementwise_mul", {"X": [a], "Y": [hidden]},
                          {"axis": -1})],
                 "Y": [op("elementwise_mul", {"X": [b], "Y": [c]},
                          {"axis": -1})]},
                {"axis": -1})
        # reference gru_unit_op.h stores the ACTIVATED gates in Gate
        gate = op("concat", {"X": [u, r, c]}, {"axis": 1})
        return nh, rh, gate


class NCE(Layer):
    """Reference dygraph/nn.py:1840 NCE: noise-contrastive estimation head
    over the registry's nce op (uniform negative sampler + logQ correction)."""

    def __init__(self, num_total_classes, dim, num_neg_samples=10,
                 param_attr=None, bias_attr=None, sampler="uniform",
                 dtype="float32"):
        super().__init__(dtype=dtype)
        if sampler != "uniform":
            raise NotImplementedError(
                "custom_dist/log_uniform samplers: the op draws uniform "
                "negatives (reference default)")
        self._attrs = {"num_total_classes": int(num_total_classes),
                       "num_neg_samples": int(num_neg_samples)}
        self.weight = self.create_parameter([num_total_classes, dim])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([num_total_classes],
                                                is_bias=True))

    def forward(self, input, label):
        ins = {"Input": [input], "Label": [label], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        return trace_op("nce", ins, self._attrs, ["Cost"])["Cost"][0]


class SequenceConv(Layer):
    """Reference dygraph/nn.py:2557 SequenceConv: context-window projection
    over padded [B, T, D] sequences (+ optional length masking)."""

    def __init__(self, num_filters, filter_size=3, filter_stride=1,
                 padding=True, input_dim=None, bias_attr=None,
                 param_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        if input_dim is None:
            raise ValueError("pass input_dim (the reference inferred it on "
                             "first forward; explicit is simpler)")
        self._attrs = {"context_length": int(filter_size),
                       "context_start": -((int(filter_size) - 1) // 2)}
        self.filter = self.create_parameter(
            [int(filter_size) * int(input_dim), num_filters])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([num_filters], is_bias=True))
        self._act = act

    def forward(self, x, length=None):
        ins = {"X": [x], "Filter": [self.filter]}
        if length is not None:
            ins["Length"] = [length]
        out = trace_op("sequence_conv", ins, self._attrs, ["Out"])["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": -1}, ["Out"])["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out


class SpectralNorm(Layer):
    """Reference dygraph/nn.py:2830 SpectralNorm: weight / sigma_max via
    power iteration; the U/V iteration vectors persist across calls."""

    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self._attrs = {"dim": int(dim), "power_iters": int(power_iters),
                       "eps": float(eps)}
        h = int(weight_shape[dim])
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= int(s)
        self.weight_u = self.create_parameter([h], initializer="normal")
        self.weight_v = self.create_parameter([w], initializer="normal")
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        outs = trace_op("spectral_norm",
                        {"Weight": [weight], "U": [self.weight_u],
                         "V": [self.weight_v]},
                        self._attrs, ["Out", "UOut", "VOut"])
        self.weight_u.value = outs["UOut"][0].value
        self.weight_v.value = outs["VOut"][0].value
        return outs["Out"][0]


class TreeConv(Layer):
    """Reference dygraph/nn.py:2930 TreeConv: tree-based convolution
    (TBCNN) over the registry's tree_conv op."""

    def __init__(self, feature_size, output_size, num_filters=1, max_depth=2,
                 act="tanh", param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        self._attrs = {"max_depth": int(max_depth)}
        self.filter = self.create_parameter(
            [int(feature_size), 3, int(output_size), int(num_filters)])
        self.bias = (None if bias_attr is False
                     else self.create_parameter([int(num_filters)],
                                                is_bias=True))
        self._act = act

    def forward(self, nodes_vector, edge_set):
        out = trace_op("tree_conv",
                       {"NodesVector": [nodes_vector],
                        "EdgeSet": [edge_set], "Filter": [self.filter]},
                       self._attrs, ["Out"])["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add",
                           {"X": [out], "Y": [self.bias]},
                           {"axis": -1}, ["Out"])["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {}, ["Out"])["Out"][0]
        return out
