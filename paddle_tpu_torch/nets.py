"""Composite network blocks (reference: python/paddle/fluid/nets.py), the
port's copy of ``paddle_tpu/nets.py``.

simple_img_conv_pool:1, img_conv_group:31, sequence_conv_pool:134, glu:167,
scaled_dot_product_attention:199 -- pure compositions of the layer DSL, same
signatures as the reference, building the same ops as the JAX package's.
"""
from __future__ import annotations

from . import layers


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(input, num_filters, filter_size,
                             stride=conv_stride, padding=conv_padding,
                             dilation=conv_dilation, groups=conv_groups,
                             param_attr=param_attr, bias_attr=bias_attr,
                             act=act)
    return layers.pool2d(conv_out, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride, pool_padding=pool_padding,
                         global_pooling=global_pooling)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """VGG-style conv stack + pool (reference nets.py:31)."""
    def per_conv(v, n):
        return v if isinstance(v, (list, tuple)) else [v] * n
    n = len(conv_num_filter)
    pads = per_conv(conv_padding, n)
    fsizes = per_conv(conv_filter_size, n)
    acts = per_conv(conv_act, n)
    pattrs = per_conv(param_attr, n)
    bns = per_conv(conv_with_batchnorm, n)
    drops = per_conv(conv_batchnorm_drop_rate, n)
    tmp = input
    for i in range(n):
        tmp = layers.conv2d(tmp, conv_num_filter[i], fsizes[i],
                            padding=pads[i], param_attr=pattrs[i],
                            act=None if bns[i] else acts[i])
        if bns[i]:
            tmp = layers.batch_norm(tmp, act=acts[i])
            if drops[i]:
                tmp = layers.dropout(tmp, drops[i])
    return layers.pool2d(tmp, pool_size=pool_size, pool_type=pool_type,
                         pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max", bias_attr=None,
                       length=None):
    conv_out = layers.sequence_conv(input, num_filters, filter_size,
                                    param_attr=param_attr, act=act,
                                    bias_attr=bias_attr, length=length)
    return layers.sequence_pool(conv_out, pool_type, length=length)


def glu(input, dim=-1):
    """Gated linear unit (reference nets.py:167): split + sigmoid gate."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Reference nets.py:199. Q/K/V [B, T, D] -> multi-head attention through
    one ``fused_attention`` op: on the card it launches the CUDA
    flash-attention forward kernel (``csrc/flash_attn_fwd.cu``, K1-fwd), and
    its backward kernel when trained (the reference composes 7 ops and a
    transpose dance)."""
    q = layers.fc(queries, queries.shape[-1], num_flatten_dims=2)
    k = layers.fc(keys, keys.shape[-1], num_flatten_dims=2)
    v = layers.fc(values, values.shape[-1], num_flatten_dims=2)

    def heads_of(x):
        B_T = x.shape[1]
        d = x.shape[2]
        h = layers.reshape(x, [0, int(B_T), num_heads, int(d) // num_heads])
        return layers.transpose(h, [0, 2, 1, 3])

    d_head = int(queries.shape[-1]) // num_heads
    ctxs = layers.fused_attention(heads_of(q), heads_of(k), heads_of(v),
                                  scale=d_head ** -0.5,
                                  dropout_prob=dropout_rate)
    ctxs = layers.transpose(ctxs, [0, 2, 1, 3])
    return layers.reshape(ctxs, [0, int(queries.shape[1]),
                                 int(queries.shape[-1])])
