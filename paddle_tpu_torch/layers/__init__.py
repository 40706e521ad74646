"""fluid.layers-style DSL surface: the layers the port's models build with."""
from .io import data  # noqa: F401
from .nn import (accuracy, batch_norm, cast, conv2d, dropout,  # noqa: F401
                 elementwise_add, embedding, fc, fused_attention, gather, gelu,
                 layer_norm, matmul, mean, pool2d, relu, reshape, scale, slice,
                 softmax, softmax_with_cross_entropy, split, topk, transpose,
                 unsqueeze)
from .tensor import create_parameter  # noqa: F401
