"""fluid.layers-style DSL surface: the layers the port's models build with."""
from .io import data  # noqa: F401
from .nn import (accuracy, cast, dropout, elementwise_add, embedding, fc,  # noqa: F401
                 fused_attention, gather, gelu, layer_norm, matmul, mean, reshape,
                 scale, slice, softmax, softmax_with_cross_entropy, split, topk,
                 transpose, unsqueeze)
from .tensor import create_parameter  # noqa: F401
