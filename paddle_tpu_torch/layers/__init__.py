"""fluid.layers-style DSL surface: the layers this slice's model builds with."""
from .io import data  # noqa: F401
from .nn import (cast, dropout, elementwise_add, embedding, fc,  # noqa: F401
                 fused_attention, gelu, layer_norm, reshape, scale, split,
                 transpose, unsqueeze)
