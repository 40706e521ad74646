"""Imperative mode (reference: python/paddle/fluid/dygraph/), the port's
copy of ``paddle_tpu.dygraph``: the same names, on ``torch.Tensor``s.

On the CPU: ``with dygraph.guard(CPUPlace()): ...``; ``guard()`` is the card.
"""
from .base import (VarBase, to_variable, guard, no_grad, enabled,  # noqa
                   trace_op, backward)
from .nn import (Layer, Linear, FC, Conv2D, Pool2D, Embedding, BatchNorm,  # noqa
                 LayerNorm, Dropout, Sequential, Conv2DTranspose, Conv3D,
                 Conv3DTranspose, GroupNorm, PRelu, BilinearTensorProduct,
                 RowConv, GRUUnit)
from .optimizer import SGDOptimizer, AdamOptimizer, MomentumOptimizer  # noqa
from .checkpoint import save_dygraph, load_dygraph  # noqa: F401
from .parallel import DataParallel, ParallelStrategy, prepare_context  # noqa
from .jit import TracedLayer  # noqa: F401
