"""The port's op library: PyTorch lowerings of the op types this slice runs.

Importing this package registers them.
"""
from . import basic            # noqa: F401
from . import elementwise      # noqa: F401
from . import math_ops         # noqa: F401
from . import activations      # noqa: F401
from . import tensor_ops       # noqa: F401
from . import nn_ops           # noqa: F401
from . import flash_attention  # noqa: F401
