"""The port's op library: PyTorch lowerings of the op types its slices run.

Importing this package registers them.
"""
from . import basic            # noqa: F401
from . import elementwise      # noqa: F401
from . import math_ops         # noqa: F401
from . import activations      # noqa: F401
from . import tensor_ops       # noqa: F401
from . import dropout          # noqa: F401
from . import nn_ops           # noqa: F401
from . import flash_attention  # noqa: F401
from . import conv_bn          # noqa: F401
from . import metrics_ops      # noqa: F401
from . import optimizer_ops    # noqa: F401
from . import multi_tensor     # noqa: F401
from . import reduce_ops       # noqa: F401
from . import beam_ops         # noqa: F401
from . import control_flow     # noqa: F401
from . import sequence_ops     # noqa: F401
from . import ctc_crf_ops      # noqa: F401
from . import host_table       # noqa: F401
from . import detection_ops    # noqa: F401
from . import extra_ops        # noqa: F401
from . import tail_ops         # noqa: F401
from . import sampled_ops      # noqa: F401
from . import collective     # noqa: F401
