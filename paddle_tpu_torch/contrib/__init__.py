"""contrib: automatic mixed precision, post-training weight quantization,
the conv + batch-norm statistics fusion pass, decoupled weight decay and
pruning and distillation (the port's copies of
``paddle_tpu/contrib/mixed_precision.py``, ``quantize.py``,
``fuse_conv_bn.py``, ``extend_optimizer.py`` and ``slim.py``)."""
from . import mixed_precision  # noqa: F401
from . import quantize  # noqa: F401  (registers quantized_mul, dequantize_weight)
from . import fuse_conv_bn  # noqa: F401
from .fuse_conv_bn import fuse_conv_bn_stats  # noqa: F401
from .extend_optimizer import extend_with_decoupled_weight_decay  # noqa: F401
from . import slim  # noqa: F401
