"""contrib: post-training weight quantization, the conv + batch-norm
statistics fusion pass and decoupled weight decay (the port's copies of
``paddle_tpu/contrib/quantize.py``, ``fuse_conv_bn.py`` and
``extend_optimizer.py``)."""
from . import quantize  # noqa: F401  (registers quantized_mul, dequantize_weight)
from . import fuse_conv_bn  # noqa: F401
from .fuse_conv_bn import fuse_conv_bn_stats  # noqa: F401
from .extend_optimizer import extend_with_decoupled_weight_decay  # noqa: F401
