"""contrib: post-training weight quantization and the conv + batch-norm
statistics fusion pass (the port's copies of ``paddle_tpu/contrib/quantize.py``
and ``fuse_conv_bn.py``)."""
from . import quantize  # noqa: F401  (registers quantized_mul, dequantize_weight)
from . import fuse_conv_bn  # noqa: F401
from .fuse_conv_bn import fuse_conv_bn_stats  # noqa: F401
