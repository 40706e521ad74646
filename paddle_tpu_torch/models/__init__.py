"""Models built with the port's DSL."""
from . import bert  # noqa: F401
from . import deepfm  # noqa: F401
from . import mnist  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
from . import vgg  # noqa: F401
