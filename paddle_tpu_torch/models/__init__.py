"""Models built with the port's DSL."""
from . import bert  # noqa: F401
from . import resnet  # noqa: F401
from . import transformer  # noqa: F401
