from . import registry  # noqa: F401
