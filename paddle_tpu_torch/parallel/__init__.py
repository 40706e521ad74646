"""Multi-process role discovery (the port's copy of the part of
``paddle_tpu/parallel/`` the input pipeline reads). Collectives and meshes
over ``torch.distributed`` are not ported yet."""
from . import env  # noqa: F401
