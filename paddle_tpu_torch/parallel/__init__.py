"""Multi-process runtime over ``torch.distributed`` (the port's copy of
``paddle_tpu/parallel/``): process bootstrap, role discovery and the mesh's
process groups (``env.py``), the launcher (``launch.py``), the GPipe
schedule over a ``pp`` group (``pipeline.py``) and ring and Ulysses
attention over an ``sp`` group (``ring_attention.py``, ``ulysses.py``)."""
from . import env  # noqa: F401
from .env import (ParallelEnv, barrier, get_rank, get_world_size,  # noqa: F401
                  global_mesh, init_parallel_env, local_device_count, monitored_run)
from .pipeline import pipeline_spmd  # noqa: F401
from . import ring_attention  # noqa: F401  (module: .ring_attention(...))
from . import ulysses  # noqa: F401         (module: .ulysses_attention(...))
