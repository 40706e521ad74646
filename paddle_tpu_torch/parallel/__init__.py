"""Multi-process runtime over ``torch.distributed`` (the port's copy of
``paddle_tpu/parallel/``): process bootstrap and role discovery
(``env.py``) and the launcher (``launch.py``). The pipeline schedule, ring
attention and Ulysses are ROADMAP item 13 (b)."""
from . import env  # noqa: F401
from .env import (ParallelEnv, barrier, get_rank, get_world_size,  # noqa: F401
                  global_mesh, init_parallel_env, local_device_count, monitored_run)
