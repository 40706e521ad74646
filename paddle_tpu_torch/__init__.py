"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The same Fluid-style surface as ``paddle_tpu`` -- a Program IR built by a
layers DSL, an Executor (``train_from_dataset`` over MultiSlot files), the reader
pipeline, save/load of variables and inference models and a Predictor, the fluid
helpers (``nets``, ``metrics``, ``average``, ``debugger``, ``net_drawer``,
``install_check``, ``transpiler``), imperative mode (``dygraph``: eager
layers on a tape, traced into a Program), data parallel over
``torch.distributed`` (``CompiledProgram``, ``fleet``, ``parallel``, ``comm``) --
running eagerly on PyTorch tensors, with the TPU's Pallas kernels replaced by
CUDA kernels written for Hopper (``csrc/``). The device is explicit: the card
(``cuda``) unless the caller asks for the CPU.
"""

from . import unique_name  # noqa: F401
from .framework import (Program, Block, Variable, Parameter, Operator,  # noqa: F401
                        program_guard, default_main_program, default_startup_program,
                        switch_main_program, convert_dtype)
from . import ops  # noqa: F401  (registers the op library)
from .core.executor import (CPUPlace, CUDAPlace, Executor, Scope,  # noqa: F401
                            global_scope, scope_guard)
from .core import registry  # noqa: F401
from . import layers  # noqa: F401
from . import initializer  # noqa: F401
from .layer_helper import LayerHelper, ParamAttr  # noqa: F401
from .layers.io import data  # noqa: F401
from . import io  # noqa: F401
from . import inference  # noqa: F401
from . import convert  # noqa: F401
from . import optimizer  # noqa: F401
from . import regularizer  # noqa: F401
from . import clip  # noqa: F401
from .core.backward import append_backward, calc_gradient, gradients  # noqa: F401
from . import models  # noqa: F401
from . import contrib  # noqa: F401  (registers quantized_mul, dequantize_weight)
from .dataset_factory import DatasetFactory, InMemoryDataset, QueueDataset  # noqa: F401
from . import reader  # noqa: F401
from .reader import DataFeeder, DataLoader, PyReader  # noqa: F401
from . import incubate  # noqa: F401
from . import dataset  # noqa: F401
from . import resilience  # noqa: F401  (fault injection + step recovery)
from . import utils  # noqa: F401  (clock, fs, checkpointer, flops, benchtime)
from . import flags  # noqa: F401
from .flags import get_flag, set_flags  # noqa: F401
from . import observability  # noqa: F401
from . import profiler  # noqa: F401
from . import analysis  # noqa: F401  (static verifier: analysis.verify, the CLI)
from . import nets  # noqa: F401
from . import transpiler  # noqa: F401
from .transpiler import DistributeTranspiler, DistributeTranspilerConfig  # noqa: F401
from .transpiler import memory_optimize, release_memory  # noqa: F401
from . import debugger  # noqa: F401
from . import average  # noqa: F401
from . import install_check  # noqa: F401
from . import net_drawer  # noqa: F401
from . import metrics  # noqa: F401
from . import dygraph  # noqa: F401
from .compiler import (BuildStrategy, CompiledProgram, DistributedStrategy,  # noqa: F401
                       ExecutionStrategy)
from . import comm  # noqa: F401  (quantized collectives + reshard planner)
from . import parallel  # noqa: F401  (init_parallel_env, the launcher)
from . import fleet  # noqa: F401

__version__ = "0.1.0"
