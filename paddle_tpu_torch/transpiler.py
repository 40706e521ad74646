"""Transpiler facade (reference: python/paddle/fluid/transpiler/), the port's
copy of ``paddle_tpu/transpiler.py``.

The reference's transpilers rewrite programs for multi-process training
(DistributeTranspiler: pserver/NCCL graph split) and memory reuse
(memory_optimize). Neither rewrite exists in the port:

* collective training is a distribution strategy over ``torch.distributed``:
  ``CompiledProgram`` / ``fleet`` insert the gradient all-reduces (ROADMAP
  item 13 (a), ``comm/rewrite.py``), with no transpiler;
* pserver mode is scoped out (SCOPE.md parameter-server row);
* buffer reuse is the executor's: each intermediate is dropped after its last
  reader, and PyTorch's caching allocator reuses it.

This module keeps the import surface alive for ported code: the memory
functions are documented no-ops that warn; DistributeTranspiler raises.
"""
from __future__ import annotations

import warnings

__all__ = ["DistributeTranspiler", "DistributeTranspilerConfig",
           "memory_optimize", "release_memory", "HashName", "RoundRobin"]

_NOT_PORTED = ("DistributeTranspiler's pserver/NCCL program rewrite is not part of the "
               "port: collective training runs through CompiledProgram.with_data_parallel "
               "or fleet over torch.distributed (ROADMAP item 13 (a)), and "
               "parameter-server mode is scoped out (SCOPE.md)")


class DistributeTranspilerConfig:
    """Knob shell (reference distribute_transpiler.py:DistributeTranspilerConfig)."""

    def __init__(self):
        self.slice_var_up = True
        self.split_method = None
        self.min_block_size = 8192
        self.sync_mode = True
        self.mode = "pserver"


class DistributeTranspiler:
    """Reference distribute_transpiler.py:230. Every rewrite raises
    NotImplementedError naming the port's collective path (ROADMAP item 13 (a))."""

    def __init__(self, config=None):
        self.config = config or DistributeTranspilerConfig()

    def transpile(self, trainer_id, program=None, pservers="", trainers=1,
                  sync_mode=True, startup_program=None, current_endpoint=""):
        raise NotImplementedError(_NOT_PORTED)

    def get_trainer_program(self, wait_port=True):
        raise NotImplementedError(_NOT_PORTED)

    def get_pserver_program(self, endpoint):
        raise NotImplementedError(_NOT_PORTED)

    def get_startup_program(self, endpoint, pserver_program=None):
        raise NotImplementedError(_NOT_PORTED)


def memory_optimize(input_program, skip_opt_set=None, print_log=False,
                    level=0, skip_grads=True):
    """Reference memory_optimization_transpiler.py: a no-op that warns. The
    executor frees each intermediate after its last reader and PyTorch's
    caching allocator reuses the memory; a captured step's graph pool does
    the same inside the capture."""
    warnings.warn("paddle_tpu_torch: memory_optimize is a no-op -- the executor frees "
                  "each intermediate after its last reader and the caching allocator "
                  "reuses it", UserWarning, stacklevel=2)
    return None


def release_memory(input_program, skip_opt_set=None):
    """See memory_optimize: a no-op that warns."""
    warnings.warn("paddle_tpu_torch: release_memory is a no-op -- the executor frees "
                  "each intermediate after its last reader", UserWarning, stacklevel=2)
    return None


class HashName:
    """PS shard dispatcher shell (ps_dispatcher.py). Only meaningful with the
    scoped-out pserver mode; kept so imports resolve."""

    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)

    def dispatch(self, varlist):
        return [self._eps[hash(v.name) % len(self._eps)] for v in varlist]


class RoundRobin:
    def __init__(self, pserver_endpoints):
        self._eps = list(pserver_endpoints)
        self._i = 0

    def dispatch(self, varlist):
        out = []
        for v in varlist:
            out.append(self._eps[self._i % len(self._eps)])
            self._i += 1
        return out
