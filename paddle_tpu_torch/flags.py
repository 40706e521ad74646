"""Typed flag registry with ``FLAGS_*`` environment override (the port's
copy of ``paddle_tpu/flags.py``).

One registry of typed flags, each read from ``FLAGS_<name>`` when it is
defined and settable at run time. The live flags keep the JAX package's
meanings on the port's executor: ``benchmark`` synchronises the card after
every ``Executor.run`` (synchronous step timing), ``profile_executor``
records a ``fluid.profiler`` event per run, ``check_nan_inf`` raises when a
run leaves a NaN or Inf in the state it wrote, ``check_dtype`` raises when
an op writes another dtype than its variable declares.
``executor_cache_capacity`` is defined and unread, as in the JAX package
(the cache's bound is ``Executor._CACHE_CAP``). The CUDA-era knobs that the JAX package accepts as no-ops are accepted here
as no-ops too.

The flags that only configure XLA (``prng_impl``, ``xla_compiler_options``)
have no counterpart: setting one raises, naming it, and a ``FLAGS_`` value
for one in the environment is ignored with a warning.
"""
from __future__ import annotations

import os
import warnings
from typing import Any, Dict


class _Flag:
    def __init__(self, name: str, default, typ, help: str, noop: bool = False):
        self.name = name
        self.default = default
        self.typ = typ
        self.help = help
        self.noop = noop
        self.value = default


_REGISTRY: Dict[str, _Flag] = {}

#: the JAX package's flags that configure XLA only, and why they are absent
_REFUSED = {
    "prng_impl": "it picks JAX's PRNG implementation; the port draws from its "
                 "counter-derived Philox streams",
    "xla_compiler_options": "it passes options to the XLA compiler, which the "
                            "port does not use",
}


def _parse(typ, s: str):
    if typ is bool:
        return s.lower() in ("1", "true", "yes", "on")
    return typ(s)


def _refused(name: str) -> str:
    return f"flag {name!r} has no counterpart in paddle_tpu_torch: {_REFUSED[name]}"


def define_flag(name: str, default, typ=None, help: str = "", noop: bool = False):
    typ = typ or type(default)
    f = _Flag(name, default, typ, help, noop)
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        f.value = _parse(typ, env)
    _REGISTRY[name] = f
    return f


def get_flag(name: str):
    if name in _REFUSED:
        raise KeyError(_refused(name))
    return _REGISTRY[name].value


def set_flag(name: str, value):
    if name in _REFUSED:
        raise ValueError(_refused(name))
    f = _REGISTRY[name]
    f.value = _parse(f.typ, str(value)) if not isinstance(value, f.typ) else value


def set_flags(d: Dict[str, Any]):
    for k, v in d.items():
        set_flag(k.replace("FLAGS_", ""), v)


def list_flags():
    return {n: f.value for n, f in _REGISTRY.items()}


# -- live flags ---------------------------------------------------------------------------
define_flag("check_nan_inf", False, bool,
            "raise after a run that left NaN/Inf in the state it wrote "
            "(reference operator.cc:949)")
define_flag("check_dtype", False, bool,
            "raise when an op writes another dtype than its variable declares")
define_flag("benchmark", False, bool,
            "synchronise the card after every executor run for stable timing "
            "(reference FLAGS_benchmark forced per-op dev_ctx->Wait())")
define_flag("executor_cache_capacity", 64, int,
            "LRU capacity of the executor compile cache")
define_flag("profile_executor", False, bool,
            "record per-run wall time in profiler aggregate table")

for _name in _REFUSED:
    if os.environ.get(f"FLAGS_{_name}") is not None:
        warnings.warn(f"FLAGS_{_name} is ignored: {_REFUSED[_name]}")

# -- accepted no-ops (CUDA-era knobs kept so ported scripts run unchanged) -------------
for _name, _default in [
    ("fraction_of_gpu_memory_to_use", 0.92), ("eager_delete_tensor_gb", 0.0),
    ("memory_fraction_of_eager_deletion", 1.0), ("allocator_strategy", "auto"),
    ("cudnn_deterministic", False), ("cudnn_exhaustive_search", False),
    ("enable_cublas_tensor_op_math", False), ("conv_workspace_size_limit", 512),
    ("cpu_deterministic", False), ("paddle_num_threads", 1),
    ("use_pinned_memory", True), ("init_allocated_mem", False),
    ("free_idle_memory", False), ("fuse_parameter_memory_size", -1),
    ("rpc_deadline", 180000), ("rpc_retry_times", 3),
]:
    define_flag(_name, _default,
                help="accepted for fluid port compatibility; no effect in "
                     "paddle_tpu_torch (PyTorch's caching allocator, cuDNN "
                     "and cuBLAS are configured by the executor)",
                noop=True)
