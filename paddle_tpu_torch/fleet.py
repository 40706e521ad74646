"""Fleet facade: the high-level distributed front door (the port's copy of
``paddle_tpu/fleet.py``; reference python/paddle/fluid/incubate/fleet/
collective/__init__.py: init:38, distributed_optimizer:71, minimize:325;
fleet/base/role_maker.py).

``distributed_optimizer`` records the strategy, ``minimize`` runs the plain
optimizer, and ``fleet.main_program`` hands back a ``CompiledProgram``
carrying the ``DistributedStrategy``: the executor inserts the gradient
all-reduces (``comm/rewrite.py``) where the reference's rewrite pass put
them. Role discovery and the process group are ``parallel/env.py``'s
(``fleet.init`` makes the group when the launcher names several ranks).

Usage (reference-shaped)::

    from paddle_tpu_torch import fleet
    fleet.init()
    opt = fleet.distributed_optimizer(pt.optimizer.Adam(1e-4))
    opt.minimize(loss)
    exe.run(pt.default_startup_program())
    exe.run(fleet.main_program, feed=..., fetch_list=[loss])
"""
from __future__ import annotations

from typing import Optional

from .compiler import CompiledProgram, DistributedStrategy
from .framework import default_main_program, default_startup_program
from .parallel import env as _penv


class PaddleCloudRoleMaker:
    """Env-var role discovery (reference role_maker.py PaddleCloudRoleMaker)."""

    def __init__(self, is_collective=True):
        self.is_collective = is_collective

    def worker_index(self):
        return _penv.get_rank()

    def worker_num(self):
        return _penv.get_world_size()


class UserDefinedRoleMaker(PaddleCloudRoleMaker):
    def __init__(self, current_id=0, role=None, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._id = current_id
        self._num = worker_num

    def worker_index(self):
        return self._id

    def worker_num(self):
        return self._num


class _Fleet:
    def __init__(self):
        self._role = None
        self._strategy: Optional[DistributedStrategy] = None
        self._compiled: Optional[CompiledProgram] = None
        self._origin_program = None

    # -- lifecycle (reference collective/__init__.py:38) -------------------------------
    def init(self, role_maker=None, is_collective=True):
        self._role = role_maker or PaddleCloudRoleMaker(is_collective)
        if self._role.worker_num() > 1:
            _penv.init_parallel_env()
        return self

    def init_worker(self):
        return None   # no pserver handshake: init_parallel_env did the join

    def init_server(self, model_dir=None):
        raise NotImplementedError(
            "fleet PS mode is out of scope, as in the JAX package; collective "
            "mode is the port's path")

    def run_server(self):
        raise NotImplementedError("see init_server")

    def stop_worker(self):
        return None

    # -- info --------------------------------------------------------------------------
    def worker_index(self):
        return (self._role or PaddleCloudRoleMaker()).worker_index()

    def worker_num(self):
        return (self._role or PaddleCloudRoleMaker()).worker_num()

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_endpoints(self, to_string=False):
        import os
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        lst = eps.split(",") if eps else []
        return ",".join(lst) if to_string else lst

    def barrier_worker(self):
        _penv.barrier("fleet_barrier")

    # -- the distributed optimizer (reference :71, CollectiveOptimizer:300) ------------
    def distributed_optimizer(self, optimizer, strategy=None):
        if strategy is None:
            strategy = DistributedStrategy()
        elif not isinstance(strategy, DistributedStrategy):
            # accept the reference's dict-style strategy knobs
            s = DistributedStrategy()
            for k, v in dict(strategy).items():
                setattr(s, k, v)
            strategy = s
        self._strategy = strategy
        fleet = self

        class _DistributedOptimizer:
            def __init__(self, inner):
                self._inner = inner

            def minimize(self, loss, startup_program=None,
                         parameter_list=None, no_grad_set=None):
                out = self._inner.minimize(loss, startup_program,
                                           parameter_list, no_grad_set)
                fleet._origin_program = loss.block.program
                fleet._compiled = CompiledProgram(
                    loss.block.program).with_strategy(fleet._strategy)
                return out

            def __getattr__(self, n):
                return getattr(self._inner, n)

        return _DistributedOptimizer(optimizer)

    # -- programs ----------------------------------------------------------------------
    @property
    def main_program(self):
        if self._compiled is None:
            raise RuntimeError("call fleet.distributed_optimizer(...).minimize "
                               "before fleet.main_program")
        return self._compiled

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def _origin_main_program(self):
        return self._origin_program or default_main_program()

    # -- checkpoint passthroughs (reference :76) ---------------------------------------
    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        """The first worker writes the model (the parameters are replicated);
        the others wait for it."""
        from . import io
        out = None
        if self.is_first_worker():
            out = io.save_inference_model(
                dirname, feeded_var_names, target_vars, executor,
                main_program or self._origin_main_program)
        self.barrier_worker()
        return out

    def save_persistables(self, executor, dirname, main_program=None):
        """``io.save_persistables`` of the compiled program: the replicated
        state from the first worker, each rank's ZeRO blocks from it."""
        from . import io
        return io.save_persistables(executor, dirname,
                                    main_program or self._compiled or
                                    self._origin_main_program)


fleet = _Fleet()

# module-level convenience mirroring `from ...collective import fleet`
init = fleet.init
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker
save_inference_model = fleet.save_inference_model
save_persistables = fleet.save_persistables


def __getattr__(name):
    # `from paddle_tpu import fleet` binds this MODULE where the reference
    # binds the singleton; delegate property access (main_program, ...)
    return getattr(fleet, name)
