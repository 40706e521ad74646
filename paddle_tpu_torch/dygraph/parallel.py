"""Dygraph DataParallel (reference: python/paddle/fluid/dygraph/parallel.py:84).

The port's copy of ``paddle_tpu/dygraph/parallel.py``. The JAX package runs a
wrapped Layer SPMD over a device mesh (the batch sharded, the parameters
replicated, XLA inserting the gradient reduction). The port runs it the
reference's way, one process a rank over ``torch.distributed``
(``parallel.init_parallel_env``): each rank feeds its rows of the batch,
``DataParallel`` broadcasts the parameters from rank 0 when it wraps the
layer, and ``apply_collective_grads`` averages every parameter's gradient
over the ranks, so each rank's update is the global batch's. ``scale_loss``
is the identity, as in the JAX package: the averaged gradient of the local
mean losses is the gradient of the global mean loss (equal rows a rank).
At one rank (no process group, or a world of 1) the wrapper is the layer.
"""
from __future__ import annotations

from typing import Optional

from .nn import Layer


def _world():
    """(world size, rank) of the default torch.distributed group, or (1, 0)
    without one; raises, as the executor's data-parallel path does, when the
    launcher's environment names several processes but no group exists
    (``parallel.env.dist_world_size``)."""
    import torch.distributed as dist
    from ..parallel import env as _penv
    n = _penv.dist_world_size()
    return n, (dist.get_rank() if n > 1 else 0)


class ParallelStrategy:
    """Parity shell for the reference's ParallelStrategy (parallel.py:37):
    ``nranks`` is torch.distributed's world size when a group exists, else 1
    (and it raises when the environment names ranks but no group exists)."""

    def __init__(self):
        self.nranks, self.local_rank = _world()
        self.trainer_endpoints = []
        self.current_endpoint = ""


def prepare_context(strategy: Optional[ParallelStrategy] = None):
    """Reference dygraph/parallel.py:prepare_context: returns the strategy
    (no communicator to build at one rank)."""
    return strategy or ParallelStrategy()


class DataParallel(Layer):
    """A dygraph Layer trained data-parallel over the process group's ranks.

    Usage (reference parallel.py:84 shape)::

        strategy = dygraph.prepare_context()
        model = dygraph.DataParallel(MyLayer(), strategy)
        loss = model(x, y)                 # x, y: this rank's rows
        loss = model.scale_loss(loss)      # the identity, as in the JAX package
        loss.backward()
        model.apply_collective_grads()     # the gradients averaged over the ranks
        opt.minimize(loss)

    ``mesh`` is the JAX package's device mesh; the port takes none (its
    mesh is the process group) and raises when one is given.
    """

    def __init__(self, layers: Layer, strategy: Optional[ParallelStrategy] = None,
                 mesh=None):
        super().__init__("data_parallel")
        if mesh is not None:
            raise NotImplementedError(
                "DataParallel(mesh=...): the port's mesh is the torch.distributed "
                "process group (parallel.init_parallel_env); pass no mesh")
        self._strategy = strategy or ParallelStrategy()
        self._layers = layers
        if self._strategy.nranks > 1:
            if _world()[0] != self._strategy.nranks:
                raise RuntimeError(
                    f"DataParallel over {self._strategy.nranks} ranks needs a process group "
                    f"of that size (the data-parallel path, ROADMAP item 13 (a)): call "
                    f"paddle_tpu_torch.parallel.init_parallel_env() first")
            self._broadcast_parameters()

    def _group(self):
        from ..ops import collective as _coll
        return _coll.world_group("dp")

    def _broadcast_parameters(self):
        """Every rank starts from rank 0's parameters (in place)."""
        import torch
        import torch.distributed as dist
        with torch.no_grad():
            for p in self._layers.parameters():
                t = p.value.detach()
                buf = t.contiguous()
                dist.broadcast(buf, 0)
                if buf is not t:
                    t.copy_(buf)

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """The identity, as the JAX package's (parallel.py:120 of the
        reference divides by nranks and sums the gradients; the port averages
        them instead, the same update)."""
        return loss

    def apply_collective_grads(self):
        """Average each parameter's gradient over the ranks (reference
        parallel.py:178 all-reduces them), in place; a parameter without a
        gradient on this rank takes part with zeros, so the ranks stay in
        step. The identity at one rank."""
        if self._strategy.nranks <= 1:
            return
        import torch
        from ..ops import collective as _coll
        g = self._group()
        with torch.no_grad():
            for p in self._layers.parameters():
                if p.stop_gradient:
                    continue
                grad = p.grad if p.grad is not None else torch.zeros_like(p.value)
                p.grad = _coll.all_reduce_sum(grad, g) / g.size

    # -- delegation --------------------------------------------------------------------
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self):
        return self._layers.state_dict()

    def set_dict(self, d):
        return self._layers.set_dict(d)

    load_dict = set_dict
