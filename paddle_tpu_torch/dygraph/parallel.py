"""Dygraph DataParallel (reference: python/paddle/fluid/dygraph/parallel.py:84),
at one rank.

The port's copy of ``paddle_tpu/dygraph/parallel.py``. The JAX package runs
a wrapped Layer SPMD over a device mesh (the batch sharded, the parameters
replicated, XLA inserting the gradient reduction). The port's data-parallel
path over several processes (``torch.distributed``, the collectives) is
ROADMAP item 13 and not ported yet: at one rank ``DataParallel`` runs the
wrapped layer as it is, and ``scale_loss`` / ``apply_collective_grads`` are
the identity, as in the JAX package. With more than one rank it raises.
"""
from __future__ import annotations

from typing import Optional

from .nn import Layer

ITEM_13 = ("ROADMAP item 13 (distributed): dygraph DataParallel over several ranks "
           "(torch.distributed and the gradient all-reduce) is not ported yet; the "
           "port runs it at one rank")


def _world():
    """(world size, rank) of the default torch.distributed group, or (1, 0)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ParallelStrategy:
    """Parity shell for the reference's ParallelStrategy (parallel.py:37):
    ``nranks`` is torch.distributed's world size when a group exists, else 1."""

    def __init__(self):
        self.nranks, self.local_rank = _world()
        self.trainer_endpoints = []
        self.current_endpoint = ""


def prepare_context(strategy: Optional[ParallelStrategy] = None):
    """Reference dygraph/parallel.py:prepare_context: returns the strategy
    (no communicator to build at one rank)."""
    return strategy or ParallelStrategy()


class DataParallel(Layer):
    """A dygraph Layer under the data-parallel API, at one rank.

    Usage (reference parallel.py:84 shape)::

        strategy = dygraph.prepare_context()
        model = dygraph.DataParallel(MyLayer(), strategy)
        loss = model(x, y)
        loss = model.scale_loss(loss)      # identity at one rank
        loss.backward()
        model.apply_collective_grads()     # identity at one rank
        opt.minimize(loss)

    ``mesh`` is the JAX package's device mesh; the port takes none.
    Raises NotImplementedError (ROADMAP item 13) when the strategy has more
    than one rank.
    """

    def __init__(self, layers: Layer, strategy: Optional[ParallelStrategy] = None,
                 mesh=None):
        super().__init__("data_parallel")
        self._strategy = strategy or ParallelStrategy()
        if self._strategy.nranks > 1 or mesh is not None:
            raise NotImplementedError(
                f"{ITEM_13} (nranks={self._strategy.nranks}"
                f"{', a mesh given' if mesh is not None else ''})")
        self._layers = layers

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        """Reference parallel.py:120 divides by nranks; at one rank the
        identity."""
        return loss

    def apply_collective_grads(self):
        """Reference parallel.py:178 all-reduces the grads; at one rank
        there is nothing to reduce."""
        return

    # -- delegation --------------------------------------------------------------------
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self):
        return self._layers.state_dict()

    def set_dict(self, d):
        return self._layers.set_dict(d)

    load_dict = set_dict
