"""CUDA graphs: the capture code that the ``Predictor`` and the ``Executor``
share (the port's counterpart of ``jax.jit``'s compiled executable).

``warm_up(device, fn)`` runs ``fn`` once on a side stream, so that what the
first launch of each kernel sets up (loaded modules, cuBLAS and cuDNN
handles and workspaces) exists before a capture. ``Graph(device, fn)``
captures ``fn`` into one CUDA graph with a memory pool of its own: the
device is synchronised and the allocator's cache emptied first, so that
what the capture reserves is its pool (``memory_bytes``), and the capture
runs in ``thread_local`` mode, so that another thread launching work of its
own meanwhile does not break it. ``Graph.replay()`` launches the graph.

The kernel wrappers' ``launches`` are host counters that a replay does not
move, so the capture's launches are taken back off them and added again on
every replay: they count what ran. A capture counts only the launches on
its capture stream (``cuda_build.stream_launches``), from its own thread and
from autograd's device thread: another thread running eagerly meanwhile
neither adds its launches to the graph nor loses them.

A kernel wrapper that makes a buffer the graph must keep (the multi-tensor
update's work table) passes it to ``hold`` from the capturing thread: it
lives as long as the graph. What such a buffer holds has to be written by
the graph itself, on each replay: a block of the graph's pool may have held
an earlier node's data, which the replay writes again. A capture that fails
raises: nothing runs eagerly instead.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List

import torch

from . import cuda_build

_tls = threading.local()


def hold(t: torch.Tensor) -> None:
    """Keep ``t`` alive as long as the graph this thread is capturing (no-op
    outside a capture)."""
    held = getattr(_tls, "held", None)
    if held is not None:
        held.append(t)


def warm_up(device: torch.device, fn: Callable[[], object]):
    """``fn()`` on a side stream that waits for the current one; the current
    stream then waits for it. Returns what ``fn`` returns."""
    side = torch.cuda.Stream(device)
    cur = torch.cuda.current_stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    return out


class Graph:
    """``fn()`` captured as one CUDA graph in a memory pool of its own.
    ``outputs`` is what ``fn`` returned during the capture: tensors in the
    pool that every replay rewrites."""

    def __init__(self, device: torch.device, fn: Callable[[], object]):
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()     # as the capture does first: what it adds is its pool
        reserved = torch.cuda.memory_reserved(device)
        self.graph = torch.cuda.CUDAGraph()
        held = _tls.held = []
        # thread_local: another thread serving its own signature meanwhile does
        # not break this capture (the capturing thread's own syncs still do)
        capture = torch.cuda.graph(self.graph, pool=torch.cuda.graph_pool_handle(),
                                   capture_error_mode="thread_local")
        with cuda_build.stream_launches(capture.capture_stream) as mine:
            try:
                with capture:
                    self.outputs = fn()
            finally:
                _tls.held = None
                #: each wrapper's launches in one replay
                self.launches: Dict[Callable, int] = dict(mine)
                cuda_build.add_launches(mine, -1)
        #: device memory the capture reserved for this graph's pool (bytes)
        self.memory_bytes = torch.cuda.memory_reserved(device) - reserved
        self._held: List[torch.Tensor] = held

    def replay(self) -> None:
        self.graph.replay()
        cuda_build.add_launches(self.launches)
