"""Process bootstrap over ``torch.distributed`` (the port's copy of
``paddle_tpu/parallel/env.py``; reference c_gen_nccl_id_op.cc:56,
nccl_helper.h:179-314, distributed/launch.py:147).

Role discovery reads the launcher's environment, the JAX package's names:
``PROCESS_ID`` / ``PADDLE_TRAINER_ID`` for the rank, ``NUM_PROCESSES`` /
``PADDLE_TRAINERS_NUM`` or the count of ``PADDLE_TRAINER_ENDPOINTS`` for the
world, ``COORDINATOR_ADDRESS`` (else the first endpoint) for rank 0's
rendezvous, and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` for the ranks of this
host (``parallel/launch.py`` sets them all).

``init_parallel_env`` makes the default process group, always with a
timeout, so that a missing or out-of-step rank fails in bounded time. The
backend rule is explicit, with no silent switch:

- ``nccl`` when each local rank has a card of its own (rank ``r`` of the
  host on ``cuda:r``);
- ``gloo`` on the CPU;
- two local ranks that would share one card raise unless the caller passes
  ``backend="gloo"`` (NCCL refuses two ranks on one device); under gloo
  they share ``cuda:(local_rank % cards)``, and their collectives on CUDA
  tensors are gloo's own.

A backend the caller names is used as named: ``nccl`` without a card
raises.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Dict, Optional

import torch

_state = {"initialized": False, "backend": None, "device": None, "timeout": 300.0}
#: the process groups of each mesh, made once (``mesh_groups``)
_GROUPS: Dict[tuple, dict] = {}


def _env_int(*names, default=0) -> int:
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return default


def get_rank() -> int:
    """Process index: the process group's rank once it exists, else
    ``PROCESS_ID``, ``PADDLE_TRAINER_ID``, 0."""
    import torch.distributed as dist
    if _state["initialized"] and dist.is_initialized():
        return dist.get_rank()
    return _env_int("PROCESS_ID", "PADDLE_TRAINER_ID", default=0)


def get_world_size() -> int:
    """Process count: the process group's once it exists, else
    ``NUM_PROCESSES``, ``PADDLE_TRAINERS_NUM``, the number of
    ``PADDLE_TRAINER_ENDPOINTS``, 1."""
    import torch.distributed as dist
    if _state["initialized"] and dist.is_initialized():
        return dist.get_world_size()
    n = _env_int("NUM_PROCESSES", "PADDLE_TRAINERS_NUM", default=0)
    if n:
        return n
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return len(eps.split(",")) if eps else 1


def get_local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``,
    else the rank)."""
    return _env_int("LOCAL_RANK", default=get_rank())


def get_local_world_size() -> int:
    """The ranks on this host (``LOCAL_WORLD_SIZE``, else the world)."""
    return _env_int("LOCAL_WORLD_SIZE", default=get_world_size())


def dist_world_size() -> int:
    """The size of the default process group, 1 without one. Raises when the
    launcher's environment names several processes but no group was made:
    a data-parallel run must not train each rank alone."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    n = get_world_size()
    if n > 1:
        raise RuntimeError(
            f"the environment names {n} processes but no process group exists: call "
            f"paddle_tpu_torch.parallel.init_parallel_env() before running a "
            f"data-parallel program")
    return 1


def _coordinator() -> Optional[str]:
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        return addr
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    if eps:
        return eps.split(",")[0]   # rank 0's endpoint serves the rendezvous
    return None


def choose_backend(backend: Optional[str] = None, local_world: Optional[int] = None,
                   cards: Optional[int] = None) -> str:
    """The backend rule (module docstring): ``nccl`` when every local rank
    has its own card, ``gloo`` without a card; two ranks on one card raise
    unless ``backend="gloo"``; ``nccl`` without a card raises."""
    cards = torch.cuda.device_count() if cards is None else int(cards)
    local_world = get_local_world_size() if local_world is None else int(local_world)
    if backend is not None and backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "gloo":
        return "gloo"
    if cards == 0:
        if backend == "nccl":
            raise RuntimeError("backend='nccl' needs a CUDA card; this process sees none")
        return "gloo"
    if local_world > cards:
        raise RuntimeError(
            f"{local_world} local ranks would share {cards} card(s): NCCL refuses two "
            f"ranks on one device; pass backend='gloo' to share a card over gloo")
    return "nccl"


def rank_device(backend: str, cards: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:local_rank`` (modulo the cards when ranks
    share one over gloo), the CPU without a card."""
    cards = torch.cuda.device_count() if cards is None else int(cards)
    if cards == 0:
        return torch.device("cpu")
    return torch.device("cuda", get_local_rank() % cards)


class ParallelEnv:
    """Role info for this process (reference fleet role_maker / ParallelEnv)."""

    def __init__(self):
        self.rank = get_rank()
        self.world_size = get_world_size()
        self.dev_id = get_local_rank()
        self.backend = _state["backend"]
        self.device = _state["device"]

    @property
    def nranks(self):
        return self.world_size

    @property
    def local_rank(self):
        return get_local_rank()


def _probe(addr: str, rank: int, n: int, timeout_seconds: float) -> None:
    """Wait until rank 0's rendezvous port accepts, or raise naming it."""
    host, port = addr.rsplit(":", 1)
    deadline = time.time() + timeout_seconds
    while True:
        try:
            socket.create_connection((host, int(port)), timeout=2).close()
            return
        except OSError as e:
            if time.time() >= deadline:
                raise RuntimeError(
                    f"init_parallel_env: rank {rank}/{n} could not reach the coordinator "
                    f"at {addr} within {timeout_seconds}s -- rank 0 is down or the "
                    f"address is wrong ({e})") from e
            time.sleep(0.2)


def init_parallel_env(coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      timeout_seconds: float = 300,
                      backend: Optional[str] = None) -> ParallelEnv:
    """Join this process into the job: the default ``torch.distributed``
    process group at ``tcp://<coordinator>`` (rank 0 serves it) with
    ``timeout_seconds`` on the rendezvous and on every collective. One
    process (no coordinator, or a world of 1 without a backend named) is
    a no-op, so a script runs unchanged on one process; a named backend
    makes a group of one (the card's NCCL communicator at world 1).
    Ranks other than 0 probe the coordinator first, so a wrong address
    fails with its name rather than a stack from the store."""
    import torch.distributed as dist
    if _state["initialized"] and dist.is_initialized():
        return ParallelEnv()
    n = num_processes if num_processes is not None else get_world_size()
    rank = process_id if process_id is not None else get_rank()
    addr = coordinator_address or _coordinator()
    if n <= 1 and backend is None:
        return ParallelEnv()
    if addr is None:
        if n > 1:
            raise RuntimeError(
                f"init_parallel_env: {n} processes but no coordinator address "
                f"(COORDINATOR_ADDRESS or PADDLE_TRAINER_ENDPOINTS)")
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
        s.close()
    local_world = get_local_world_size() if n > 1 else 1
    be = choose_backend(backend, local_world)
    dev = rank_device(be)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if rank != 0:
        _probe(addr, rank, n, timeout_seconds)
    try:
        dist.init_process_group(be, init_method=f"tcp://{addr}", world_size=n, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout_seconds))
    except Exception as e:
        raise RuntimeError(
            f"init_parallel_env: rank {rank}/{n} failed to join the job at {addr} "
            f"within {timeout_seconds}s over {be} -- a rank is down or the address "
            f"is wrong ({e})") from e
    _state.update(initialized=True, backend=be, device=dev, timeout=float(timeout_seconds))
    return ParallelEnv()


def destroy_parallel_env() -> None:
    """Tear the default process group down (a no-op without one), after a
    barrier: no rank closes its connections while a peer still waits on a
    collective's last message from it."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        barrier("destroy_parallel_env")
        dist.destroy_process_group()
    _GROUPS.clear()
    _state.update(initialized=False, backend=None, device=None)


def backend() -> Optional[str]:
    """The default group's backend (None without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def device() -> Optional[torch.device]:
    """The device ``init_parallel_env`` gave this rank (None before)."""
    return _state["device"]


def barrier(name: str = "paddle_tpu_barrier"):
    """Block until every process reaches this point: a one-element
    all-reduce on the group's device, bounded by the group's timeout."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() <= 1:
        return
    dev = _state["device"] if backend() == "nccl" else torch.device("cpu")
    dist.all_reduce(torch.zeros((1,), device=dev or "cpu"))
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def monitored_run(step_fn, max_consecutive_failures: int = 1, on_failure=None):
    """Wrap a per-step callable with failure accounting: re-raises after
    ``max_consecutive_failures`` consecutive exceptions (returns None for
    the ones before)."""
    failures = {"n": 0}

    def run(*a, **kw):
        try:
            out = step_fn(*a, **kw)
            failures["n"] = 0
            return out
        except Exception:
            failures["n"] += 1
            if on_failure is not None:
                on_failure(failures["n"])
            if failures["n"] >= max_consecutive_failures:
                raise
            return None

    return run


def local_device_count() -> int:
    """The cards this process sees (0 on a CPU-only host)."""
    return torch.cuda.device_count()


def global_mesh(mesh_shape: Optional[Dict[str, int]] = None,
                hierarchical: bool = False) -> Dict[str, int]:
    """The mesh over every rank as an ordered {axis: size} (ranks in order,
    the last axis fastest). ``hierarchical`` prepends a ``host`` axis of
    the host count and divides ``dp`` by it, the (host, dp) factoring."""
    world = dist_world_size()
    mesh_shape = dict(mesh_shape or {"dp": world})
    if hierarchical:
        nh = max(1, world // max(1, get_local_world_size()))
        mesh_shape = {"host": nh, **{k: (v // nh if k == "dp" else v)
                                     for k, v in mesh_shape.items()}}
    n = 1
    for v in mesh_shape.values():
        n *= int(v)
    if n != world:
        raise ValueError(f"mesh {mesh_shape} needs {n} ranks, the world has {world}")
    return mesh_shape


def shard_batch(array, rank: Optional[int] = None, world_size: Optional[int] = None):
    """This process's rows of a global batch: rows [r*B/W, (r+1)*B/W)."""
    r = rank if rank is not None else get_rank()
    w = world_size if world_size is not None else get_world_size()
    if w <= 1:
        return array
    b = array.shape[0]
    if b % w != 0:
        raise ValueError(f"global batch {b} not divisible by {w} hosts")
    per = b // w
    return array[r * per:(r + 1) * per]


def mesh_coords(mesh_shape: Dict[str, int], rank: int) -> Dict[str, int]:
    """Rank ``rank``'s index on each axis of ``mesh_shape``: the axes in
    order, the last fastest (the JAX mesh's ``devices.reshape(sizes)``)."""
    coords = {}
    for a in reversed(list(mesh_shape)):
        n = int(mesh_shape[a])
        coords[a] = rank % n
        rank //= n
    return {a: coords[a] for a in mesh_shape}


def mesh_groups(mesh_shape: Dict[str, int], combined=()) -> dict:
    """This rank's ``AxisGroup`` of each axis of ``mesh_shape`` larger than
    1, and of each tuple of axes in ``combined`` of which more than one is
    larger than 1 (named ``"a+b"``): the ranks that
    differ from this one on those axes only. An axis that spans the world is
    the default group; every other slice is a ``torch.distributed.new_group``
    under the timeout ``init_parallel_env`` set. Every rank makes every
    group, in one order, its own or not (a group is a collective call), so
    the first call on a mesh must come on every rank; the groups are kept
    for later calls."""
    import torch.distributed as dist
    from ..ops import collective as _coll
    key = (tuple((a, int(n)) for a, n in mesh_shape.items()), tuple(map(tuple, combined)))
    got = _GROUPS.get(key)
    if got is not None:
        return got
    world, rank = dist.get_world_size(), dist.get_rank()
    axes = list(mesh_shape)
    be = str(dist.get_backend())
    timeout = datetime.timedelta(seconds=_state["timeout"])
    specs = [(a,) for a in axes if int(mesh_shape[a]) > 1]
    for c in combined:
        live = tuple(a for a in c if int(mesh_shape.get(a, 1)) > 1)
        if len(live) > 1 and live not in specs:
            specs.append(live)
    coords = [mesh_coords(mesh_shape, r) for r in range(world)]
    out: Dict[str, object] = {}
    for spec in specs:
        slices: Dict[tuple, list] = {}
        for r in range(world):
            slices.setdefault(tuple(coords[r][a] for a in axes if a not in spec), []).append(r)
        name = "+".join(spec)
        members = next(m for m in slices.values() if rank in m)
        if len(members) == world:
            out[name] = _coll.AxisGroup(name, None, world, rank, be)
            continue
        mine = None
        for k in sorted(slices):
            g = dist.new_group(slices[k], timeout=timeout)
            if rank in slices[k]:
                mine = g
        out[name] = _coll.AxisGroup(name, mine, len(members), members.index(rank), be)
    _GROUPS[key] = out
    return out
