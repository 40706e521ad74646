"""Host-resident embedding tables: the parameter-server analog for sparse
models whose tables outgrow the card (the port's copy of
``paddle_tpu/ops/host_table.py``; reference: the pserver distributed lookup
table, distribute_transpiler.py:1594, and the Downpour CPU workers).

The table lives in host RAM (or a disk-backed ``np.memmap``) with its own
optimizer (``sgd`` or ``adagrad``) applied on the host when the sparse row
gradients are pushed: synchronously, or on a background thread
(``async_updates=True``: a bounded queue, lock-free reads, locked updates).
The arithmetic of a push is the JAX package's: duplicate ids summed first
(``np.unique`` then ``np.add.at``), then the update.

The JAX package reaches the table from inside its compiled step through
host callbacks. On the card a callback would be a host round trip inside a
CUDA graph, so the executor runs the parameter-server schedule around the
step instead (``hoist_host_pulls``, ``run_pulls``, ``run_pushes``; the JAX
executor's hoisting, which it applies wherever it can): the pull is a host
gather whose rows enter the step as a feed (staged into the captured
graph's static input like any feed), the row gradient is one more fetch,
and the push runs on the host after the step, between replays. The pull of
step t+1 runs in ``Executor.run``, after step t's push, never on the
prefetch thread. A lookup whose ids do not come straight from a feed runs
the ops below inside the step (on the CPU, or eagerly on the card: the
executor does not capture a program that holds them).

Every table gets a [1]-float anchor parameter so that the backward pass has
a differentiable input to hang ``host_push_grad`` on; its gradient is zero.

Not ported: ``row_shard`` / ``shard_axis`` (tables partitioned across
processes: ROADMAP item 13 (d)), ``arm_publisher`` / ``export_delta`` (online
publishing: ``online/``, item 13 (d) with item 10's online part); each raises.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.registry import register, torch_dtype
from ..framework import grad_var_name
from ..observability.metrics import REGISTRY as _OBS

#: histogram of a push's parts (``np.unique``, ``np.add.at``, the update)
#: in seconds, labelled ``table`` and ``part``
PUSH_SECONDS = "host_table_push_seconds"

_ONLINE = ("online publishing (export_delta, dirty-row tracking) calls online/, "
           "which is not ported (ROADMAP item 13 (d), with item 10's online part)")
_SHARDED = ("host_lookup_table with shard_axis (a table partitioned across processes) "
            "is ROADMAP item 13 (d)")


class HostTable:
    """A host-RAM (or memmapped) embedding table with a server-side optimizer.

    The table is float32 on host regardless of the compute dtype: the push
    applies high-precision updates (the reference pserver does the same;
    bf16 grads are upcast on arrival).
    """

    def __init__(self, name: str, vocab_size: int, dim: int, *,
                 optimizer: str = "adagrad", lr: float = 0.05,
                 initializer=None, seed: int = 0, mmap_dir: Optional[str] = None,
                 async_updates: bool = False, queue_size: int = 64,
                 row_shard=None):
        if optimizer not in ("sgd", "adagrad"):
            raise ValueError(f"host table optimizer must be sgd|adagrad, "
                             f"got {optimizer!r}")
        if row_shard:
            raise NotImplementedError(
                f"host table {name!r}: row_shard partitions the table across "
                f"processes, which is ROADMAP item 13 (d)")
        self.name = name
        self.vocab_size = int(vocab_size)
        self.dim = int(dim)
        self.optimizer = optimizer
        self.lr = float(lr)
        self.mmap_dir = mmap_dir
        self._seed = seed
        self._queue_size = queue_size
        self._initializer = initializer
        self.row_shard = None
        shape = (self.vocab_size, self.dim)
        if mmap_dir is not None:
            os.makedirs(mmap_dir, exist_ok=True)
            self.table = np.lib.format.open_memmap(
                os.path.join(mmap_dir, f"{name}.table.npy"), mode="w+",
                dtype=np.float32, shape=shape)
            self._accum = np.lib.format.open_memmap(
                os.path.join(mmap_dir, f"{name}.accum.npy"), mode="w+",
                dtype=np.float32, shape=shape)
            self._accum[:] = 0.0
        else:
            self.table = np.empty(shape, np.float32)
            self._accum = np.zeros(shape, np.float32)
        rng = np.random.RandomState(seed)
        if initializer is None:
            scale = 1.0 / np.sqrt(self.dim)
            self.table[:] = rng.uniform(-scale, scale, shape).astype(np.float32)
        elif callable(initializer):
            self.table[:] = np.asarray(initializer(shape), np.float32)
        else:
            self.table[:] = np.asarray(initializer, np.float32).reshape(shape)
        self._lock = threading.Lock()
        self.push_count = 0
        self._closed = False
        self._worker_error: Optional[BaseException] = None
        self._async = bool(async_updates)
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        if self._async:
            self._queue = queue.Queue(maxsize=queue_size)
            self._worker = threading.Thread(target=self._drain, daemon=True,
                                            name=f"host_table[{name}]")
            self._worker.start()

    def _check_ids(self, ids: np.ndarray, where: str) -> np.ndarray:
        """Host-side id validation: out-of-range ids raise instead of
        silently reading or training a clamped row."""
        ids = np.asarray(ids, np.int64)
        bad = (ids < 0) | (ids >= self.vocab_size)
        if bad.any():
            examples = np.unique(ids[bad])[:8].tolist()
            raise IndexError(
                f"host table {self.name!r}: {int(bad.sum())} id(s) out of "
                f"range [0, {self.vocab_size}) in {where}, e.g. {examples} "
                f"-- check the feed's hashing/vocab")
        return ids

    # ---- pull ------------------------------------------------------------
    def gather(self, ids: np.ndarray) -> np.ndarray:
        """Lock-free read (Hogwild-style: concurrent async pushes may be
        partially visible; exact under sync mode)."""
        idx = self._check_ids(ids, "gather")
        return self.table[idx.reshape(-1)].reshape(idx.shape + (self.dim,))

    # ---- push ------------------------------------------------------------
    def push(self, ids: np.ndarray, grads: np.ndarray):
        if self._closed:
            raise RuntimeError(
                f"host table {self.name!r} is closed; no more pushes accepted")
        if self._worker_error is not None:
            raise RuntimeError(
                f"host table {self.name!r} async worker died: "
                f"{self._worker_error!r}") from self._worker_error
        if self._async:
            self._queue.put((np.asarray(ids).copy(),
                             np.asarray(grads, np.float32).copy()))
        else:
            self._apply(ids, grads)

    def _drain(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._apply(*item)
            except BaseException as e:  # poison, surface on next push/flush
                self._worker_error = e
                return
            finally:
                self._queue.task_done()

    def _drain_wait(self):
        """Wait for the queue to drain, polling worker liveness so a worker
        that dies mid-wait cannot hang the caller (queue.join() would block
        forever on the never-consumed remainder)."""
        while self._queue.unfinished_tasks:
            if self._worker_error is not None or self._worker is None \
                    or not self._worker.is_alive():
                break
            time.sleep(0.001)

    def flush(self):
        """Barrier: wait until all queued async pushes are applied."""
        if self._async:
            self._drain_wait()
        if self._worker_error is not None:
            raise RuntimeError(
                f"host table {self.name!r} async worker died: "
                f"{self._worker_error!r}") from self._worker_error

    def close(self):
        if self._async and self._worker is not None:
            self._drain_wait()
            try:  # a dead worker never drains; don't block on a full queue
                self._queue.put_nowait(None)
            except queue.Full:
                pass
            self._worker.join(timeout=5)
            self._worker = None
        self._closed = True

    def _apply(self, ids, grads):
        ids = self._check_ids(np.asarray(ids).reshape(-1), "push")
        g = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        # Duplicate ids in one minibatch sum their contributions first (the
        # SelectedRows merge-add semantic) so the update matches the dense
        # scatter-add a device-side table would apply.
        t0 = time.perf_counter()
        uniq, inv = np.unique(ids, return_inverse=True)
        t1 = time.perf_counter()
        acc = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(acc, inv, g)
        t2 = time.perf_counter()
        with self._lock:
            if self.optimizer == "adagrad":
                self._accum[uniq] += acc * acc
                self.table[uniq] -= self.lr * acc / np.sqrt(
                    self._accum[uniq] + 1e-10)
            else:
                self.table[uniq] -= self.lr * acc
            self.push_count += 1
        t3 = time.perf_counter()
        for part, a, b in (("unique", t0, t1), ("add_at", t1, t2), ("update", t2, t3)):
            _OBS.histogram(PUSH_SECONDS, "host-table push time by part", table=self.name,
                           part=part).observe(b - a)

    # ---- online publishing ------------------------------------------------
    @property
    def version(self) -> int:
        """Monotone table version: the number of applied pushes (survives
        checkpoint save/load via the npz meta)."""
        return self.push_count

    def arm_publisher(self, bound: int = 1_000_000):
        """Dirty-row tracking for online publishing: raises (``online/`` is
        not ported: ROADMAP item 13 (d))."""
        raise NotImplementedError(_ONLINE)

    def export_delta(self, since_version: int = 0, *, encoding: str = "off",
                     watermark=None, chunk_rows: int = 65536) -> dict:
        """A ``host_table_delta_v1`` doc of the rows changed since a
        version: raises (the JAX method calls ``online.delta``, which is not
        ported: ROADMAP item 13 (d))."""
        raise NotImplementedError(_ONLINE)

    # ---- persistence -----------------------------------------------------
    def _ckpt_path(self, dirname: str) -> str:
        return os.path.join(dirname, f"host_table.{self.name}.npz")

    def save(self, dirname: str):
        # snapshot consistency: flush() drains pending async pushes first
        # (a queued push applied mid-save would otherwise write a
        # half-updated row), then the apply lock is held across the whole
        # savez so no concurrent _apply can interleave table/accum/meta
        self.flush()
        os.makedirs(dirname, exist_ok=True)
        with self._lock:
            np.savez(self._ckpt_path(dirname),
                     table=np.asarray(self.table),
                     accum=np.asarray(self._accum),
                     meta=np.array([self.lr, self.push_count]))

    def load(self, dirname: str):
        data = np.load(self._ckpt_path(dirname))
        want = (self.vocab_size, self.dim)
        if data["table"].shape != want:
            raise ValueError(
                f"host table {self.name!r}: checkpoint shape "
                f"{data['table'].shape} != declared {want}")
        with self._lock:
            self.table[:] = data["table"]
            self._accum[:] = data["accum"]
            self.push_count = int(data["meta"][1])


def _same_init(a, b) -> bool:
    if a is b:
        return True
    if isinstance(a, np.ndarray) and isinstance(b, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    return False


_TABLES: Dict[str, HostTable] = {}


def create_table(name: str, vocab_size: int, dim: int, **kwargs) -> HostTable:
    """Create (or fetch, with config check) the process-global table ``name``."""
    t = _TABLES.get(name)
    if t is not None:
        if (t.vocab_size, t.dim) != (int(vocab_size), int(dim)):
            raise ValueError(
                f"host table {name!r} already exists with shape "
                f"{(t.vocab_size, t.dim)}, requested {(vocab_size, dim)}")
        existing = {"optimizer": t.optimizer, "lr": t.lr,
                    "mmap_dir": t.mmap_dir, "async_updates": t._async,
                    "seed": t._seed, "queue_size": t._queue_size,
                    "row_shard": t.row_shard}
        for k, v in kwargs.items():
            if k == "initializer":
                if v is not None and not _same_init(v, t._initializer):
                    raise ValueError(
                        f"host table {name!r} already exists with a "
                        f"different initializer; drop_table({name!r}) first "
                        f"to rebuild it (its current weights would otherwise "
                        f"silently survive)")
            elif k in existing and existing[k] != (
                    float(v) if k == "lr" else
                    (tuple(v) if k == "row_shard" and v else v)):
                raise ValueError(
                    f"host table {name!r} already exists with {k}="
                    f"{existing[k]!r}; requested {v!r}. drop_table({name!r}) "
                    f"first to rebuild it with a different config")
        return t
    t = HostTable(name, vocab_size, dim, **kwargs)
    _TABLES[name] = t
    return t


def get_table(name: str) -> HostTable:
    try:
        return _TABLES[name]
    except KeyError:
        raise KeyError(
            f"host table {name!r} does not exist in this process; create it "
            f"with layers.host_embedding(...) / host_table.create_table() "
            f"before building or deserializing the program") from None


def drop_table(name: str):
    t = _TABLES.pop(name, None)
    if t is not None:
        t.close()


def save_all(dirname: str):
    for t in _TABLES.values():
        t.save(dirname)


def load_all(dirname: str):
    for t in _TABLES.values():
        t.load(dirname)


# --------------------------------------------------------------------------
# ops (the in-step path; the executor hoists the usual case out of the step)
# --------------------------------------------------------------------------

def _host_lookup_grad_maker(op, grad_out_map):
    out_name = op.outputs["Out"][0]
    g = grad_out_map.get(out_name)
    if g is None:
        return []
    return [{"type": "host_push_grad",
             "inputs": {"Ids": list(op.inputs["Ids"]), "OutGrad": [g]},
             "outputs": {"Anchor@GRAD": [grad_var_name(op.inputs["Anchor"][0])]},
             "attrs": {"table_name": op.attrs["table_name"],
                       "shard_axis": op.attrs.get("shard_axis")}}]


def _squeezed(ids: torch.Tensor) -> torch.Tensor:
    if ids.ndim > 1 and ids.shape[-1] == 1:     # lookup_table squeeze parity
        return ids.squeeze(-1)
    return ids


def _host(x) -> np.ndarray:
    """A feed or fetch as a host array (a tensor is copied off its device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@register("host_lookup_table", grad=_host_lookup_grad_maker, nondiff_inputs=("Ids",),
          host_io=True)
def _host_lookup(ctx, ins):
    """Pull: the minibatch's rows from the host table. ``Anchor`` is not
    read; it carries the push op into the backward pass."""
    if ctx.attr("shard_axis"):
        raise NotImplementedError(_SHARDED)
    ids = _squeezed(ins["Ids"][0])
    name = ctx.attr("table_name")
    dim = get_table(name).dim
    dtype = torch_dtype(ctx.attr("dtype", "float32"))
    if ids.device.type == "meta":       # shape inference reads no values
        return {"Out": [torch.empty(tuple(ids.shape) + (dim,), dtype=dtype,
                                    device=ctx.device)]}
    rows = get_table(name).gather(_host(ids))
    return {"Out": [torch.from_numpy(rows).to(ctx.device, dtype)]}


@register("host_push_grad", grad=None, nondiff_inputs=("Ids", "OutGrad"), host_io=True)
def _host_push(ctx, ins):
    """Push: the row gradients to the host table, which applies its
    optimizer; returns the anchor's zero gradient."""
    if ctx.attr("shard_axis"):
        raise NotImplementedError(_SHARDED)
    ids, g = _squeezed(ins["Ids"][0]), ins["OutGrad"][0]
    name = ctx.attr("table_name")
    table = get_table(name)
    if ids.device.type != "meta":
        table.push(_host(ids), _host(g.float()))
    return {"Anchor@GRAD": [torch.zeros((1,), dtype=torch.float32, device=ctx.device)]}


# --------------------------------------------------------------------------
# the parameter-server schedule around the step
# --------------------------------------------------------------------------

def hoist_host_pulls(program):
    """Rewrite eligible host-table ops out of the step: the pull becomes a
    host gather whose rows enter as a feed, the push a fetch of the row
    gradients applied to the table after the step -- the reference PS
    schedule (pull -> device step -> push, distribute_transpiler.py:1594),
    with no host round trip inside the step, so the step is one CUDA graph.

    Eligible: lookups whose Ids come straight from a feed (the CTR DataFeed
    pattern). Others keep the in-step lowering, which the executor does not
    capture.

    Returns (program_copy, pulls, pushes) -- or (program, [], []) when
    nothing is eligible. pulls: [(table, ids_feed, out_var)];
    pushes: [(table, ids_feed, grad_var, anchor_grad_var)].
    """
    from ..framework import Program

    if not any(op.type == "host_lookup_table"
               for op in program.global_block().ops):
        return program, [], []

    p2 = Program.from_dict(program.to_dict())
    b2 = p2.global_block()
    pulls, pushes, drop = [], [], set()
    # single eligibility filter, applied once over the copy (op order is
    # preserved by the dict round-trip)
    for op in list(b2.ops):
        if op.type == "host_lookup_table" and not op.attr("shard_axis",
                                                          None):
            ids_name = op.inputs["Ids"][0]
            iv = b2.find_var_recursive(ids_name)
            if iv is None or not iv.is_data:
                continue
            out = op.outputs["Out"][0]
            b2.find_var_recursive(out).is_data = True
            pulls.append((op.attr("table_name"), ids_name, out))
            drop.add(id(op))
    if not pulls:
        return program, [], []
    pull_keys = {(t, i) for t, i, _ in pulls}
    for idx, op in enumerate(list(b2.ops)):
        if op.type == "host_push_grad":
            key = (op.attr("table_name"), op.inputs["Ids"][0])
            if key not in pull_keys:
                continue
            anchor_grad = op.outputs["Anchor@GRAD"][0]
            pushes.append((op.attr("table_name"), op.inputs["Ids"][0],
                           op.inputs["OutGrad"][0], anchor_grad))
            drop.add(id(op))
            # the anchor's optimizer update still consumes Anchor@GRAD:
            # it is identically zero (the anchor never receives real
            # gradient), so materialize the zeros the push op used to emit
            av = b2.find_var_recursive(anchor_grad[:-5])
            zop = type(op)(
                b2, "fill_constant", inputs={},
                outputs={"Out": [anchor_grad]},
                attrs={"shape": list(av.shape) if av is not None else [1],
                       "dtype": "float32", "value": 0.0})
            b2.ops[idx] = zop
            drop.discard(id(zop))
    b2.ops = [o for o in b2.ops if id(o) not in drop]
    return p2, pulls, pushes


def run_pulls(pulls, feed):
    """Host gathers for hoisted pulls: extend ``feed`` with the rows. The ids
    may be numpy arrays or tensors (a tensor on the card is copied off)."""
    for table_name, ids_name, out_name in pulls:
        if ids_name not in feed:
            raise KeyError(
                f"host_lookup_table over {table_name!r}: hoisted pull needs "
                f"ids {ids_name!r} in the feed. If this is an eval-style "
                f"run that only fetches a sub-graph not using this lookup, "
                f"pass use_prune=True to Executor.run so unused pulls are "
                f"pruned away instead of demanding their ids; otherwise "
                f"feed {ids_name!r}.")
        ids = _host(feed[ids_name])
        if ids.ndim > 1 and ids.shape[-1] == 1:
            ids = ids[..., 0]            # lookup_table squeeze parity
        feed[out_name] = get_table(table_name).gather(ids)
    return feed


def run_pushes(pushes, fetched):
    """Apply hoisted pushes: ``fetched`` maps the ids feed and each grad var
    to its value (numpy or tensor)."""
    for table_name, ids_name, grad_name, _ in pushes:
        g = fetched.get(grad_name)
        if g is None:
            continue   # the lookup's output had no gradient this run (eval)
        get_table(table_name).push(_host(fetched[ids_name]), _host(g))
