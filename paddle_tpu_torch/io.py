"""Saving and loading variables and inference models (the port's copy of
``save_vars`` / ``save_params`` / ``save_persistables``, their ``load_*``
counterparts and ``save_inference_model`` / ``load_inference_model`` of
``paddle_tpu/io.py``).

The on-disk format is the JAX package's, so a directory saved by either
package loads in the other:

* ``__model__.json``: ``{"program": Program.to_dict(), "feed_names": [...],
  "fetch_names": [...]}``;
* ``__manifest__.json``: ``{"vars": [...], "nranks": 1, "format_version": 2}``,
  one entry per variable with its dtype, shape and chunks, each chunk
  carrying the ``bytes`` and ``crc32`` of its serialized ``.npy``;
* one ``.npy`` chunk per variable. bfloat16 is stored as its uint16 bits
  with a ``"bfloat16"`` dtype tag.

``save_persistables`` writes what resuming a training needs (parameters,
optimizer moments and counters, metric state); ``filename`` names the
manifest. The port reads and writes bf16 by reinterpreting bits in torch (no
numpy bfloat16). One process writes one chunk per variable.

Under a process group of several ranks (data parallel, ``compiler.py``) a
save is the JAX package's multi-process layout: rank 0 writes the
replicated variables and ``__manifest__.json`` with ``nranks``, and every
rank writes its own blocks of the ZeRO-sharded state (a scope value whose
shape is its declared one split over the ranks on one dim), each a chunk
with its region of the global shape, listed in rank ``r``'s
``__manifest__.json.rank<r>``; the ranks then meet at a barrier. A load at
the same world size reads the replicated variables and this rank's blocks;
a single-process save loads whole on every rank (the executor splits the
ZeRO state at its next run). Loading a multi-process save at another world
size (resharding) is ROADMAP item 13 (c) and raises.

A load writes into the tensor the scope already holds under a name, in place,
when its shape and dtype match (the executor's captured CUDA graphs read the
scope's tensors at fixed addresses, so a restore costs no recapture); any
other value is bound as a CPU tensor that the executor moves to its device
at the next run.

``snapshot_persistables`` and ``write_snapshot`` split a save in two for
``utils/checkpointer.py``'s async saves: the copy to the host in the
caller's thread, the writing on another. ``verify_checkpoint`` checks a
directory's chunks against the manifest's sizes and crc32s.
"""
from __future__ import annotations

import io as _pyio
import json
import os
import zlib
from typing import List, Optional

import numpy as np
import torch

from .core.executor import assign_state, global_scope, tensor_from_numpy
# Executor / Scope are re-exported: fluid code reaches them as fluid.io.Executor
# and fluid.io.Scope, as in the JAX package
from .core.executor import Executor, Scope  # noqa: F401
from .framework import Parameter, Program, Variable, default_main_program
from .utils import fs as _fsio

FORMAT_VERSION = 2
MANIFEST = "__manifest__.json"
MODEL = "__model__.json"


class CheckpointCorruption(RuntimeError):
    """A chunk file failed its recorded size/crc32 check; ``kind`` is
    ``size`` or ``crc``."""

    def __init__(self, msg: str, kind: str = "crc", path: str = ""):
        super().__init__(msg)
        self.kind = kind
        self.path = path


def _storage_view(t: torch.Tensor, copy: bool = False):
    """tensor -> (numpy array to store, dtype tag); bf16 goes as uint16 bits.
    ``copy``: the array never shares memory with ``t`` (a CPU tensor that a
    later step updates in place)."""
    t = t.detach()
    t = t.clone() if copy and t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _snapshot_var(name, value, copy: bool = True):
    """Phase 1 of a save: the host copy of one variable, as a manifest entry
    whose one chunk carries its array (``data``). ``copy=False`` lets the
    array share a CPU tensor's memory (a save that writes it at once)."""
    arr, dtype = _storage_view(value if isinstance(value, torch.Tensor)
                               else tensor_from_numpy(value), copy=copy)
    return {"name": name, "dtype": dtype, "shape": list(arr.shape),
            "chunks": [{"file": name.replace("/", "__") + ".npy", "data": arr,
                        "index": [[0, s] for s in arr.shape]}]}


def _write_snap(dirname, snap):
    """Phase 2 of a save: write a snapshot entry's chunk, recording the byte
    size and crc32 of the serialized ``.npy``. Returns (manifest entry,
    bytes written)."""
    chunks, nbytes = [], 0
    for ch in snap["chunks"]:
        buf = _pyio.BytesIO()
        np.save(buf, np.ascontiguousarray(ch["data"]), allow_pickle=False)
        data = buf.getvalue()
        _fsio.write_bytes(_fsio.join(dirname, ch["file"]), data)
        chunks.append({"file": ch["file"], "index": ch["index"],
                       "bytes": len(data), "crc32": zlib.crc32(data)})
        nbytes += len(data)
    entry = {k: v for k, v in snap.items() if k != "chunks"}
    entry["chunks"] = chunks
    return entry, nbytes


def _save_var(dirname, name, value):
    return _write_snap(dirname, _snapshot_var(name, value, copy=False))[0]


def _verify_on_load() -> bool:
    """Check each chunk's size and crc32 against the manifest on load? On by
    default; ``PADDLE_TPU_CKPT_VERIFY=0`` turns it off, as in the JAX
    package. A value other than a 0/1 toggle raises."""
    from .observability.journal import mode_env
    return mode_env("PADDLE_TPU_CKPT_VERIFY", modes=("off", "on"),
                    default="on", truthy="on") == "on"


def _load_var(dirname, meta) -> torch.Tensor:
    """One variable's chunk: the whole variable, or (a multi-process save)
    this rank's block of it."""
    chunks = meta["chunks"]
    if len(chunks) != 1:
        raise NotImplementedError(
            f"variable {meta['name']!r} is stored in {len(chunks)} shard chunks in one "
            f"manifest; the port reads one chunk a variable a rank")
    ch = chunks[0]
    shape = [int(b) - int(a) for a, b in ch["index"]]
    path = os.path.join(dirname, ch["file"])
    with open(path, "rb") as f:
        data = f.read()
    want, crc = ch.get("bytes"), ch.get("crc32")
    if not _verify_on_load():
        want = crc = None
    kind = None
    if want is not None and len(data) != want:
        kind, detail = "size", f"{len(data)} bytes, manifest says {want}"
    elif crc is not None and zlib.crc32(data) != crc:
        kind, detail = "crc", f"crc32 {zlib.crc32(data)}, manifest says {crc}"
    if kind is not None:
        from .observability import journal
        from .observability.metrics import REGISTRY
        REGISTRY.counter("checkpoint_corruption_total",
                         "corrupt checkpoint chunks detected, by kind", kind=kind).inc()
        journal.emit({"event": "ckpt_corrupt", "kind": kind, "file": str(path),
                      "var": meta["name"], "detail": detail})
        raise CheckpointCorruption(f"checkpoint chunk {path} for var {meta['name']!r} is "
                                   f"corrupt ({detail}); refusing to restore it",
                                   kind=kind, path=str(path))
    arr = np.load(_pyio.BytesIO(data), allow_pickle=False)
    if list(arr.shape) != shape:
        raise CheckpointCorruption(f"chunk {path} holds shape {list(arr.shape)}, "
                                   f"manifest says {shape}")
    return tensor_from_numpy(arr, meta["dtype"])


def _names_of(main_program, vars, predicate):
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate is None or predicate(v)]
    return [(v if isinstance(v, Variable) else None,
             v.name if isinstance(v, Variable) else str(v)) for v in vars]


def _world():
    """(world size, rank) of the default process group, (1, 0) without one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _program_of(p):
    """The Program of ``p`` (a ``CompiledProgram`` passes its own)."""
    return getattr(p, "program", p) if not isinstance(p, Program) else p


def _block_region(var, value, world: int, rank: int):
    """This rank's region of ``var``'s global shape when ``value`` is its
    block (one dim split over the ranks), else None (the whole variable)."""
    if var is None or world <= 1 or not var.shape:
        return None
    shape, got = tuple(var.shape), tuple(value.shape)
    if got == shape or len(got) != len(shape):
        return None
    diff = [d for d, (a, b) in enumerate(zip(shape, got)) if a != b]
    if len(diff) != 1 or got[diff[0]] * world != shape[diff[0]]:
        raise RuntimeError(f"variable {var.name!r} holds shape {got}, neither its "
                           f"declared {shape} nor a block of it over {world} ranks")
    d, per = diff[0], got[diff[0]]
    return [[rank * per, (rank + 1) * per] if i == d else [0, s]
            for i, s in enumerate(shape)]


def _rank_manifest(base: str, rank: int) -> str:
    return base if rank == 0 else f"{base}.rank{rank}"


def save_vars(executor, dirname, main_program=None, vars: Optional[List] = None,
              predicate=None, filename=None) -> int:
    """Save ``vars`` (or the variables of ``main_program`` that satisfy
    ``predicate``) from the global scope into ``dirname``: one ``.npy`` per
    variable and the manifest (``filename``, default ``__manifest__.json``);
    under several ranks the multi-process layout (module docstring). Returns
    the bytes of the chunks this process wrote."""
    main_program = _program_of(main_program or default_main_program())
    scope = global_scope()
    world, rank = _world()
    os.makedirs(dirname, exist_ok=True)
    entries, nbytes = [], 0
    for var, name in _names_of(main_program, vars, predicate):
        value = scope.find_var(name)
        if value is None:
            raise RuntimeError(f"variable {name!r} has no value in scope; "
                               f"run the startup program before saving")
        region = _block_region(var or main_program.global_block().find_var_recursive(name),
                               value, world, rank)
        if region is None and rank != 0:
            continue   # replicated: rank 0 writes it
        snap = _snapshot_var(name, value, copy=False)
        if region is not None:
            snap["shape"] = list((var or main_program.global_block()
                                  .find_var_recursive(name)).shape)
            snap["chunks"][0]["file"] = f"{name.replace('/', '__')}.rank{rank}.npy"
            snap["chunks"][0]["index"] = region
        entry, n = _write_snap(dirname, snap)
        entries.append(entry)
        nbytes += n
    with open(_rank_manifest(os.path.join(dirname, filename or MANIFEST), rank), "w") as f:
        json.dump({"vars": entries, "nranks": world, "format_version": FORMAT_VERSION}, f)
    if world > 1:
        from .parallel import env as _penv
        _penv.barrier("save_vars")
    return nbytes


def _is_param(v):
    return isinstance(v, Parameter)


def _is_persistable(v):
    # a comm error-feedback residual (the JAX package's comm/compress.py) is
    # per-device advisory state, never saved
    return v.persistable and not v.is_data and not v.name.endswith("@comm_residual")


def save_params(executor, dirname, main_program=None, filename=None) -> int:
    """The parameters only (no optimizer state)."""
    return save_vars(executor, dirname, main_program, predicate=_is_param, filename=filename)


def save_persistables(executor, dirname, main_program=None, filename=None) -> int:
    """Everything resuming a training needs: parameters, optimizer moments
    and counters, metric state."""
    return save_vars(executor, dirname, main_program, predicate=_is_persistable,
                     filename=filename)


def snapshot_persistables(main_program=None, scope=None) -> dict:
    """Phase 1 of an async checkpoint save: host copies of every persistable
    variable of ``main_program`` in ``scope`` (default the global one),
    taken in the calling thread (a tensor on the card is copied after the
    work queued before it). The copies share no memory with the scope, so
    the next step's in-place update does not reach them. Returns an opaque
    snapshot for :func:`write_snapshot`."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    entries = []
    for v in main_program.list_vars():
        if not _is_persistable(v):
            continue
        value = scope.find_var(v.name)
        if value is None:
            raise RuntimeError(f"variable {v.name!r} has no value in scope; "
                               f"run the startup program before saving")
        entries.append(_snapshot_var(v.name, value))
    return {"rank": 0, "nranks": 1, "entries": entries}


def write_snapshot(snapshot, dirname, filename=None) -> int:
    """Phase 2 of an async checkpoint save: write a
    :func:`snapshot_persistables` snapshot's chunks and manifest into
    ``dirname`` (host work only: no tensor is touched). Returns the chunk
    bytes written."""
    _fsio.makedirs(dirname, exist_ok=True)
    manifest, nbytes = [], 0
    for snap in snapshot["entries"]:
        entry, n = _write_snap(dirname, snap)
        manifest.append(entry)
        nbytes += n
    with _fsio.open_file(_fsio.join(dirname, filename or MANIFEST), "w") as f:
        json.dump({"vars": manifest, "nranks": snapshot["nranks"],
                   "format_version": FORMAT_VERSION}, f)
    return nbytes


def _read_manifest_docs(dirname, filename):
    """All rank manifests of one checkpoint: (head, [(rank, doc), ...])."""
    base = _fsio.join(dirname, filename or MANIFEST)
    if not _fsio.exists(base):
        raise FileNotFoundError(f"no checkpoint manifest at {base}")
    with _fsio.open_file(base) as f:
        head = json.load(f)
    docs = []
    for r in range(head.get("nranks", 1)):
        p = base if r == 0 else f"{base}.rank{r}"
        if not _fsio.exists(p):
            raise FileNotFoundError(
                f"checkpoint at {dirname} was saved by {head.get('nranks')} processes "
                f"but rank {r}'s manifest {p} is missing")
        with _fsio.open_file(p) as f:
            docs.append((r, head if r == 0 else json.load(f)))
    return head, docs


def verify_checkpoint(dirname, filename=None, level: str = "crc") -> dict:
    """Integrity report for one checkpoint directory, saved by either
    package. ``level="size"`` checks that every chunk the manifests list
    exists at its recorded byte size; ``level="crc"`` reads each and checks
    its crc32 too. Never raises: a manifest that does not parse becomes a
    ``manifest`` entry. Per-chunk ``status``: ``ok``, ``missing``,
    ``size_mismatch``, ``crc_mismatch`` or ``unverified`` (a pre-v2
    manifest without sizes, counted as passing). ``ok`` is the verdict
    ``Checkpointer`` trusts."""
    if level not in ("size", "crc"):
        raise ValueError(f"level must be 'size' or 'crc', got {level!r}")
    report = {"dir": str(dirname), "level": level, "ok": True,
              "format_version": None, "nranks": None, "chunks": []}

    def bad(status, **kw):
        report["ok"] = False
        report["chunks"].append(dict(status=status, **kw))

    try:
        head, docs = _read_manifest_docs(dirname, filename)
    except (OSError, ValueError, KeyError, TypeError) as e:
        bad("manifest", rank=None, var=None, file=None, detail=f"{type(e).__name__}: {e}")
        return report
    report["format_version"] = head.get("format_version", 1)
    report["nranks"] = head.get("nranks", 1)
    for rank, doc in docs:
        try:
            recs = [({"rank": rank, "var": m.get("name"), "file": ch["file"]}, ch)
                    for m in doc["vars"] for ch in (m.get("chunks") or [])]
        except (KeyError, TypeError, AttributeError) as e:
            bad("manifest", rank=rank, var=None, file=None,
                detail=f"{type(e).__name__}: {e}")
            continue
        for rec, ch in recs:
            path = _fsio.join(dirname, ch["file"])
            try:
                if not _fsio.exists(path):
                    bad("missing", detail="chunk file missing", **rec)
                    continue
                want = ch.get("bytes")
                if want is None:
                    report["chunks"].append(dict(
                        status="unverified", detail="pre-v2 manifest: no recorded "
                                                    "size/crc", **rec))
                    continue
                if level == "size":
                    got = _fsio.file_size(path)
                    if got is not None and got != want:
                        bad("size_mismatch", detail=f"{got} bytes, manifest says {want}",
                            **rec)
                        continue
                else:
                    data = _fsio.read_bytes(path)
                    if len(data) != want:
                        bad("size_mismatch",
                            detail=f"{len(data)} bytes, manifest says {want}", **rec)
                        continue
                    crc = ch.get("crc32")
                    if crc is not None and zlib.crc32(data) != crc:
                        bad("crc_mismatch",
                            detail=f"crc32 {zlib.crc32(data)}, manifest says {crc}", **rec)
                        continue
            except (OSError, TypeError, ValueError) as e:
                bad("missing", detail=f"{type(e).__name__}: {e}", **rec)
                continue
            report["chunks"].append(dict(status="ok", **rec))
    return report


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Load ``vars`` (or the variables of ``main_program`` that satisfy
    ``predicate``) from ``dirname`` into the global scope: in place into
    the tensor it holds when shape and dtype match, else as a CPU tensor
    (the executor moves it to its device at the next run). A variable the
    save lacks, or one whose shape differs from the program's, raises. An
    int32 variable that the program declares int64 is widened to it: the
    JAX package runs with x64 off and saves its int64 state (the schedules'
    ``@LR_DECAY_COUNTER@``) as int32."""
    main_program = _program_of(main_program or default_main_program())
    path = os.path.join(dirname, filename or MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint manifest at {path}")
    with open(path) as f:
        head = json.load(f)
    metas = {m["name"]: m for m in head["vars"]}
    saved = head.get("nranks", 1)
    if saved != 1:
        world, rank = _world()
        if saved != world:
            raise NotImplementedError(
                f"{dirname} was saved by {saved} processes and this job has {world}: "
                f"resharding a checkpoint to another world size is ROADMAP item 13 (c)")
        if rank != 0:
            with open(_rank_manifest(path, rank)) as f:
                metas.update({m["name"]: m for m in json.load(f)["vars"]})
    scope = global_scope()
    for var, name in _names_of(main_program, vars, predicate):
        if name not in metas:
            raise RuntimeError(f"checkpoint at {dirname} has no variable {name!r}")
        value = _load_var(dirname, metas[name])
        # a block of a sharded variable has the block's shape, not the declared one
        block = [list(map(int, r)) for r in metas[name]["chunks"][0]["index"]] \
            != [[0, int(s)] for s in metas[name]["shape"]]
        if not block and var is not None and var.shape:
            declared = tuple(var.shape)
            if len(value.shape) != len(declared) or any(
                    d != -1 and d != s for d, s in zip(declared, value.shape)):
                raise RuntimeError(f"shape mismatch loading {name!r}: checkpoint "
                                   f"{tuple(value.shape)} vs program {declared}")
        if var is not None and var.dtype == "int64" and value.dtype == torch.int32:
            value = value.long()
        assign_state(scope, name, value)


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_param, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=_is_persistable, filename=filename)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True):
    """Prune ``main_program`` to the inference subgraph (``is_test`` set) and
    save it with its parameters from the global scope. Returns the target
    var names."""
    main_program = main_program or default_main_program()
    target_names = [t.name if isinstance(t, Variable) else str(t) for t in target_vars]
    pruned = main_program._prune(feeded_var_names, target_names, for_test=True)
    os.makedirs(dirname, exist_ok=True)
    model = {"program": pruned.to_dict(), "feed_names": list(feeded_var_names),
             "fetch_names": target_names}
    with open(os.path.join(dirname, model_filename or MODEL), "w") as f:
        json.dump(model, f)
    scope = global_scope()
    gvars = main_program.global_block().vars
    entries = []
    for v in pruned.list_vars():
        if not (isinstance(gvars.get(v.name), Parameter) or (v.persistable and not v.is_data)):
            continue
        value = scope.find_var(v.name)
        if value is None:
            raise RuntimeError(f"variable {v.name!r} has no value in scope; "
                               f"run the startup program before saving")
        entries.append(_save_var(dirname, v.name, value))
    with open(os.path.join(dirname, params_filename or MANIFEST), "w") as f:
        json.dump({"vars": entries, "nranks": 1, "format_version": FORMAT_VERSION}, f)
    return target_names


def load_inference_model(dirname, executor, model_filename=None, params_filename=None):
    """Load a saved inference model; its parameters go into the global scope
    as CPU tensors. Returns (program, feed_names, fetch_names)."""
    with open(os.path.join(dirname, model_filename or MODEL)) as f:
        model = json.load(f)
    program = Program.from_dict(model["program"])
    with open(os.path.join(dirname, params_filename or MANIFEST)) as f:
        head = json.load(f)
    if head.get("nranks", 1) != 1:
        raise NotImplementedError(
            f"{dirname} was saved by {head['nranks']} processes; the port reads "
            f"single-process saves only")
    scope = global_scope()
    for meta in head["vars"]:
        scope.set_var(meta["name"], _load_var(dirname, meta))
    return program, model["feed_names"], model["fetch_names"]
