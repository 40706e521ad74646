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
numpy bfloat16). It writes single-process saves, one chunk per variable;
sharded (multi-chunk) variables and multi-process saves raise when loaded,
and ``Checkpointer`` is not ported yet.
"""
from __future__ import annotations

import io as _pyio
import json
import os
import zlib
from typing import List, Optional

import numpy as np
import torch

from .core.executor import global_scope, tensor_from_numpy
from .framework import Parameter, Program, Variable, default_main_program

FORMAT_VERSION = 2
MANIFEST = "__manifest__.json"
MODEL = "__model__.json"


class CheckpointCorruption(RuntimeError):
    """A chunk file failed its recorded size/crc32 check."""


def _storage_view(t: torch.Tensor):
    """tensor -> (numpy array to store, dtype tag); bf16 goes as uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _save_var(dirname, name, value):
    arr, dtype = _storage_view(value if isinstance(value, torch.Tensor)
                               else tensor_from_numpy(value))
    fname = name.replace("/", "__") + ".npy"
    buf = _pyio.BytesIO()
    np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
    data = buf.getvalue()
    with open(os.path.join(dirname, fname), "wb") as f:
        f.write(data)
    return {"name": name, "dtype": dtype, "shape": list(arr.shape),
            "chunks": [{"file": fname, "index": [[0, s] for s in arr.shape],
                        "bytes": len(data), "crc32": zlib.crc32(data)}]}


def _load_var(dirname, meta) -> torch.Tensor:
    chunks = meta["chunks"]
    shape = [int(s) for s in meta["shape"]]
    if len(chunks) != 1 or chunks[0]["index"] != [[0, s] for s in shape]:
        raise NotImplementedError(
            f"variable {meta['name']!r} is stored in {len(chunks)} shard chunks; "
            f"the port reads single-chunk variables only")
    ch = chunks[0]
    path = os.path.join(dirname, ch["file"])
    with open(path, "rb") as f:
        data = f.read()
    want, crc = ch.get("bytes"), ch.get("crc32")
    if want is not None and len(data) != want:
        raise CheckpointCorruption(f"chunk {path} is {len(data)} bytes, manifest says {want}")
    if crc is not None and zlib.crc32(data) != crc:
        raise CheckpointCorruption(f"chunk {path} has crc32 {zlib.crc32(data)}, "
                                   f"manifest says {crc}")
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


def save_vars(executor, dirname, main_program=None, vars: Optional[List] = None,
              predicate=None, filename=None) -> int:
    """Save ``vars`` (or the variables of ``main_program`` that satisfy
    ``predicate``) from the global scope into ``dirname``: one ``.npy`` per
    variable and the manifest (``filename``, default ``__manifest__.json``).
    Returns the bytes of the chunks written."""
    main_program = main_program or default_main_program()
    scope = global_scope()
    os.makedirs(dirname, exist_ok=True)
    entries, nbytes = [], 0
    for _, name in _names_of(main_program, vars, predicate):
        value = scope.find_var(name)
        if value is None:
            raise RuntimeError(f"variable {name!r} has no value in scope; "
                               f"run the startup program before saving")
        entry = _save_var(dirname, name, value)
        entries.append(entry)
        nbytes += entry["chunks"][0]["bytes"]
    with open(os.path.join(dirname, filename or MANIFEST), "w") as f:
        json.dump({"vars": entries, "nranks": 1, "format_version": FORMAT_VERSION}, f)
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


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None):
    """Load ``vars`` (or the variables of ``main_program`` that satisfy
    ``predicate``) from ``dirname`` into the global scope, as CPU tensors
    (the executor moves them to its device at the next run). A variable the
    save lacks, or one whose shape differs from the program's, raises. An
    int32 variable that the program declares int64 is widened to it: the
    JAX package runs with x64 off and saves its int64 state (the schedules'
    ``@LR_DECAY_COUNTER@``) as int32."""
    main_program = main_program or default_main_program()
    path = os.path.join(dirname, filename or MANIFEST)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint manifest at {path}")
    with open(path) as f:
        head = json.load(f)
    if head.get("nranks", 1) != 1:
        raise NotImplementedError(
            f"{dirname} was saved by {head['nranks']} processes; the port reads "
            f"single-process saves only")
    metas = {m["name"]: m for m in head["vars"]}
    scope = global_scope()
    for var, name in _names_of(main_program, vars, predicate):
        if name not in metas:
            raise RuntimeError(f"checkpoint at {dirname} has no variable {name!r}")
        value = _load_var(dirname, metas[name])
        if var is not None and var.shape:
            declared = tuple(var.shape)
            if len(value.shape) != len(declared) or any(
                    d != -1 and d != s for d, s in zip(declared, value.shape)):
                raise RuntimeError(f"shape mismatch loading {name!r}: checkpoint "
                                   f"{tuple(value.shape)} vs program {declared}")
        if var is not None and var.dtype == "int64" and value.dtype == torch.int32:
            value = value.long()
        scope.set_var(name, value)


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
