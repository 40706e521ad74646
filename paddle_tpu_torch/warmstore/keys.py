"""Content-addressed keying for the warm store (the port's copy of
``paddle_tpu/warmstore/keys.py``).

An entry is reusable only when everything that shaped the step is
identical: the program's serialized content (not its ``id()``: that is
what makes entries cross-process), the feed signature, the fetch list, the
seed, the executor's flags, the strategy slot, the autotuner's decisions,
the build (torch, CUDA, ``nvcc``, the driver), the device, and, for a
world-dependent program only, the process and device topology. The key is
a flat JSON-able dict; the sha256 of its canonical JSON is the entry's
directory name, the digest the JAX package computes for the same dict.

The port's data parallel (ROADMAP item 13 (a)) runs one process a rank, each
step a rank's own program, so its executor and Predictor always key
``{"scope": "local"}``: the step is the same at any world size. ``topology(True)`` is kept for the day a
strategy bakes the world into a step.
"""
from __future__ import annotations

import functools
import hashlib
import json
import subprocess
from typing import Optional

#: bump when the key derivation changes incompatibly: old entries simply stop
#: matching (the store is a cache, never a source of truth)
KEY_FORMAT = 1


def canonical(key: dict) -> str:
    """Deterministic JSON for a key dict (sorted keys, no whitespace): the
    digest input."""
    return json.dumps(key, sort_keys=True, separators=(",", ":"))


def digest(key: dict) -> str:
    return hashlib.sha256(canonical(key).encode("utf-8")).hexdigest()[:32]


def program_digest(program) -> str:
    """sha256 of the program's serialized content, memoized per
    ``(identity, _version)`` on the Program itself, so repeated misses of
    one program pay the JSON walk once."""
    version = getattr(program, "_version", 0)
    memo = getattr(program, "_warmstore_digest", None)
    if memo is not None and memo[0] == version:
        return memo[1]
    d = hashlib.sha256(program.to_json().encode("utf-8")).hexdigest()[:32]
    program._warmstore_digest = (version, d)
    return d


def tuning_fingerprint() -> list:
    """The cross-process form of ``tuning.state_token()``: the in-process
    epoch means nothing to another process, so the store keys on (mode,
    digest of the decision records); two processes that share one autotune
    cache derive the same fingerprint."""
    from ..tuning import cache as _tc
    m = _tc.mode()
    if m == "off":
        return [m, ""]
    items = _tc.CACHE.items()
    if not items:
        return [m, ""]
    blob = json.dumps({k: v.get("winner") for k, v in sorted(items.items())},
                      sort_keys=True, separators=(",", ":"), default=str)
    return [m, hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]]


@functools.lru_cache(maxsize=None)
def nvcc_release() -> str:
    """The last line of ``nvcc --version`` ("" without ``nvcc``)."""
    from ..core import cuda_build
    try:
        out = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return ""
    lines = out.strip().splitlines()
    return lines[-1] if lines else ""


@functools.lru_cache(maxsize=None)
def versions() -> dict:
    """The build a step's device code depends on: torch, its CUDA, the
    ``nvcc`` that compiles the kernels and the driver that loads them."""
    import torch
    driver = ""
    if torch.cuda.is_available():
        get = getattr(torch._C, "_cuda_getDriverVersion", None)
        driver = str(get()) if get is not None else ""
    return {"torch": torch.__version__, "cuda": str(torch.version.cuda or ""),
            "nvcc": nvcc_release() if torch.cuda.is_available() else "", "driver": driver}


def device_kind(device=None) -> str:
    """``cpu`` for a CPU device; else the card's name and compute capability
    (``NVIDIA H100 80GB HBM3 sm_90``). None: the card when there is one."""
    import torch
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return "cpu"
    major, minor = torch.cuda.get_device_capability(dev)
    return f"{torch.cuda.get_device_name(dev)} sm_{major}{minor}"


def topology(world_dependent: bool) -> dict:
    """The world part of a key: local programs are the same step at any
    fleet size; a world-dependent one carries the process and device counts."""
    if not world_dependent:
        return {"scope": "local"}
    import torch
    import torch.distributed as dist
    processes = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return {"scope": "world", "processes": processes,
            "devices": torch.cuda.device_count()}


def build_key(kind: str, program, *, feed_sig, fetch_names, seed, flags, strategy,
              world_dependent: bool, device=None, extra: Optional[dict] = None) -> dict:
    """The full entry key of one step. ``kind`` is ``train_step`` /
    ``fused_step`` / ``predict``; ``flags`` and ``strategy`` are repr'd (their
    tuples are content-based and repr-stable across processes); ``device`` is
    the executor's or the Predictor's."""
    key = {"format": KEY_FORMAT, "kind": kind,
           "program": program_digest(program),
           "feed_sig": repr(feed_sig), "fetch": list(map(str, fetch_names)),
           "seed": int(seed), "flags": repr(flags),
           "strategy": repr(strategy),
           "tuning": tuning_fingerprint(),
           "device_kind": device_kind(device),
           "topology": topology(world_dependent)}
    key.update(versions())
    if extra:
        key.update(extra)
    return key


def library_key(filename: str) -> dict:
    """The key of one kernel library, ``lib<name>-<source digest>.so``
    (``cuda_build.library_path``): its content address is the file name,
    which hashes the source, the shared headers and the target flags, under
    the build that compiled it. Steps that launch one kernel share its entry."""
    key = {"format": KEY_FORMAT, "kind": "library", "library": str(filename),
           "device_kind": device_kind()}
    key.update(versions())
    return key
