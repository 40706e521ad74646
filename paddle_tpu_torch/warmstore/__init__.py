"""The warm store: what a restarted process can reuse of a step it ran
before (ROADMAP item 12 (b)), the port's counterpart of
``paddle_tpu/warmstore/``.

Armed by pointing ``PADDLE_TPU_WARMSTORE`` at a directory; unset means
disarmed. The call sites (the executor, the Predictor, the serving pool's
warm-up, ``core/cuda_build.py``) read the variable before they import this
package, so a disarmed process never imports it, opens a file, starts a
thread or spawns a probe.

The JAX store keeps a step's compiled XLA executable (tier A) and its
StableHLO (tier B). Neither exists on the card, and a CUDA graph cannot be
saved. What a restart can reuse there is the step's compiled device code.
So the tiers are:

- **Tier A: the step's kernel libraries.** The ``nvcc`` output of each
  kernel the step launched (``cuda_build.library_path``:
  ``lib<name>-<source digest>.so``), one entry per library, keyed by its
  file name and the build, so steps share them. A library is loaded only
  under a passing probe verdict (``probe.py``), after its checksum, and one
  that fails either, or ``dlopen``, is quarantined and the kernel is built
  by ``nvcc`` from the checkout's sources: never the plain version.
- **Tier B: the portable record** of each step (``train_step``,
  ``fused_step``, ``predict``): its key, the kernels it launched with their
  source digests, and its capture's parts (graph pool and argument bytes).
  It is safe on every build. On a hit, the step's kernels are made ready
  together before its first run (``cuda_build.build``: restored from tier
  A, or all compiled at once), not one by one at their first launches.

**The CUDA graph is captured in every process.** A hit skips neither the
verifier gate (``PADDLE_TPU_VALIDATE``, checked before the store is
consulted) nor the warm-up and the capture of the step's graph: what it
saves is the ``nvcc`` time of the step's kernels.

Layout and write discipline: ``store.py``; keying: ``keys.py``; the CLI
(``python -m paddle_tpu_torch.warmstore``): ``__main__.py``.
"""
from __future__ import annotations

import os
import threading
from typing import Optional

from .keys import build_key, digest, program_digest  # noqa: F401
from .store import Hit, WarmStore  # noqa: F401

ENV = "PADDLE_TPU_WARMSTORE"

_lock = threading.Lock()
_store: Optional[WarmStore] = None
_store_root: Optional[str] = None


def enabled() -> bool:
    return bool(os.environ.get(ENV))


def root() -> Optional[str]:
    return os.environ.get(ENV) or None


def active_store() -> Optional[WarmStore]:
    """The process's store for the armed root, or None when disarmed.
    Re-pointing the variable (tests) swaps the instance."""
    global _store, _store_root
    r = root()
    if not r:
        return None
    with _lock:
        if _store is None or _store_root != r:
            if _store is not None:
                _store.close()
            _store = WarmStore(r)
            _store_root = r
        return _store


def prefetch() -> int:
    """The one startup scan (the executor's first miss, the pool's warm-up):
    the stored steps' kernels made ready together. Disarmed: returns 0."""
    s = active_store()
    return s.prefetch() if s is not None else 0


def flush(timeout: float = 30.0) -> bool:
    s = active_store()
    return True if s is None else s.flush(timeout)


def reset_for_tests():
    global _store, _store_root
    from . import probe as _probe
    with _lock:
        if _store is not None:
            _store.close()
        _store = None
        _store_root = None
    _probe.reset_for_tests()


# -- the step hooks (the executor's and the Predictor's misses) ---------------


def consult_step(key: dict):
    """At a signature's miss, after the verifier gate: look the step up and,
    on a hit, make its kernels ready together (``cuda_build.build``: tier A
    restores, else ``nvcc``). Returns the handle ``offer_step`` takes after
    the capture, or None when disarmed. The capture runs either way."""
    import time
    from ..core import cuda_build
    from ..observability.metrics import REGISTRY
    s = active_store()
    if s is None:
        return None
    before = dict(cuda_build.load_counts)
    hit = s.consult(key)
    if hit is not None and hit.kernels:
        t0 = time.perf_counter()
        cuda_build.build(hit.kernels)
        REGISTRY.histogram("warmstore_restore_seconds",
                           "warm-store restore wall time per miss").observe(
            time.perf_counter() - t0)
    return s, key, before


def offer_step(handle, parts: Optional[dict] = None) -> bool:
    """After the capture (on the CPU, after the first run): queue the step's
    record, with the kernels whose libraries its warm-up and capture loaded
    and the capture's ``parts``. The write runs on the store's writer thread."""
    from ..core import cuda_build
    store, key, before = handle
    kernels = []
    for name in sorted(cuda_build.load_counts):
        if cuda_build.load_counts[name] != before.get(name, 0):
            lib = cuda_build.library_path(name).name
            kernels.append({"name": name, "library": lib,
                            "digest": lib[:-len(".so")].rsplit("-", 1)[1]})
    return store.offer(key, {"kernels": kernels, "capture": dict(parts or {})})
