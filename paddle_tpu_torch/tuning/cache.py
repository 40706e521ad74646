"""Decision cache for the empirical autotuner: in-memory + on-disk (the
port's copy of ``paddle_tpu/tuning/cache.py``).

A *decision* is the persisted outcome of one autotune search: for a
``(choice-point id, shape bucket, dtype, card name, torch/CUDA version)``
key it records the winning candidate and the timings that elected it. The
cache has two layers:

- an in-process dict (always consulted first -- a warm ``decide()`` is one
  dict lookup, no I/O, no device work);
- a versioned JSON file, loaded lazily ONCE per process and written
  atomically (temp + ``utils/fs.py`` replace) after every search, so offline
  pre-tuning (``python -m paddle_tpu_torch.tuning``) and training runs share
  decisions across processes.

The runtime gate is ``PADDLE_TPU_TUNE=off|cached|search`` (default
``cached``):

- ``off``     -- choice points answer with their static-heuristic default;
                 the cache file is never read.
- ``cached``  -- persisted decisions are used when present, the default
                 otherwise; no measurement work ever happens.
- ``search``  -- a cache miss triggers measurement of every candidate when
                 a lowering first asks (an executor's or a Predictor's
                 eager warm-up run) and persists the winner.

Toggle spellings follow the shared observability convention
(``journal.TRUTHY``/``FALSY``): 1/true/yes/on mean ``search``,
0/false/no/empty mean ``off``; unknown spellings raise instead of silently
degrading.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional

from ..observability import journal as _journal
from ..utils import fs as _fsio

#: bump when the key derivation or record layout changes incompatibly; a
#: file with another version is ignored (warn once), never half-parsed
FORMAT_VERSION = 1

_ENV_MODE = "PADDLE_TPU_TUNE"
_ENV_CACHE = "PADDLE_TPU_TUNE_CACHE"
_MODES = ("off", "cached", "search")


def mode() -> str:
    """Parse PADDLE_TPU_TUNE via the one shared mode-env parser
    (observability.journal.mode_env, also behind PADDLE_TPU_OBS_HEALTH --
    no spelling accepted by one gate and rejected by another). Re-read per call so tests and long-lived processes can
    flip it at runtime. Unset -> cached; 1/true -> search; 0/false/empty ->
    off."""
    return _journal.mode_env(_ENV_MODE, _MODES, default="cached",
                             truthy="search")


def default_cache_path() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu_torch",
                        "autotune.json")


def cache_path() -> str:
    return os.environ.get(_ENV_CACHE) or default_cache_path()


def make_key(choice_id: str, bucket, dtype: str, device_kind: str,
             versions: str) -> str:
    """The canonical decision-key string. ``bucket`` is the choice point's
    shape bucket (any JSON-able value); its json.dumps with sorted keys makes
    the key deterministic and byte-identical across processes.
    ``device_kind`` is the card's name (``torch.cuda.get_device_name``),
    ``versions`` the torch and CUDA versions (``choices.versions()``), where
    the JAX package keys by device kind and jax version."""
    b = json.dumps(bucket, sort_keys=True, separators=(",", ":"))
    return f"{choice_id}|{b}|{dtype}|{device_kind}|{versions}"


class DecisionCache:
    """In-memory decision store with lazy one-shot disk load and atomic
    persistence. Thread-safe; ``epoch`` counts mutations (including the disk
    load) so the executor can key compiled steps on the decision state."""

    def __init__(self, path: Optional[str] = None):
        self._path = path
        self._lock = threading.RLock()
        self._decisions: Dict[str, dict] = {}
        self._loaded = False
        self._warned_version = False
        self.epoch = 0

    @property
    def path(self) -> str:
        return self._path or cache_path()

    def load(self) -> None:
        """Read the disk cache once (idempotent). Missing file, torn JSON or
        a foreign format_version all yield an empty cache -- tuning must
        degrade, never abort a run."""
        with self._lock:
            if self._loaded:
                return
            self._loaded = True
            path = self.path
            try:
                if not _fsio.exists(path):
                    return
                with _fsio.open_file(path) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                return
            if not isinstance(doc, dict):
                return
            if doc.get("format_version") != FORMAT_VERSION:
                if not self._warned_version:
                    self._warned_version = True
                    import warnings
                    warnings.warn(
                        f"paddle_tpu_torch autotune cache {path!r} has format "
                        f"version {doc.get('format_version')!r}, expected "
                        f"{FORMAT_VERSION}; ignoring it")
                return
            dec = doc.get("decisions")
            if isinstance(dec, dict):
                self._decisions.update(
                    {k: v for k, v in dec.items() if isinstance(v, dict)})
                if dec:
                    self.epoch += 1

    def get(self, key: str) -> Optional[dict]:
        self.load()
        with self._lock:
            return self._decisions.get(key)

    def put(self, key: str, record: dict, persist: bool = True) -> None:
        self.load()
        with self._lock:
            self._decisions[key] = record
            self.epoch += 1
            if persist:
                self.save()

    def items(self) -> Dict[str, dict]:
        self.load()
        with self._lock:
            return dict(self._decisions)

    def save(self) -> None:
        """Atomic write: serialize to ``<path>.tmp.<pid>`` then
        ``utils.fs.replace`` (os.replace locally; copy-then-delete is the
        documented non-atomic window on remote stores).

        Merge-on-save: the on-disk file is re-read and this process's
        decisions layered on top, so two search-mode processes sharing one
        cache (the CLI beside a training run, two jobs over a shared home) append to each other instead of last-writer-wins deleting the
        other's freshly measured winners. Ours win conflicts: they are the
        newer measurement on this host."""
        with self._lock:
            path = self.path
            merged: Dict[str, dict] = {}
            try:
                if _fsio.exists(path):
                    with _fsio.open_file(path) as f:
                        doc = json.load(f)
                    if (isinstance(doc, dict)
                            and doc.get("format_version") == FORMAT_VERSION
                            and isinstance(doc.get("decisions"), dict)):
                        merged.update({k: v for k, v in
                                       doc["decisions"].items()
                                       if isinstance(v, dict)})
            except (OSError, ValueError):
                pass  # unreadable/torn file: replaced wholesale below
            merged.update(self._decisions)
            doc = {"format_version": FORMAT_VERSION,
                   "written": time.time(),
                   "decisions": dict(sorted(merged.items()))}
            d = os.path.dirname(path)
            try:
                if d and not _fsio.is_remote(path):
                    os.makedirs(d, exist_ok=True)
                tmp = f"{path}.tmp.{os.getpid()}"
                with _fsio.open_file(tmp, "w") as f:
                    json.dump(doc, f, indent=1, sort_keys=True)
                _fsio.replace(tmp, path)
            except OSError as e:
                import warnings
                warnings.warn(
                    f"paddle_tpu_torch autotune cache {path!r} unwritable: {e}; "
                    f"decisions stay in-memory for this process")

    def clear(self) -> None:
        """Forget every decision THIS PROCESS holds. The disk file is left
        untouched but deliberately NOT re-read afterwards (_loaded stays
        True) -- otherwise the next get() would resurrect exactly the
        decisions the caller just discarded. Delete the cache file to drop
        persisted decisions for good."""
        with self._lock:
            self._decisions.clear()
            self._loaded = True
            self.epoch += 1


#: the process-wide cache used by ``tuning.decide``; tests swap it via
#: ``tuning.cache.reset_for_tests(path)``
CACHE = DecisionCache()


def reset_for_tests(path: Optional[str] = None) -> DecisionCache:
    """Replace the global cache (fresh, optionally pinned to ``path``) and
    return it. Test-only: production code never calls this."""
    global CACHE
    CACHE = DecisionCache(path)
    return CACHE


def state_token():
    """(mode, cache epoch): part of the executor's step-graph key, so that a
    decision landing mid-process (CLI pre-tune, first search) or a mode flip
    recaptures the affected programs instead of replaying a stale route."""
    return (mode(), CACHE.epoch)
