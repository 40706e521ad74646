"""Structured run journal: one JSON-lines event per notable runtime act
(the port's copy of ``paddle_tpu/observability/journal.py``).

Two sinks: an in-process ring buffer that is always on (capacity 1024, or
``PADDLE_TPU_OBS_JOURNAL_RING``, clamped to [16, 1048576] with a warning),
and a JSONL file written only when ``PADDLE_TPU_OBS`` is truthy, at
``PADDLE_TPU_OBS_JOURNAL`` (default ``paddle_tpu_obs.jsonl`` in the working
directory). The environment is read again on every emit. A journal path
that fails to write is warned about once and then skipped: telemetry never
aborts a run.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
import warnings
from typing import List, Optional

DEFAULT_JOURNAL = "paddle_tpu_obs.jsonl"
RING_ENV = "PADDLE_TPU_OBS_JOURNAL_RING"
_RING_CAP = 1024
_RING_MIN, _RING_MAX = 16, 1_048_576

#: the spellings that turn a PADDLE_TPU_OBS* toggle on
TRUTHY = ("1", "true", "yes", "on")
#: the matching falsy spellings (unset or empty included)
FALSY = ("0", "false", "no", "")


def ring_capacity() -> int:
    """``PADDLE_TPU_OBS_JOURNAL_RING``, clamped with a warning; read at
    import and on ``clear``."""
    raw = os.environ.get(RING_ENV)
    if raw is None or not raw.strip():
        return _RING_CAP
    try:
        n = int(raw.strip())
    except ValueError:
        warnings.warn(f"{RING_ENV}={raw!r} is not an integer; journal ring stays at "
                      f"{_RING_CAP}")
        return _RING_CAP
    if n < _RING_MIN or n > _RING_MAX:
        clamped = min(max(n, _RING_MIN), _RING_MAX)
        warnings.warn(f"{RING_ENV}={raw!r} clamped to {clamped} "
                      f"(sane range [{_RING_MIN}, {_RING_MAX}])")
        return clamped
    return n


_lock = threading.Lock()
_ring: "collections.deque" = collections.deque(maxlen=ring_capacity())
_broken_paths = set()
_rank_cache = None   # None: not computed; False: single process; int: this rank


def env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in TRUTHY


def mode_env(name: str, modes=("off", "warn", "raise"), default="off",
             truthy="warn") -> str:
    """A mode environment variable with the shared toggle spellings (TRUTHY
    -> ``truthy``, FALSY -> "off", unset -> ``default``); an unknown value
    raises instead of silently weakening what the user asked for."""
    raw = os.environ.get(name)
    if raw is None:
        return default if default in modes else "off"
    m = raw.strip().lower()
    if m in TRUTHY:
        m = truthy
    elif m in FALSY:
        m = "off"
    if m not in modes:
        raise ValueError(f"{name}={raw!r} invalid; use one of {modes} "
                         f"(or a 0/1 toggle: 1 means {truthy})")
    return m


def enabled() -> bool:
    """Is the file sink on? (``PADDLE_TPU_OBS`` truthy)"""
    return env_truthy("PADDLE_TPU_OBS")


def current_rank() -> Optional[int]:
    """This process's rank in a multi-process job, else None (computed once;
    ``clear`` resets it)."""
    global _rank_cache
    if _rank_cache is None:
        from ..parallel import env as penv
        _rank_cache = penv.get_rank() if penv.get_world_size() > 1 else False
    return None if _rank_cache is False else _rank_cache


def journal_path() -> str:
    return os.environ.get("PADDLE_TPU_OBS_JOURNAL", DEFAULT_JOURNAL)


def emit(event: dict) -> dict:
    """Record ``event`` (a flat JSON-able dict with an "event" key), stamped
    with ``ts``, ``pid`` and, in a multi-process job, ``rank``."""
    ev = dict(event)
    ev.setdefault("ts", time.time())
    ev.setdefault("pid", os.getpid())
    r = current_rank()
    if r is not None:
        ev.setdefault("rank", r)
    with _lock:
        _ring.append(ev)
    if enabled():
        path = journal_path()
        if path not in _broken_paths:
            try:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                line = json.dumps(ev, sort_keys=True, default=str)
                with _lock, open(path, "a") as f:
                    f.write(line + "\n")
            except OSError as e:
                _broken_paths.add(path)
                warnings.warn(f"paddle_tpu journal sink disabled, {path!r} unwritable: {e}")
    return ev


def recent(n: Optional[int] = None, event: Optional[str] = None) -> List[dict]:
    """Newest-last slice of the ring, optionally of one event type."""
    with _lock:
        evs = list(_ring)
    if event is not None:
        evs = [e for e in evs if e.get("event") == event]
    return evs[-n:] if n else evs


def read_journal(path: Optional[str] = None) -> List[dict]:
    """Parse a JSONL journal file (``journal_path()`` by default), skipping
    blank lines and a torn last line of a killed process."""
    path = path or journal_path()
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out


def clear():
    global _rank_cache, _ring
    cap = ring_capacity()
    with _lock:
        if cap != _ring.maxlen:
            _ring = collections.deque(maxlen=cap)
        else:
            _ring.clear()
    _broken_paths.clear()
    _rank_cache = None
