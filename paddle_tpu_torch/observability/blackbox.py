"""Post-mortem black box: crash-time forensics in one atomic bundle (the
port's copy of ``maybe_write`` and ``write_bundle`` of
``paddle_tpu/observability/blackbox.py``).

When a guarded run dies (out of retries, a ``StepTimeout``, a nonfinite
step under ``policy=raise``, a preemption's emergency save) the terminal
path calls :func:`maybe_write`, which writes what the observability stack
holds into ``<dir>/postmortem-<ts>-p<pid>/bundle.json``, under the JAX
bundle's keys:

- ``journal``: the journal ring (every typed event up to the failure);
- ``timeline``: the flight recorder's span tail and counter tracks;
- ``metrics``: a dump of the registry (the device-memory gauges among it);
- ``alerts``: the SLO engine's active and recently resolved alerts;
- ``executors``: each live executor's cached steps (their cache keys) and
  the feeds, fetches and capture time of its last miss;
- ``attribution``: each recorded per-op attribution, when attribution is
  armed.

Arming: ``PADDLE_TPU_OBS_BLACKBOX=<dir>`` (a truthy ``1`` spells
``./postmortems``). Disarmed, every hook is one ``os.environ`` read. The
bundle is written tmp-then-rename, at most ``MAX_BUNDLES`` a process, and
writing never raises: forensics must not mask the failure it documents.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Optional

from . import journal as _journal
from . import timeline as _timeline
from .metrics import REGISTRY

BLACKBOX_ENV = "PADDLE_TPU_OBS_BLACKBOX"
DEFAULT_DIR = "postmortems"
FORMAT = "paddle_tpu_postmortem_v1"
#: timeline spans kept in a bundle (newest-last)
SPAN_TAIL = 2048
#: bundles one process may write
MAX_BUNDLES = 8

_lock = threading.Lock()
_written = 0
_warned = set()


def armed_dir() -> Optional[str]:
    """The bundle base directory, or None when disarmed (one env read)."""
    raw = os.environ.get(BLACKBOX_ENV)
    if raw is None:
        return None
    raw = raw.strip()
    if raw.lower() in _journal.FALSY:
        return None
    if raw.lower() in _journal.TRUTHY:
        return DEFAULT_DIR
    return raw


def _timeline_doc() -> dict:
    return {"spans": [{"name": n, "cat": c, "t0": t0, "dur": dur, "args": args, "tid": tid}
                      for (n, c, t0, dur, args, tid) in _timeline.spans()[-SPAN_TAIL:]],
            "counters": _timeline.counters()}


def _alerts_doc() -> dict:
    from . import slo as _slo
    return _slo.alerts_doc()


def _executor_snapshots() -> list:
    from ..core.executor import Executor
    return [e.debug_snapshot() for e in list(Executor._instances)]


def _attribution_snapshots() -> list:
    from . import attribution as _attrib
    if not _attrib.attribution_enabled():
        return []
    out = []
    for _ref, attrib in list(_attrib._IR_STORE.values()):
        out.append({"program": attrib.label, "device": attrib.device,
                    "attributed_device_fraction": attrib.coverage,
                    "device_seconds": attrib.total_device_seconds,
                    "per_category": {k: dict(v) for k, v in attrib.per_category.items()},
                    "top_ops": [{"ir": ir, "device_seconds": v["device_seconds"],
                                 "tensor_bytes": v["tensor_bytes"]}
                                for ir, v in attrib.top_ops(10)]})
    return out


def snapshot(reason: str, error: Optional[BaseException] = None,
             extra: Optional[dict] = None) -> dict:
    """The bundle document (in memory). A section that fails to build
    becomes a ``"<section>_error"`` note, never a lost bundle."""
    doc = {"format": FORMAT, "reason": reason, "ts": time.time(),
           "pid": os.getpid(), "extra": dict(extra or {})}
    r = _journal.current_rank()
    if r is not None:
        doc["rank"] = r
    if error is not None:
        doc["error"] = {"type": type(error).__name__, "message": str(error)[:2000]}
    for section, build in (("journal", _journal.recent),
                           ("timeline", _timeline_doc),
                           ("metrics", REGISTRY.to_dict),
                           ("alerts", _alerts_doc),
                           ("executors", _executor_snapshots),
                           ("attribution", _attribution_snapshots)):
        try:
            doc[section] = build()
        except Exception as e:  # noqa: BLE001 -- a section degrades, the bundle stays
            doc[section + "_error"] = repr(e)
    return doc


def write_bundle(reason: str, error: Optional[BaseException] = None,
                 extra: Optional[dict] = None,
                 base_dir: Optional[str] = None) -> Optional[str]:
    """Write one bundle atomically; returns its directory, or None
    (disarmed, capped, or the write failed -- never an exception)."""
    global _written
    try:
        base = base_dir if base_dir is not None else armed_dir()
        if base is None:
            return None
        with _lock:
            if _written >= MAX_BUNDLES:
                return None
            _written += 1
        doc = snapshot(reason, error=error, extra=extra)
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime(doc["ts"]))
        bdir = os.path.join(base, f"postmortem-{stamp}-p{os.getpid()}")
        n = 1
        while os.path.exists(bdir):
            bdir = os.path.join(base, f"postmortem-{stamp}-p{os.getpid()}-{n}")
            n += 1
        os.makedirs(bdir, exist_ok=True)
        tmp = os.path.join(bdir, ".bundle.json.tmp")
        with open(tmp, "w") as f:
            json.dump(doc, f, sort_keys=True, default=str)
        path = os.path.join(bdir, "bundle.json")
        os.replace(tmp, path)
        REGISTRY.counter("postmortem_bundles_total",
                         "post-mortem bundles written, by trigger", reason=reason).inc()
        _journal.emit({"event": "postmortem", "reason": reason, "path": path})
        return bdir
    except Exception as e:  # noqa: BLE001 -- forensics never raise
        with _lock:
            first = reason not in _warned
            _warned.add(reason)
        if first:
            warnings.warn(f"paddle_tpu blackbox: bundle write failed for {reason!r}: {e}")
        return None


#: the terminal-path hook: one env read when disarmed
maybe_write = write_bundle


def reset(written_cap: Optional[int] = None):
    """Reset the per-process bundle budget (tests)."""
    global _written, MAX_BUNDLES
    with _lock:
        _written = 0
        _warned.clear()
        if written_cap is not None:
            MAX_BUNDLES = written_cap
