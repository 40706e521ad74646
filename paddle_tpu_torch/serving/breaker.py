"""Per-(tenant, signature) circuit breaker for the serving tier (the port's
copy of ``paddle_tpu/serving/breaker.py``).

A poisoned input shape -- a tenant whose requests reliably fail their
batches (bad feature width, an input that trips a model assert, a shape
that tickles a backend bug) -- must not keep occupying batch rows and
worker time while healthy tenants queue behind it. The breaker watches
batch outcomes per ``(tenant, row-signature)`` key and fast-fails the
poisoned key at admission:

- **closed** (healthy): requests admitted; ``threshold`` CONSECUTIVE
  batch failures trip the key to open (any success resets the streak);
- **open**: submits fast-fail typed (:class:`BreakerOpen`, a
  :class:`~paddle_tpu_torch.serving.batcher.RequestShed` with reason
  ``"breaker_open"`` -- retryable admission control, never a hang) until
  ``backoff_s`` has elapsed;
- **half_open**: after the backoff one probe request is admitted (all
  others keep fast-failing); its batch outcome decides -- success closes
  the breaker, failure re-opens it with doubled backoff (capped at
  ``backoff_max_s``). A probe that never resolves (evicted by its own
  deadline, say) releases the probe slot after one further backoff so the
  breaker cannot wedge half-open.

Blame is batch-granular: a failed batch records a failure for EVERY
(tenant, signature) it carried, because the pool cannot attribute a
predictor exception to one row. A healthy tenant consistently co-batched
with a same-signature poisoned one can therefore trip its own breaker
(collateral). The dynamics make that transient: once the poisoned key is
open its requests fast-fail at admission and stop entering batches, so
the healthy key's next half-open probe runs a clean batch, succeeds, and
closes -- one backoff of degradation, bounded, and the common poison case
(a bad input SHAPE) never co-batches at all since signatures differ.

All timing runs on the injectable serving :class:`Clock`, so every
transition is testable hermetically under ``FakeClock``. Transitions are
reported through ``on_transition(key, old, new, entry)`` -- the pool
journals them (``serve_breaker`` events) and mirrors the state into the
``serving_breaker_state{tenant,sig}`` gauge (0=closed, 1=half_open,
2=open).
"""
from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, Optional, Tuple

from .batcher import Clock, MonotonicClock, RequestShed

__all__ = ["BreakerOpen", "CircuitBreaker", "STATE_VALUES", "sig_id"]

#: gauge encoding of breaker states
STATE_VALUES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}


def sig_id(sig) -> str:
    """Stable short label for a row signature (metrics/journal-friendly)."""
    return "%08x" % (zlib.crc32(repr(sig).encode()) & 0xFFFFFFFF)


class BreakerOpen(RequestShed):
    """Typed fast-fail for a (tenant, signature) whose breaker is open."""

    def __init__(self, tenant: str, sig: str, retry_in_s: float):
        self.sig = sig
        self.retry_in_s = float(retry_in_s)
        super().__init__(
            "breaker_open", tenant,
            f"signature {sig} circuit open, retry in ~{retry_in_s:.2f}s")


class _Entry:
    __slots__ = ("state", "failures", "opened_at", "backoff",
                 "probe_started")

    def __init__(self):
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.backoff = 0.0
        self.probe_started: Optional[float] = None


class CircuitBreaker:
    """Keyed consecutive-failure breaker (see module docstring).

    Keys are opaque hashables -- the pool uses ``(tenant, sig)``. The
    disarmed hot path (every key closed, which is the steady state) is one
    dict lookup returning a zero-failure entry.
    """

    def __init__(self, threshold: int = 5, backoff_s: float = 1.0,
                 backoff_max_s: float = 30.0,
                 clock: Optional[Clock] = None,
                 on_transition: Optional[Callable] = None):
        if int(threshold) < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._clock = clock or MonotonicClock()
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._entries: Dict[object, _Entry] = {}

    def _transition(self, key, e: _Entry, new: str) -> None:
        old = e.state
        e.state = new
        if self._on_transition is not None and old != new:
            self._on_transition(key, old, new, e)

    def state(self, key) -> str:
        with self._lock:
            e = self._entries.get(key)
            return e.state if e is not None else "closed"

    def describe(self) -> Dict[object, dict]:
        """Snapshot of every non-closed key (chaos CLI / obs reporting)."""
        with self._lock:
            return {k: {"state": e.state, "failures": e.failures,
                        "backoff_s": e.backoff}
                    for k, e in self._entries.items()
                    if e.state != "closed" or e.failures}

    # -- admission ---------------------------------------------------------
    def allow(self, key) -> Tuple[bool, str, float]:
        """Admission check for one request: ``(admitted, state,
        retry_in_s)``. In half_open exactly one in-flight probe is
        admitted; everyone else fast-fails until the probe resolves."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.state == "closed":
                return True, "closed", 0.0
            now = self._clock.now()
            if e.state == "open":
                elapsed = now - e.opened_at
                if elapsed < e.backoff:
                    return False, "open", e.backoff - elapsed
                self._transition(key, e, "half_open")
                e.probe_started = now
                return True, "half_open", 0.0
            # half_open: one probe at a time, but a probe that vanished
            # (deadline-evicted before its batch formed) must not wedge
            # the breaker -- release the slot after one more backoff
            if (e.probe_started is not None
                    and now - e.probe_started < e.backoff):
                return False, "half_open", e.backoff - (now - e.probe_started)
            e.probe_started = now
            return True, "half_open", 0.0

    # -- batch outcomes ----------------------------------------------------
    def record_success(self, key) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                return
            e.failures = 0
            e.probe_started = None
            if e.state != "closed":
                e.backoff = 0.0
                self._transition(key, e, "closed")

    def record_failure(self, key) -> None:
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                e = self._entries[key] = _Entry()
            now = self._clock.now()
            if e.state == "half_open":
                # the probe failed: re-open with doubled backoff
                e.failures += 1
                e.opened_at = now
                e.backoff = min(self.backoff_max_s,
                                max(self.backoff_s, e.backoff * 2.0))
                e.probe_started = None
                self._transition(key, e, "open")
                return
            if e.state == "open":
                # a straggler batch admitted before the trip: already open
                e.failures += 1
                return
            e.failures += 1
            if e.failures >= self.threshold:
                e.opened_at = now
                e.backoff = self.backoff_s
                self._transition(key, e, "open")
