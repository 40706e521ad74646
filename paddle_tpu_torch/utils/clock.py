"""Injectable time seam (the port's copy of ``paddle_tpu/utils/clock.py``):
components never call ``time``/``sleep`` directly, so tests drive deadline,
retry and poll logic hermetically through :class:`FakeClock` -- no real
sleeps, no wall-time flake. ``data/streaming.py`` uses it for source-retry
backoff, tail polling and sample-freshness stamps.
"""
from __future__ import annotations

import threading
from typing import List

__all__ = ["Clock", "MonotonicClock", "FakeClock"]


class Clock:
    """Time + condition-wait + sleep seam; substitutable in tests."""

    def now(self) -> float:
        raise NotImplementedError

    def wait(self, cond: threading.Condition, timeout: float) -> None:
        """Wait on ``cond`` (held by the caller) up to ``timeout`` secs."""
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        """Block the calling thread for ``seconds`` (retry backoff, tail
        polling)."""
        raise NotImplementedError


class MonotonicClock(Clock):
    def now(self) -> float:
        import time
        return time.monotonic()

    def wait(self, cond, timeout):
        cond.wait(timeout)

    def sleep(self, seconds):
        import time
        time.sleep(seconds)


class FakeClock(Clock):
    """Deterministic clock for hermetic tests: ``wait``/``sleep`` advance
    time instead of blocking, so deadline and backoff paths run in
    microseconds."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)
        self.waits: List[float] = []
        self.sleeps: List[float] = []
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self.t

    def advance(self, dt: float) -> None:
        with self._lock:
            self.t += dt

    def wait(self, cond, timeout):
        with self._lock:
            self.waits.append(timeout)
            self.t += max(0.0, timeout)

    def sleep(self, seconds):
        with self._lock:
            self.sleeps.append(seconds)
            self.t += max(0.0, seconds)
