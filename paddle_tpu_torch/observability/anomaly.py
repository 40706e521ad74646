"""Step-time anomaly detection: a rolling median/MAD regression detector
(the port's copy of ``paddle_tpu/observability/anomaly.py``).

Per window the detector keeps recent step wall times and flags a step that
exceeds

    median + k * max(MAD, rel_floor * median, abs_floor)

where MAD is the median absolute deviation (robust to the very outliers
being hunted), the relative floor keeps a tight window (MAD ~ 0) from
flagging tiny relative wobble, and the absolute floor (1 ms) keeps
sub-millisecond steps, where a few ms of scheduling jitter is normal, from
alarming at all. A flagged step increments ``anomaly_total{kind="step_time"}``
and journals a ``step_time_anomaly`` event with the step, median and MAD
milliseconds.

Host-side float math over a <= 64-entry window; no device interaction. The
executor feeds warm steps only (replays of a captured step, or eager runs
after a signature's first), timed synchronously, one window per entry of
its cache of captured steps, retired with the entry: a warm-up or a capture
neither flags itself nor poisons the window.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional

from .metrics import REGISTRY, MetricsRegistry

WINDOW = 64           # rolling sample count per program label
MIN_SAMPLES = 8       # no verdicts before the window has this many
THRESHOLD_MADS = 8.0  # k in median + k*MAD
REL_FLOOR = 0.10      # MAD floor as a fraction of the median
ABS_FLOOR = 1e-3      # MAD floor in seconds (host-jitter scale)
# distinct windows tracked (LRU). Windows are keyed by full cache keys, and
# one Executor alone holds up to 64 cache entries: a cap at that size would
# LRU-thrash every window below MIN_SAMPLES once two executors coexist.
_LABEL_CAP = 256


def _median(sorted_vals):
    n = len(sorted_vals)
    mid = n // 2
    return (sorted_vals[mid] if n % 2 else
            0.5 * (sorted_vals[mid - 1] + sorted_vals[mid]))


class StepTimeAnomalyDetector:
    """Rolling median/MAD detector over per-label step-time windows."""

    def __init__(self, window: int = WINDOW, min_samples: int = MIN_SAMPLES,
                 threshold: float = THRESHOLD_MADS,
                 rel_floor: float = REL_FLOOR, abs_floor: float = ABS_FLOOR,
                 registry: Optional[MetricsRegistry] = None,
                 label_cap: int = _LABEL_CAP):
        self.window = window
        self.label_cap = label_cap
        self.min_samples = min_samples
        self.threshold = threshold
        self.rel_floor = rel_floor
        self.abs_floor = abs_floor
        self.registry = registry or REGISTRY
        self._lock = threading.Lock()
        # window key -> recent step seconds (keys are labels or, from the
        # executor, full cache keys -- any hashable)
        self._windows: "collections.OrderedDict" = collections.OrderedDict()

    def observe(self, label: str, seconds: float,
                key=None) -> Optional[dict]:
        """Feed one step time; returns the anomaly record if flagged.

        ``key`` (default: the label) selects the rolling window -- the
        executor passes its full cache key so two feed signatures
        of one program, whose legitimate step times can differ by large
        factors, never share a median.  The journaled record still carries
        the human-readable ``label``.

        The verdict is computed against the window *before* this step
        enters it, so one slow step cannot mask itself; the sample is
        appended either way (a persistent regression becomes the new
        normal after ~window/2 steps rather than alerting forever).
        """
        wkey = label if key is None else key
        with self._lock:
            win = self._windows.pop(wkey, None)
            if win is None:
                win = collections.deque(maxlen=self.window)
            self._windows[wkey] = win         # move-to-end: LRU
            while len(self._windows) > self.label_cap:
                self._windows.popitem(last=False)
            vals = sorted(win)
            win.append(seconds)
        if len(vals) < self.min_samples:
            return None
        med = _median(vals)
        mad = _median(sorted(abs(v - med) for v in vals))
        limit = med + self.threshold * max(mad, self.rel_floor * med,
                                           self.abs_floor)
        if seconds <= limit:
            return None
        record = {
            "event": "step_time_anomaly", "program": label,
            "step_ms": round(seconds * 1e3, 3),
            "median_ms": round(med * 1e3, 3),
            "mad_ms": round(mad * 1e3, 3),
            "limit_ms": round(limit * 1e3, 3),
            "n_window": len(vals),
        }
        self.registry.counter(
            "anomaly_total", "anomalous observations by detector kind",
            kind="step_time").inc()
        from . import journal as _journal
        _journal.emit(record)
        return record

    def retire(self, key):
        """Drop a window (cache eviction): a reused CPython id must not be
        judged against a dead program's step times."""
        with self._lock:
            self._windows.pop(key, None)

    def reset(self):
        with self._lock:
            self._windows.clear()


#: process-wide detector the executor feeds.
DETECTOR = StepTimeAnomalyDetector()
