"""Typed alerts: the objects the SLO engine fires, carries and resolves (the
port's copy of ``paddle_tpu/observability/alerts.py``).

Split out of :mod:`slo` so the alert *shape* (what a firing looks like in
the journal, on ``/alerts``, inside a post-mortem bundle) is independent
of the *policy* that produced it (burn-rate math, rule parsing).  The
manager is the single bookkeeper:

- ``fire`` / ``resolve`` keep the active set keyed by
  ``(rule, window, labels)`` -- re-firing an already-active alert only
  refreshes its observed value, it does not double-journal or
  double-count;
- every transition journals an ``alert`` event (rule id, window,
  observed vs objective) and maintains ``alerts_total{rule,severity}``
  plus the ``alerts_active`` gauge;
- a bounded history ring keeps the recently-resolved alerts for
  ``/alerts`` and the black box.

Failure policy as everywhere in observability: bookkeeping degrades,
never aborts the training/serving path that asked for an evaluation.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

from . import journal as _journal
from .metrics import REGISTRY, MetricsRegistry

#: resolved alerts kept for /alerts and post-mortem bundles
HISTORY_CAP = 256

#: the window name used by rules without burn windows
INSTANT = "instant"


@dataclasses.dataclass
class Alert:
    """One firing (or resolved) SLO violation."""

    rule: str                      # rule id
    severity: str                  # "page", "ticket", ... (rule-defined)
    window: str                    # burn-window name or "instant"
    labels: Dict[str, str]         # group-by labels ({} for global rules)
    observed: float                # metric value at (last) evaluation
    objective: str                 # human objective, e.g. "p99 <= 0.025"
    burn: Optional[float] = None   # burn rate that tripped (None = instant)
    state: str = "firing"          # "firing" | "resolved"
    t_fired: float = 0.0           # engine-clock time of the transition
    t_resolved: Optional[float] = None

    def key(self) -> Tuple:
        return (self.rule, self.window, tuple(sorted(self.labels.items())))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["labels"] = dict(self.labels)
        return d


class AlertManager:
    """Fire/resolve bookkeeping + journal/metrics export for alerts."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 history_cap: int = HISTORY_CAP):
        self._registry = registry or REGISTRY
        self._lock = threading.Lock()
        self._active: Dict[Tuple, Alert] = {}
        self._history: "collections.deque" = collections.deque(
            maxlen=history_cap)

    def _journal(self, alert: Alert):
        _journal.emit({
            "event": "alert",
            "state": alert.state,
            "rule": alert.rule,
            "severity": alert.severity,
            "window": alert.window,
            "labels": dict(alert.labels),
            "observed": alert.observed,
            "objective": alert.objective,
            "burn": alert.burn,
        })

    def fire(self, rule: str, severity: str, window: str,
             labels: Dict[str, str], observed: float, objective: str,
             now: float, burn: Optional[float] = None) -> Alert:
        """Raise (or refresh) the alert for one (rule, window, group)."""
        key = (rule, window, tuple(sorted(labels.items())))
        with self._lock:
            cur = self._active.get(key)
            if cur is not None:            # already firing: refresh only
                cur.observed = observed
                cur.burn = burn
                return cur
            alert = Alert(rule=rule, severity=severity, window=window,
                          labels=dict(labels), observed=observed,
                          objective=objective, burn=burn, t_fired=now)
            self._active[key] = alert
        self._registry.counter(
            "alerts_total", "SLO alerts fired, by rule and severity",
            rule=rule, severity=severity).inc()
        self._journal(alert)
        self.export_gauge()
        return alert

    def resolve(self, rule: str, window: str, labels: Dict[str, str],
                observed: float, now: float) -> Optional[Alert]:
        """Clear the alert for one (rule, window, group), if firing."""
        key = (rule, window, tuple(sorted(labels.items())))
        with self._lock:
            alert = self._active.pop(key, None)
            if alert is None:
                return None
            alert.state = "resolved"
            alert.observed = observed
            alert.t_resolved = now
            self._history.append(alert)
        self._journal(alert)
        self.export_gauge()
        return alert

    def active(self) -> List[Alert]:
        with self._lock:
            return sorted(self._active.values(),
                          key=lambda a: (a.rule, a.window,
                                         sorted(a.labels.items())))

    def history(self) -> List[Alert]:
        with self._lock:
            return list(self._history)

    def export_gauge(self):
        self._registry.gauge(
            "alerts_active", "SLO alerts currently firing").set(
            float(len(self._active)))

    def to_doc(self) -> dict:
        """JSON document for ``/alerts`` and post-mortem bundles."""
        return {
            "active": [a.to_dict() for a in self.active()],
            "recent_resolved": [a.to_dict() for a in self.history()],
        }

    def clear(self):
        with self._lock:
            self._active.clear()
            self._history.clear()
        self.export_gauge()
