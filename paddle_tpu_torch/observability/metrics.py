"""Thread-safe metrics registry of counter families (the port's copy of the
part of ``paddle_tpu/observability/metrics.py`` the dataset code reads;
gauges and histograms are not ported yet).

Families are keyed by name, children by their sorted label items, as
Prometheus names them; an update is a dict lookup and a locked add, no I/O.
``REGISTRY`` is the process-wide default the dataset code reports into
(``sources_skipped_total``, ``samples_quarantined_total{reason}``).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class Counter:
    """Monotonically increasing float."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class _Family:
    """One counter name; children keyed by their sorted label items."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._lock = threading.Lock()
        self.children: Dict[Tuple[Tuple[str, str], ...], Counter] = {}

    def items(self):
        with self._lock:
            return sorted(self.children.items())

    def child(self, labels: Dict[str, str]) -> Counter:
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        c = self.children.get(key)
        if c is None:
            with self._lock:
                c = self.children.get(key)
                if c is None:
                    c = self.children[key] = Counter()
        return c


class MetricsRegistry:
    """Name -> family; families create labelled children on demand."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = self._families[name] = _Family(name, help)
        return fam.child(labels)

    def collect(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def reset(self):
        """Drop all families (test isolation)."""
        with self._lock:
            self._families.clear()


#: the process-wide registry
REGISTRY = MetricsRegistry()
