"""Thread-safe metrics registry: counter, gauge and histogram families (the
port's copy of ``paddle_tpu/observability/metrics.py``).

Families are keyed by name, children by their sorted label items, as
Prometheus names them; an update is a dict lookup and a locked add, no I/O.
``REGISTRY`` is the process-wide default that the dataset code, the
streaming data plane, the checkpointer and the step guardian report into.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

#: latency-oriented default buckets (seconds)
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


class Counter:
    """Monotonically increasing float."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Instantaneous value; settable both ways."""

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (cumulative bucket counts, sum, count)."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one finite bucket")
        self.bucket_bounds: Tuple[float, ...] = tuple(bs)
        self._lock = threading.Lock()
        self._bucket_counts = [0] * len(bs)     # +Inf is implicit (== count)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float):
        value = float(value)
        idx = bisect.bisect_left(self.bucket_bounds, value)
        with self._lock:
            if idx < len(self._bucket_counts):
                self._bucket_counts[idx] += 1
            self._sum += value
            self._count += 1

    def time(self):
        """``with hist.time(): ...``"""
        return _HistTimer(self)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count), ...] with a final (+Inf, count)."""
        return self.snapshot()[2]

    def snapshot(self) -> Tuple[int, float, List[Tuple[float, int]]]:
        """(count, sum, cumulative_buckets), read under one lock."""
        with self._lock:
            out, acc = [], 0
            for le, n in zip(self.bucket_bounds, self._bucket_counts):
                acc += n
                out.append((le, acc))
            out.append((float("inf"), self._count))
            return self._count, self._sum, out


class _HistTimer:
    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


_KINDS = {"counter": Counter, "gauge": Gauge}


class _Family:
    """One metric name; children keyed by their sorted label items."""

    def __init__(self, name: str, kind: str = "counter", help: str = "",
                 buckets: Optional[Sequence[float]] = None):
        self.name, self.kind, self.help = name, kind, help
        self.buckets = (tuple(sorted(float(b) for b in buckets))
                        if buckets else DEFAULT_BUCKETS)
        self._lock = threading.Lock()
        self.children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def items(self):
        """Sorted (label key, child) snapshot, taken under the family lock."""
        with self._lock:
            return sorted(self.children.items())

    def child(self, labels: Dict[str, str]):
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        c = self.children.get(key)
        if c is None:
            with self._lock:
                c = self.children.get(key)
                if c is None:
                    c = (Histogram(self.buckets) if self.kind == "histogram"
                         else _KINDS[self.kind]())
                    self.children[key] = c
        return c


class MetricsRegistry:
    """Name -> family; families create labelled children on demand."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str, buckets=None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = self._families[name] = _Family(name, kind, help, buckets)
        if fam.kind != kind:
            raise ValueError(f"metric {name!r} already registered as {fam.kind}, "
                             f"requested {kind}")
        if (buckets is not None and kind == "histogram"
                and tuple(sorted(float(b) for b in buckets)) != fam.buckets):
            raise ValueError(f"histogram {name!r} already registered with buckets "
                             f"{fam.buckets}, requested {tuple(buckets)}")
        return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._family(name, "counter", help).child(labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._family(name, "gauge", help).child(labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None, **labels) -> Histogram:
        return self._family(name, "histogram", help, buckets).child(labels)

    def remove_labeled(self, name: str, **labels) -> bool:
        """Drop one labelled child."""
        fam = self._families.get(name)
        if fam is None:
            return False
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        with fam._lock:
            return fam.children.pop(key, None) is not None

    def collect(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def to_dict(self) -> dict:
        """Every family as JSON-able values: ``{name: {"kind", "series":
        [{"labels", "value"} | {"labels", "count", "sum", "buckets"}]}}``."""
        out = {}
        for fam in self.collect():
            series = []
            for key, c in fam.items():
                if isinstance(c, Histogram):
                    n, s, b = c.snapshot()
                    series.append({"labels": dict(key), "count": n, "sum": s,
                                   "buckets": [[str(le), k] for le, k in b]})
                else:
                    series.append({"labels": dict(key), "value": c.value})
            out[fam.name] = {"kind": fam.kind, "series": series}
        return out

    def reset(self):
        """Drop all families (test isolation)."""
        with self._lock:
            self._families.clear()


#: the process-wide registry
REGISTRY = MetricsRegistry()
