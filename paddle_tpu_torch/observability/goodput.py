"""Goodput accounting: classify run wall-clock into productive vs lost time
(the port's copy of ``paddle_tpu/observability/goodput.py``).

"What fraction of wall-clock was productive training" needs a *ledger*,
not another timer: every second of a run already leaves a trace in the
telemetry the earlier layers record -- the ``phase_seconds`` histogram
(the executor's feed_prep / dispatch / fetch_sync / journal / compile spans
and the dataset's feed_wait, always on), the run journal (``run`` /
``megastep`` step times, ``ckpt_save`` blocked time, ``retry`` backoff,
``skip`` / ``rollback`` discards) and the metrics registry
(``autotune_search_seconds``). This module only *reads* those sources and
classifies the wall-clock window into:

- **productive**: the training step executing -- the ``dispatch`` span plus,
  by default, ``fetch_sync`` (the completion wait: under the synchronous
  timing that journaling or the benchmark flag arms, the card computes
  *through* that wait). Pass ``count_sync_as_productive=False`` for the
  strict reading where every host sync is overhead.
- **named loss causes**: ``compile`` (on the port, a CUDA-graph capture:
  the executor's, and the Predictor's, whose capture inside a serving
  pool's warm-up is recorded the same way), ``autotune``, ``feed_prep``,
  ``feed_wait``, ``telemetry`` (journal writes), ``checkpoint``,
  ``retry_backoff``, ``skipped_steps`` / ``rollback`` (discarded step work,
  estimated at the run's median warm step time), and ``other`` (the
  unattributed remainder), so the breakdown sums to the wall-clock by
  construction. ``warm_restore``, ``verify`` and ``elastic_restart`` keep
  their buckets for the JAX ledger's shape; nothing in the port records
  them yet (the warm store, the verifier and the elastic launcher are
  ROADMAP items 12 and 13).

Exported surface: the ``goodput_fraction`` gauge and the
``lost_seconds_total{cause}`` counters (:func:`export`), a text summary
(``GoodputReport.summary``) and the live ``/goodput`` endpoint of
``observability.server``.

Scoping: :func:`compute_live` reads the whole process lifetime (what a
long-lived server reports); :func:`run_ledger` snapshots the telemetry
counters first and diffs at exit, so one run's ledger is not polluted by
whatever else the process ran.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

from .metrics import REGISTRY, MetricsRegistry

#: causes counted as productive step execution (see module docstring for
#: why fetch_sync defaults to productive under synchronous timing)
PRODUCTIVE_CAUSES = ("dispatch", "fetch_sync")

#: every named bucket the ledger can attribute seconds to, in report order
CAUSES = ("dispatch", "fetch_sync", "compile", "warm_restore", "verify",
          "autotune",
          "feed_prep", "feed_wait", "telemetry", "checkpoint",
          "retry_backoff", "skipped_steps", "rollback", "elastic_restart",
          "other")

# phase_seconds (phase, cat) -> ledger cause. The "megastep" phase is a
# CONTAINER around dispatch+fetch_sync and must not be summed (it would
# double-count every fused step); Predictor phases describe serving, not
# this training ledger (its captures are recorded as executor compiles).
_PHASE_CAUSE = {
    ("dispatch", "executor"): "dispatch",
    ("fetch_sync", "executor"): "fetch_sync",
    ("feed_prep", "executor"): "feed_prep",
    ("journal", "executor"): "telemetry",
    ("compile", "executor"): "compile",
    ("warm_restore", "executor"): "warm_restore",
    ("verify", "executor"): "verify",
    ("feed_wait", "dataset"): "feed_wait",
}


class GoodputReport:
    """One classified wall-clock window.  ``breakdown`` maps every cause in
    :data:`CAUSES` to seconds and sums to ``wall_seconds`` exactly unless
    sources overlapped (``overaccounted_seconds`` > 0: a span counted
    twice, or a capture recorded outside the executor spans' window)."""

    def __init__(self, wall_seconds: float, breakdown: Dict[str, float],
                 productive_causes=PRODUCTIVE_CAUSES, n_steps: int = 0,
                 median_step_ms: Optional[float] = None,
                 overaccounted_seconds: float = 0.0,
                 sources: Optional[List[str]] = None):
        self.wall_seconds = float(wall_seconds)
        self.breakdown = dict(breakdown)
        self.productive_causes = tuple(productive_causes)
        self.n_steps = int(n_steps)
        self.median_step_ms = median_step_ms
        self.overaccounted_seconds = float(overaccounted_seconds)
        self.sources = list(sources or [])

    @property
    def productive_seconds(self) -> float:
        return sum(self.breakdown.get(c, 0.0) for c in self.productive_causes)

    @property
    def lost(self) -> Dict[str, float]:
        """Named loss causes only (everything not counted productive)."""
        return {c: s for c, s in self.breakdown.items()
                if c not in self.productive_causes}

    @property
    def goodput_fraction(self) -> float:
        if self.wall_seconds <= 0:
            return 0.0
        return min(1.0, self.productive_seconds / self.wall_seconds)

    def to_dict(self) -> dict:
        return {
            "wall_seconds": round(self.wall_seconds, 6),
            "productive_seconds": round(self.productive_seconds, 6),
            "goodput_fraction": round(self.goodput_fraction, 6),
            "breakdown_seconds": {c: round(s, 6)
                                  for c, s in self.breakdown.items()},
            "lost_seconds": {c: round(s, 6) for c, s in self.lost.items()},
            "productive_causes": list(self.productive_causes),
            "n_steps": self.n_steps,
            "median_step_ms": self.median_step_ms,
            "overaccounted_seconds": round(self.overaccounted_seconds, 6),
            "sources": self.sources,
        }

    def summary(self) -> str:
        """Human-readable per-run breakdown."""
        lines = []
        if self.wall_seconds <= 0:
            return ("(no goodput window: run with PADDLE_TPU_OBS=1 or the "
                    "benchmark flag so steps are timed synchronously)")
        lines.append(f"wall-clock {self.wall_seconds:.3f}s over "
                     f"{self.n_steps} steps -> goodput "
                     f"{self.goodput_fraction:.1%} "
                     f"(productive {self.productive_seconds:.3f}s: "
                     + " + ".join(self.productive_causes) + ")")
        for cause in CAUSES:
            s = self.breakdown.get(cause, 0.0)
            if s <= 0 or cause in self.productive_causes:
                continue
            lines.append(f"  lost {cause:<16} {s:>9.3f}s "
                         f"({s / self.wall_seconds:.1%})")
        if self.overaccounted_seconds > 0.005 * max(self.wall_seconds, 1e-9):
            lines.append(f"  (sources overlap by {self.overaccounted_seconds:.3f}s)")
        return "\n".join(lines)


# ------------------------------------------------------------- extraction --

def _hist_stats(snapshot: Optional[dict], name: str):
    """[(labels, count, sum)] for one histogram family of an
    ``export.to_dict()``-shaped snapshot (also tolerates the gauge-ified
    families a Prometheus text dump parses to)."""
    out = []
    for fam in (snapshot or {}).get("families", []):
        if fam.get("name") != name:
            continue
        for s in fam.get("samples", []):
            if "sum" in s or "count" in s:
                out.append((s.get("labels", {}), s.get("count", 0),
                            s.get("sum", 0.0)))
    return out


def _phase_sums(snapshot: Optional[dict]) -> Dict[str, float]:
    """phase_seconds histogram -> {cause: seconds} via :data:`_PHASE_CAUSE`."""
    sums: Dict[str, float] = {}
    for labels, _n, total in _hist_stats(snapshot, "phase_seconds"):
        cause = _PHASE_CAUSE.get((labels.get("phase"), labels.get("cat")))
        if cause is not None:
            sums[cause] = sums.get(cause, 0.0) + float(total)
    return sums


def _autotune_sum(snapshot: Optional[dict]) -> float:
    return sum(total for _l, _n, total
               in _hist_stats(snapshot, "autotune_search_seconds"))


def _counter_sum(snapshot: Optional[dict], name: str) -> float:
    total = 0.0
    for fam in (snapshot or {}).get("families", []):
        if fam.get("name") == name:
            for s in fam.get("samples", []):
                total += float(s.get("value") or 0.0)
    return total


def _median(vals: List[float]) -> Optional[float]:
    import statistics
    return statistics.median(vals) if vals else None


def _step_events(events):
    return [e for e in (events or [])
            if e.get("event") in ("run", "megastep")]


def _event_buckets(events, have_phases: bool):
    """Journal-derived bucket contributions.  When no phase histogram is
    available (a journal read alone), the step/compile time falls back
    to the journaled ``run_ms``/``compile_ms`` (attributed to dispatch --
    the journal cannot split launch from sync)."""
    buckets: Dict[str, float] = {}

    def add(cause, seconds):
        if seconds:
            buckets[cause] = buckets.get(cause, 0.0) + float(seconds)

    steps = _step_events(events)
    warm_ms = []
    n_steps = 0
    for e in steps:
        k = int(e.get("k") or 1)
        n_steps += k
        if e.get("cache") == "hit" and e.get("run_ms") is not None:
            per = (e.get("amortized_ms")
                   if e.get("event") == "megastep" else e.get("run_ms"))
            if per is not None:
                warm_ms.append(float(per))
        if not have_phases:
            add("dispatch", float(e.get("run_ms") or 0.0) / 1e3)
            add("compile", float(e.get("compile_ms") or 0.0) / 1e3)
    median_step_ms = _median(warm_ms)
    med_s = (median_step_ms or 0.0) / 1e3
    for e in events or []:
        ev = e.get("event")
        if ev == "ckpt_save":
            add("checkpoint", float(e.get("blocked_ms") or 0.0) / 1e3)
        elif ev == "retry":
            add("retry_backoff", float(e.get("backoff_ms") or 0.0) / 1e3)
        elif ev == "skip":
            # the discarded step's wall time was already recorded as
            # ordinary step execution (the executor journals the step
            # before the guardian drops its update); the median warm step
            # is the estimate that compute() RE-classifies out of the
            # productive buckets -- never adds on top
            add("skipped_steps", med_s)
        elif ev == "rollback":
            n = e.get("step"), e.get("to_step")
            if n[0] is not None and n[1] is not None:
                add("rollback", max(0, int(n[0]) - int(n[1])) * med_s)
        elif ev == "elastic_restart_downtime":
            add("elastic_restart", float(e.get("downtime_s") or 0.0))
    return buckets, n_steps, median_step_ms


def _events_window(events) -> float:
    """Wall estimate from journal ``ts`` stamps (epoch seconds): last event
    to first event, extended by the first event's own duration (its span
    began before its emit)."""
    ts = [float(e["ts"]) for e in (events or []) if e.get("ts") is not None]
    if len(ts) < 1:
        return 0.0
    first = min(ts)
    lead = 0.0
    for e in events:
        if float(e.get("ts", math.inf)) == first:
            lead = (float(e.get("run_ms") or 0.0)
                    + float(e.get("compile_ms") or 0.0)) / 1e3
            break
    return (max(ts) - first) + lead


def _spans_window(spans) -> float:
    """Wall from the flight-recorder ring: [earliest span start, latest
    span end] over the executor/dataset categories (perf_counter domain)."""
    t0 = t1 = None
    for s in spans or []:
        name, cat, start, dur = s[0], s[1], s[2], s[3]
        if cat not in ("executor", "dataset"):
            continue
        t0 = start if t0 is None else min(t0, start)
        t1 = start + dur if t1 is None else max(t1, start + dur)
    return 0.0 if t0 is None else t1 - t0


# ---------------------------------------------------------------- compute --

def compute(events=None, snapshot=None, spans=None,
            wall_seconds: Optional[float] = None,
            count_sync_as_productive: bool = True) -> GoodputReport:
    """Classify a wall-clock window from already-recorded telemetry.

    ``events``: journal dicts (a file's ``read_journal`` or the in-process
    ring).  ``snapshot``: an ``export.to_dict()`` metrics snapshot (source
    of the per-phase second sums).  ``spans``: ``timeline.spans()`` tuples,
    used only to derive the wall window when ``wall_seconds`` is not given
    (falls back to the journal ``ts`` range).  All sources optional -- the
    ledger degrades to whatever is available and lists what it used in
    ``report.sources``.
    """
    sources = []
    phase = _phase_sums(snapshot)
    if phase:
        sources.append("phase_seconds")
    buckets = dict(phase)
    ev_buckets, n_steps, median_step_ms = _event_buckets(
        events, have_phases=bool(phase))
    for c, s in ev_buckets.items():
        buckets[c] = buckets.get(c, 0.0) + s
    if events:
        sources.append("journal")
    tune = _autotune_sum(snapshot)
    if tune:
        buckets["autotune"] = buckets.get("autotune", 0.0) + tune
        sources.append("autotune_search_seconds")

    # The journal ring is bounded (1024 events), so event-derived sums
    # shrink once a long run ages events out.  Where a CUMULATIVE registry
    # family measures the same quantity exactly, prefer it whenever it is
    # larger (the windowed journal can only undercount): checkpoint
    # blocked time has its own histogram, skipped steps their counter.
    cum_ckpt = sum(total for _l, _n, total
                   in _hist_stats(snapshot, "checkpoint_blocked_seconds"))
    if cum_ckpt > buckets.get("checkpoint", 0.0):
        buckets["checkpoint"] = cum_ckpt
    med_s = 0.0
    if median_step_ms:
        med_s = median_step_ms / 1e3
    cum_skip = _counter_sum(snapshot, "steps_skipped_total") * med_s
    if cum_skip > buckets.get("skipped_steps", 0.0):
        buckets["skipped_steps"] = cum_skip

    # Skipped/rolled-back steps already spent their wall time inside the
    # ordinary dispatch/fetch_sync record (the executor journals the step
    # before the guardian discards its update), so their loss is a
    # RE-classification: move the estimate out of the productive buckets,
    # and count only what was actually moved -- adding the estimate on top
    # would double-count the discarded second and leave goodput unchanged.
    for cause in ("skipped_steps", "rollback"):
        est = buckets.get(cause, 0.0)
        moved = 0.0
        for src in ("dispatch", "fetch_sync"):
            take = min(est - moved, buckets.get(src, 0.0))
            if take > 0:
                buckets[src] -= take
                moved += take
        if est:
            buckets[cause] = moved

    if wall_seconds is None:
        wall_seconds = _spans_window(spans)
        if wall_seconds > 0:
            sources.append("span_window")
        else:
            wall_seconds = _events_window(events)
            if wall_seconds > 0:
                sources.append("journal_window")
            else:
                # a snapshot that went through export() carries its own
                # window (a metrics dump read back without its journal
                # must still classify)
                wall_seconds = _counter_sum(snapshot,
                                            "goodput_wall_seconds")
                if wall_seconds > 0:
                    sources.append("exported_window")
    accounted = sum(buckets.values())
    other = wall_seconds - accounted
    buckets["other"] = max(0.0, other)
    productive = PRODUCTIVE_CAUSES if count_sync_as_productive \
        else ("dispatch",)
    return GoodputReport(
        wall_seconds, {c: buckets.get(c, 0.0) for c in CAUSES},
        productive_causes=productive, n_steps=n_steps,
        median_step_ms=median_step_ms,
        overaccounted_seconds=max(0.0, -other), sources=sources)


def compute_live(registry: Optional[MetricsRegistry] = None,
                 wall_seconds: Optional[float] = None,
                 count_sync_as_productive: bool = True) -> GoodputReport:
    """Process-lifetime ledger from this process's live telemetry (what the
    ``/goodput`` endpoint reports).  The wall window comes
    from the persistent span-window anchors (``timeline.span_window()``) --
    NOT "now" (quiescent scrapes stay byte-stable) and NOT the bounded
    span ring (whose wrap on a long run would shrink the window while the
    cumulative phase sums keep growing, clamping goodput to 1.0)."""
    from . import export as _export
    from . import journal as _journal
    from . import timeline as _timeline
    if wall_seconds is None:
        t0, t1 = _timeline.span_window()
        if t0 is not None:
            wall_seconds = t1 - t0
    return compute(events=_journal.recent(),
                   snapshot=_export.to_dict(registry or REGISTRY),
                   spans=_timeline.spans(), wall_seconds=wall_seconds,
                   count_sync_as_productive=count_sync_as_productive)


# ------------------------------------------------------------- run_ledger --

class _RunLedger:
    """Scoped ledger: baseline the cumulative telemetry at entry, diff at
    report time, so one run's classification is not polluted by whatever
    else the process already ran."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 count_sync_as_productive: bool = True):
        self.registry = registry or REGISTRY
        self.count_sync_as_productive = count_sync_as_productive

    @staticmethod
    def _raw_phase(snap) -> Dict[tuple, float]:
        out: Dict[tuple, float] = {}
        for labels, _n, total in _hist_stats(snap, "phase_seconds"):
            key = (labels.get("phase"), labels.get("cat"))
            out[key] = out.get(key, 0.0) + float(total)
        return out

    def __enter__(self):
        from . import export as _export
        snap = _export.to_dict(self.registry)
        self._base_phase = self._raw_phase(snap)
        self._base_tune = _autotune_sum(snap)
        self._t0_perf = time.perf_counter()
        self._t0_epoch = time.time()
        self._t1_perf = None
        return self

    def __exit__(self, *exc):
        self._t1_perf = time.perf_counter()
        return False

    def report(self) -> GoodputReport:
        from . import export as _export
        from . import journal as _journal
        snap = _export.to_dict(self.registry)
        # synthesize a diffed snapshot for compute(): per-(phase, cat) sums
        # and the autotune total, each minus the entry baseline
        samples = []
        for key, cur in sorted(self._raw_phase(snap).items()):
            delta = cur - self._base_phase.get(key, 0.0)
            if delta > 0 and key in _PHASE_CAUSE:
                samples.append({"labels": {"phase": key[0], "cat": key[1]},
                                "count": 0, "sum": delta})
        diff_snap = {"families": []}
        if samples:
            diff_snap["families"].append(
                {"name": "phase_seconds", "type": "histogram", "help": "",
                 "samples": samples})
        tune = _autotune_sum(snap) - self._base_tune
        if tune > 0:
            diff_snap["families"].append(
                {"name": "autotune_search_seconds", "type": "histogram",
                 "help": "", "samples": [{"labels": {}, "count": 0,
                                          "sum": tune}]})
        t1 = self._t1_perf if self._t1_perf is not None \
            else time.perf_counter()
        events = [e for e in _journal.recent()
                  if float(e.get("ts", 0.0)) >= self._t0_epoch - 1e-3]
        return compute(events=events, snapshot=diff_snap,
                       wall_seconds=t1 - self._t0_perf,
                       count_sync_as_productive=self.count_sync_as_productive)


def run_ledger(registry: Optional[MetricsRegistry] = None,
               count_sync_as_productive: bool = True) -> _RunLedger:
    """``with goodput.run_ledger() as led: train(); rep = led.report()``"""
    return _RunLedger(registry, count_sync_as_productive)


# ---------------------------------------------------------------- export --

_export_lock = threading.Lock()


def export(report: Optional[GoodputReport] = None,
           registry: Optional[MetricsRegistry] = None) -> GoodputReport:
    """Publish ``report`` (default: :func:`compute_live`) into ``registry``:
    ``goodput_fraction`` / ``goodput_wall_seconds`` /
    ``goodput_productive_seconds`` gauges plus the monotone
    ``lost_seconds_total{cause}`` counters.

    Each counter is raised to the report's cumulative total for its cause
    -- the delta is anchored on the counter's OWN current value, not a
    side-channel baseline, so repeated scrapes never double-count, a
    ``registry.reset()`` starts clean, and a cause another writer already
    advanced directly (the launcher's measured restart downtime) is not
    re-added when the ledger later derives the same seconds from the
    journal."""
    registry = registry or REGISTRY
    if report is None:
        report = compute_live(registry)
    with _export_lock:
        registry.gauge("goodput_fraction",
                       "fraction of the run wall-clock spent in productive "
                       "step execution").set(report.goodput_fraction)
        registry.gauge("goodput_wall_seconds",
                       "wall-clock window the goodput ledger classified"
                       ).set(report.wall_seconds)
        registry.gauge("goodput_productive_seconds",
                       "seconds of productive step execution in the window"
                       ).set(report.productive_seconds)
        for cause, seconds in report.lost.items():
            if seconds <= 0:
                continue
            c = registry.counter(
                "lost_seconds_total",
                "goodput ledger: wall-clock seconds lost, by cause",
                cause=cause)
            delta = seconds - c.value
            if delta > 0:
                c.inc(delta)
    return report
