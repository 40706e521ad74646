"""Flight-recorder timeline: per-step phase spans -> one Chrome trace (the
port's copy of ``paddle_tpu/observability/timeline.py``).

Hot paths (``Predictor.run``'s feed prep, dispatch and fetch) record
``phase(...)`` spans into a bounded in-process ring: an append is two
``perf_counter`` calls and a deque push, cheap enough to stay always on,
like the journal ring. Nothing is written to disk until
``export_chrome_trace`` is called, so the hot path performs no file I/O.

The exporter writes the ring's phase spans and counter samples as one
trace-event-format file (clocked by ``time.perf_counter``, so the spans of
concurrent threads interleave correctly on their own tracks); load it in
chrome://tracing or https://ui.perfetto.dev. Given the ``trace_dir`` of a
finished ``fluid.profiler`` session (``profiler.py``), it splices them into
that session's ``torch.profiler`` trace instead, re-clocked onto it, so the
card's kernels and the executor's spans share one timeline.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

# pids for the synthesized process tracks (the JAX package's)
PID_PHASES = 90001
PID_COUNTERS = 90002

_SPAN_CAP = 65536
_lock = threading.Lock()
# (name, category, t0_seconds, dur_seconds, args or None)
_spans: "collections.deque" = collections.deque(maxlen=_SPAN_CAP)
# (track_name, t_seconds, {series: value})
_counters: "collections.deque" = collections.deque(maxlen=_SPAN_CAP)
# [earliest span start, latest span end] over the executor/dataset
# categories, for the WHOLE process -- the ring above is bounded (~13k
# steps), so anything deriving a run window from ring contents alone
# (the goodput ledger) would silently shrink its wall-clock once the
# ring wraps while the cumulative phase_seconds sums keep growing
_window = [None, None]


@contextlib.contextmanager
def phase(name: str, cat: str = "executor", **args):
    """Record one flight-recorder span around the body.

    Also mirrors the duration into the ``phase_seconds`` histogram (labels
    phase=name) so obs_report can summarize phases without a trace export.
    """
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_span(name, t0, time.perf_counter() - t0, cat=cat, **args)


def record_span(name: str, t0: float, dur: float, cat: str = "executor",
                **args):
    """Append an already-timed span (t0 from time.perf_counter); mirrors
    into the ``phase_seconds`` histogram.  Labeled by phase AND category:
    executor and Predictor both record dispatch/feed_prep/fetch_sync and
    their durations differ by orders of magnitude -- one merged series
    would describe neither workload."""
    with _lock:
        # recording thread rides along: concurrent Predictor.run spans must
        # land on separate trace tracks, not garble one tid-0 line
        _spans.append((name, cat, t0, dur, args or None,
                       threading.get_ident()))
        if cat in ("executor", "dataset"):
            if _window[0] is None or t0 < _window[0]:
                _window[0] = t0
            end = t0 + max(dur, 0.0)
            if _window[1] is None or end > _window[1]:
                _window[1] = end
    from .metrics import REGISTRY
    REGISTRY.histogram("phase_seconds",
                       "flight-recorder phase durations by phase and "
                       "category", phase=name, cat=cat).observe(dur)


def counter_sample(track: str, values: Dict[str, float],
                   t: Optional[float] = None):
    """Record one sample of a counter track (e.g. device memory bytes)."""
    with _lock:
        _counters.append((track, time.perf_counter() if t is None else t,
                          dict(values)))


def spans(name: Optional[str] = None) -> List[tuple]:
    with _lock:
        out = list(_spans)
    if name is not None:
        out = [s for s in out if s[0] == name]
    return out


def counters(track: Optional[str] = None) -> List[tuple]:
    with _lock:
        out = list(_counters)
    if track is not None:
        out = [c for c in out if c[0] == track]
    return out


def span_window():
    """(earliest start, latest end) perf_counter pair over every
    executor/dataset span this process EVER recorded -- survives ring
    wrap, unlike reading the ring.  (None, None) before the first span."""
    with _lock:
        return (_window[0], _window[1])


def clear():
    with _lock:
        _spans.clear()
        _counters.clear()
        _window[0] = _window[1] = None


def _trace_events(host_pid: int = PID_PHASES) -> List[dict]:
    """The ring contents as trace-event dicts (ts/dur in microseconds).

    Under a multi-rank job the process tracks are rank-tagged, so
    per-rank exports merged later keep distinct, attributable track names
    instead of N identical lines."""
    from .journal import current_rank
    r = current_rank()
    tag = "" if r is None else f" [rank {r}]"
    events: List[dict] = [
        {"ph": "M", "pid": host_pid, "name": "process_name",
         "args": {"name": f"paddle_tpu_torch flight recorder (phases){tag}"}},
        {"ph": "M", "pid": PID_COUNTERS, "name": "process_name",
         "args": {"name": f"paddle_tpu_torch telemetry (counters){tag}"}},
    ]
    with _lock:
        span_list = list(_spans)
        counter_list = list(_counters)
    tid_map = {t: i for i, t in enumerate(
        sorted({s[5] for s in span_list if len(s) > 5}))}
    for s in span_list:
        name, cat, t0, dur, args = s[:5]
        # small stable tids (enumerate recording threads), not raw idents
        tid = tid_map[s[5]] if len(s) > 5 else 0
        ev = {"ph": "X", "pid": host_pid, "tid": tid, "name": name,
              "cat": cat, "ts": max(t0, 0.0) * 1e6, "dur": max(dur, 0.0) * 1e6}
        if args:
            ev["args"] = args
        events.append(ev)
    for track, t, values in counter_list:
        events.append({"ph": "C", "pid": PID_COUNTERS, "name": track,
                       "ts": max(t, 0.0) * 1e6, "args": values})
    return events


def _anchor_delta(records: List[tuple], ranges: List[float]) -> float:
    """The trace-minus-perf_counter offset (us) from one name's record
    events and that name's ranges, paired from the last (a late session
    drops its first records, ROADMAP fault 3.2). Each pair bounds the
    offset: the range's stamp lies between the readings before and after
    the entry. The middle of the bounds all pairs share; when they share
    none (a pairing that is off), the middle of the last pair's."""
    pairs = list(zip(reversed(records), reversed(ranges)))
    lo = max(r - t_in * 1e6 for (_t0, t_in), r in pairs)
    hi = min(r - t0 * 1e6 for (t0, _t_in), r in pairs)
    if lo <= hi:
        return (lo + hi) / 2
    (t0, t_in), r = pairs[0]
    return r - (t0 + t_in) / 2 * 1e6


def _shift_onto_trace(perf_events: List[dict], trace: dict,
                      trace_dir: Optional[str] = None) -> List[dict]:
    """Re-clock perf_counter-domain events onto a ``torch.profiler`` trace.

    The anchor, in order of precision:
    - the ``fluid.profiler`` record events (``profiler._agg.spans``) of
      the first name the trace also holds as ``record_function`` ranges:
      each event's perf_counter readings before and after the range's
      entry bound the offset, and the middle of the bounds that every pair
      shares is taken (``_anchor_delta``; the entry alone can take tens of
      microseconds, so one reading on one side of it skews every span by
      that much, ROADMAP fault 3.36);
    - ``profiler._agg.trace_anchor``, (trace_dir, perf_counter, wall clock)
      at the start of the session of that ``trace_dir``: the trace's
      timestamps are wall-clock microseconds less its
      ``baseTimeNanoseconds``;
    - else the earliest events of the two are aligned.
    Events before the capture clamp to ts 0."""
    from .. import profiler as _profiler
    events = trace.get("traceEvents", [])
    delta = None
    ranges: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges.setdefault(e.get("name"), []).append(float(e["ts"]))
    records: Dict[str, List[tuple]] = {}
    for s in sorted(_profiler._agg.spans, key=lambda s: s[1]):
        # (perf_counter before, after record_function's entry): the range's
        # stamp lies between them
        records.setdefault(s[0], []).append((s[1], s[3] if len(s) > 3 else s[1]))
    for name, recs in records.items():    # the first name both hold
        if name in ranges:
            delta = _anchor_delta(recs, sorted(ranges[name]))
            break
    anchor = getattr(_profiler._agg, "trace_anchor", None)
    base_ns = trace.get("baseTimeNanoseconds")
    if (delta is None and anchor is not None and trace_dir is not None
            and base_ns is not None
            and os.path.abspath(anchor[0]) == os.path.abspath(trace_dir)):
        # perf_counter t -> wall (t - perf0 + wall0) -> trace (wall - base)
        delta = (anchor[2] - anchor[1]) * 1e6 - float(base_ns) / 1e3
    if delta is None:
        base = min((float(e["ts"]) for e in events
                    if e.get("ph") not in ("M", None) and "ts" in e), default=None)
        t0 = min((float(e.get("ts", 0.0)) for e in perf_events if e.get("ph") != "M"),
                 default=None)
        if base is None or t0 is None:
            return perf_events
        delta = base - t0
    out = []
    for e in perf_events:
        if e.get("ph") != "M":
            e = dict(e)
            e["ts"] = max(float(e.get("ts", 0.0)) + delta, 0.0)
        out.append(e)
    return out


def _sorted_events(events: List[dict]) -> List[dict]:
    return sorted(events, key=lambda e: (e.get("ph") != "M", float(e.get("ts", 0.0))))


def export_chrome_trace(output_path: str = "timeline.json",
                        trace_dir: Optional[str] = None,
                        include_profiler: bool = True) -> str:
    """Write the flight-recorder phase spans and counter tracks as one
    Chrome-trace/Perfetto JSON timeline, with the ``fluid.profiler`` record
    events (same perf_counter clock) unless ``include_profiler`` is off;
    with the ``trace_dir`` of a finished ``fluid.profiler`` session, spliced
    into its trace instead. Returns ``output_path``."""
    from .. import profiler as _profiler
    events = _trace_events()
    if trace_dir is not None:
        src = _profiler._find_chrome_trace(trace_dir)
        if src is None:
            raise FileNotFoundError(
                f"no profiler trace (*.pt.trace.json) under {trace_dir!r}; pass the "
                f"directory given to profiler(trace_dir=...) after the session stopped, "
                f"or trace_dir=None for a host-only timeline")
        return splice_into_trace(src, events, trace_dir, output_path)
    if include_profiler:
        host = _profiler._host_span_events()
        if len(host) > 1:     # the metadata record alone: nothing behind it
            events.extend(host)
    trace = {"traceEvents": _sorted_events(events), "displayTimeUnit": "ms"}
    with open(output_path, "w") as f:
        json.dump(trace, f)
    return output_path


def splice_into_trace(src: str, perf_events: List[dict], trace_dir: Optional[str],
                      output_path: str) -> str:
    """Merge perf_counter-domain events into the ``torch.profiler`` Chrome
    trace at ``src``: re-clock them onto it, keep the trace's own top-level
    keys, sort, write."""
    with open(src) as f:
        trace = json.load(f)
    trace.setdefault("traceEvents", [])
    trace["traceEvents"] = _sorted_events(
        trace["traceEvents"] + _shift_onto_trace(perf_events, trace, trace_dir))
    with open(output_path, "w") as f:
        json.dump(trace, f)
    return output_path


def validate_trace(path: str) -> List[dict]:
    """Load ``path`` and assert it is well-formed trace-event JSON with
    monotone-sortable, non-negative ts/dur.  Returns the event list (tests
    use this instead of re-implementing the checks)."""
    with open(path) as f:
        trace = json.load(f)
    if isinstance(trace, dict):
        events = trace.get("traceEvents")
        if events is None:
            raise ValueError(
                f"{path}: no 'traceEvents' key -- not a Chrome trace "
                f"(a metrics dump? pass this file to --metrics instead)")
    else:
        events = trace
    if not isinstance(events, list):
        raise ValueError(f"{path}: traceEvents is not a list")
    last_ts = 0.0
    for e in events:
        if "ph" not in e:
            raise ValueError(f"{path}: event missing 'ph': {e}")
        if e["ph"] == "M":
            continue
        ts = float(e.get("ts", 0.0))
        if ts < 0 or float(e.get("dur", 0.0)) < 0:
            raise ValueError(f"{path}: negative ts/dur: {e}")
        if ts < last_ts:
            raise ValueError(f"{path}: events not sorted by ts at {e}")
        last_ts = ts
    return events
