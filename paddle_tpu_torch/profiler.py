"""``fluid.profiler`` on ``torch.profiler``: host events, their aggregate
table, and one Chrome trace with the card's activities (the port's copy of
``paddle_tpu/profiler.py``).

Reference: platform/profiler.{h,cc} (RecordEvent push/pop, EnableProfiler
states), platform/device_tracer.* (CUPTI kernel records) and
tools/timeline.py (the Chrome trace).

- ``record_event(name)`` / ``RecordEvent`` time a host region, open a
  ``torch.profiler.record_function`` range of that name (so a capture shows
  it beside the kernels it launched) and, while the profiler is on, add the
  time to the aggregate table and to ``profiler_event_seconds{event}``.
- ``start_profiler(state, trace_dir)`` turns the aggregate on; with a
  ``trace_dir`` it also starts a ``torch.profiler`` session (CPU, and the
  card's CUDA activities when ``state`` is "GPU" or "All" and there is a
  card), which ``stop_profiler`` writes to ``trace_dir`` as a
  ``*.pt.trace.json`` Chrome trace.
- ``export_chrome_tracing(trace_dir, output_path)`` writes that trace with
  the flight recorder's spans (the executor's ``feed_prep``, ``dispatch``,
  ``fetch_sync``...; ``observability/timeline.py``) spliced in on the
  trace's own clock; without a ``trace_dir``, a host-only timeline of the
  record events and the spans.

One profiler session runs at a time in a process: ``start_profiler`` with a
``trace_dir`` raises while another is active, and the attribution of a
capture (``observability/attribution.py``) skips while this one is.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Optional


class _Agg(threading.local):
    def __init__(self):
        # plain dict, NOT defaultdict: a read (summary on a name that never
        # fired) must not materialize an empty row as a side effect
        self.times: Dict[str, list] = {}
        self.spans: list = []   # (name, start_s, dur_s, entered_s) for timeline export
        self.enabled = False
        self.session = None     # the active torch.profiler.profile, if any
        self.trace_dir: Optional[str] = None


_agg = _Agg()


@contextlib.contextmanager
def record_event(name: str):
    """RAII host annotation (reference RecordEvent, profiler.h:81). The
    span kept for the timeline is (name, start, seconds, entered): the
    perf_counter readings before and after ``record_function``'s entry
    bracket the instant its range is stamped in a trace (the entry alone
    takes tens of microseconds under a session), and that bracket is what
    puts the flight recorder's spans on the trace's clock."""
    import torch
    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        t_in = time.perf_counter()
        yield
    if _agg.enabled:
        dt = time.perf_counter() - t0
        _agg.times.setdefault(name, []).append(dt)
        _agg.spans.append((name, t0, dt, t_in))
        # one histogram per event label, fed from this same site, so the
        # aggregate table and the registry cannot disagree
        from .observability.metrics import REGISTRY
        REGISTRY.histogram("profiler_event_seconds",
                           "RecordEvent span durations by event label",
                           event=name).observe(dt)


class RecordEvent:
    def __init__(self, name):
        self.name = name
        self._cm = None

    def __enter__(self):
        self._cm = record_event(self.name)
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


def start_profiler(state: str = "All", trace_dir: Optional[str] = None):
    """Reference EnableProfiler. ``state`` "CPU" records host activities
    only; "GPU" and "All" also the card's (when there is one)."""
    if state not in ("CPU", "GPU", "All"):
        raise ValueError(f"profiler state {state!r} invalid; use 'CPU', 'GPU' or 'All'")
    if trace_dir:
        from .observability import attribution as _attrib
        if _agg.session is not None or _attrib.profiling_active():
            raise RuntimeError("start_profiler: a profiler session is already active "
                               "(one runs at a time in a process)")
    _agg.enabled = True
    _agg.times.clear()
    # a second session must not carry the previous one's spans
    _agg.spans.clear()
    if trace_dir:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if state != "CPU" and torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        session = torch.profiler.profile(activities=acts)
        session.start()
        _agg.session = session
        _agg.trace_dir = trace_dir
        # the session's start on the host perf_counter clock and on the wall
        # clock, keyed by trace_dir: the trace's timestamps are wall-clock
        # microseconds less its baseTimeNanoseconds, and this pair is what
        # puts the flight recorder's perf_counter spans on that clock
        _agg.trace_anchor = (trace_dir, time.perf_counter(), time.time())


def stop_profiler(sorted_key: str = "total", profile_path: Optional[str] = None):
    """Reference DisableProfiler: stop, write the session's trace into its
    ``trace_dir``, and emit the aggregate table (to ``profile_path`` when
    given, and returned; else printed, as the reference did)."""
    if _agg.session is not None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        session, _agg.session = _agg.session, None
        session.stop()
        os.makedirs(_agg.trace_dir, exist_ok=True)
        session.export_chrome_trace(os.path.join(
            _agg.trace_dir, f"paddle_tpu_torch.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
        _agg.trace_dir = None
    _agg.enabled = False
    table = summary(sorted_key)
    if profile_path:
        with open(profile_path, "w") as f:
            f.write(table)
    else:
        print(table)
    return table


def summary(sorted_key: str = "total") -> str:
    """Aggregate table; on an empty aggregate, a well-formed header and an
    explicit empty marker."""
    rows = []
    for name, ts in _agg.times.items():
        if not ts:
            continue
        rows.append((name, len(ts), sum(ts), sum(ts) / len(ts), min(ts), max(ts)))
    key_idx = {"calls": 1, "total": 2, "ave": 3, "min": 4, "max": 5}.get(sorted_key, 2)
    rows.sort(key=lambda r: r[key_idx], reverse=True)
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(s)':>12}{'Avg(s)':>12}"
             f"{'Min(s)':>12}{'Max(s)':>12}"]
    for r in rows:
        lines.append(f"{r[0]:<40}{r[1]:>8}{r[2]:>12.6f}{r[3]:>12.6f}"
                     f"{r[4]:>12.6f}{r[5]:>12.6f}")
    if not rows:
        lines.append("(no events recorded)")
    return "\n".join(lines)


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None, trace_dir: Optional[str] = None):
    """``with profiler.profiler():`` context (reference fluid/profiler.py)."""
    start_profiler(state, trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def reset_profiler():
    """Clear the aggregate; an active session is stopped and discarded."""
    _agg.times.clear()
    _agg.spans.clear()
    if _agg.session is not None:
        session, _agg.session = _agg.session, None
        session.stop()
        _agg.trace_dir = None


# --------------------------------------------------------------------------
# chrome://tracing export (reference tools/timeline.py:36 Timeline)
# --------------------------------------------------------------------------

def _find_chrome_trace(trace_dir: str) -> Optional[str]:
    import glob
    paths = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"), recursive=True)
    return max(paths, key=os.path.getmtime) if paths else None


def _host_span_events(pid: int = 90000):
    """The RecordEvent spans as Chrome trace events (perf_counter clock)."""
    events = [{"ph": "M", "pid": pid, "name": "process_name",
               "args": {"name": "paddle_tpu_torch host (RecordEvent)"}}]
    # spans append at scope EXIT (inner before outer): sort by start
    for name, t0, dt, *_ in sorted(_agg.spans, key=lambda s: s[1]):
        events.append({"ph": "X", "pid": pid, "tid": 0, "name": name,
                       "ts": max(t0, 0.0) * 1e6, "dur": max(dt, 0.0) * 1e6,
                       "cat": "host"})
    return events


def export_chrome_tracing(trace_dir: Optional[str] = None,
                          output_path: str = "timeline.json") -> str:
    """Write a chrome://tracing / Perfetto-loadable JSON timeline.

    With ``trace_dir`` (given to ``start_profiler`` / ``profiler``, after the
    session stopped): its newest trace, the card's kernels and the host's
    ops and record-event ranges, with the flight recorder's spans and
    counter tracks spliced in on the trace's clock. Without one: the record
    events and the flight-recorder spans alone. Returns ``output_path``."""
    from .observability import timeline as _obs_timeline
    src = _find_chrome_trace(trace_dir) if trace_dir else None
    if trace_dir and src is None:
        raise FileNotFoundError(
            f"no profiler trace (*.pt.trace.json) under {trace_dir!r}; pass the "
            f"directory given to profiler(trace_dir=...) after the session stopped, "
            f"or call with trace_dir=None for a host-only timeline")
    if src is not None:
        # RecordEvent spans already ride the trace as record_function ranges
        return _obs_timeline.splice_into_trace(src, _obs_timeline._trace_events(),
                                               trace_dir, output_path)
    if not _agg.spans and not _obs_timeline.spans():
        raise ValueError(
            "nothing to export: pass the trace_dir used with profiler()/start_profiler, "
            "or record host events first (FLAGS_profile_executor=1 records one span per "
            "executor run)")
    return _obs_timeline.export_chrome_trace(output_path, trace_dir=None,
                                             include_profiler=True)


def _int_pid(pid) -> Optional[int]:
    try:
        return int(pid)
    except (TypeError, ValueError):
        return None


def merge_chrome_traces(paths, output_path: str = "timeline.json") -> str:
    """Merge per-process Chrome traces into one timeline with disjoint pids
    (the reference tools/timeline.py multi-process merge: each input's pids
    are offset and labeled with the source index)."""
    import gzip
    import json

    merged = {"traceEvents": []}
    # cumulative offsets: each input's range starts past the previous
    # input's max pid, so re-merging a merged timeline cannot collide
    offset = 0
    for i, p in enumerate(paths):
        try:
            op = gzip.open(p, "rt") if str(p).endswith(".gz") else open(p)
        except OSError as e:
            raise FileNotFoundError(
                f"merge_chrome_traces: input {i} ({p!r}) cannot be opened: {e}") from e
        with op as f:
            try:
                t = json.load(f)
            except (ValueError, EOFError, OSError) as e:
                raise ValueError(
                    f"merge_chrome_traces: input {i} ({p!r}) is not valid trace JSON "
                    f"(empty or truncated capture?): {e}") from e
        events = t.get("traceEvents", [])
        pids = [n for n in (_int_pid(e["pid"]) for e in events if "pid" in e) if n is not None]
        base = offset - min(pids) if pids else offset
        for e in events:
            e = dict(e)
            if "pid" in e:
                n = _int_pid(e["pid"])
                # a named pid (torch.profiler's "Spans") stays a name, tagged
                # with its input
                e["pid"] = base + n if n is not None else f"proc{i}: {e['pid']}"
            if e.get("ph") == "M" and e.get("name") == "process_name":
                e.setdefault("args", {})
                e["args"]["name"] = f"proc{i}: {e['args'].get('name', '')}"
            merged["traceEvents"].append(e)
        offset = base + (max(pids) if pids else 0) + 1
    # each input is sorted but their ts ranges overlap: re-sort
    merged["traceEvents"].sort(key=lambda e: (e.get("ph") != "M", float(e.get("ts", 0.0))))
    with open(output_path, "w") as f:
        json.dump(merged, f)
    return output_path


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """Reference profiler.py:cuda_profiler: brackets the body with
    ``cudaProfilerStart`` / ``cudaProfilerStop`` (what an external profiler
    started with a CUDA-profiler-API capture range records). The arguments
    configured nvprof and are accepted for compatibility. Raises without a
    card."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_profiler needs a CUDA card")
    torch.cuda.profiler.start()
    try:
        yield
    finally:
        torch.cuda.profiler.stop()
