"""``fluid.profiler`` on ``torch.profiler`` (``paddle_tpu_torch/profiler.py``)
against the JAX package's ``paddle_tpu/profiler.py``.

The same record-event sequence goes through both packages' aggregates:
the summary's events, call counts and order (by calls) must match, and the
empty summary must read the same. A CPU ``torch.profiler`` session around
executor steps must export one trace holding the host ops, the record
events and the flight recorder's spans on the trace's clock; the merge of
per-process traces is the JAX one's.
"""
import json

import numpy as np
import pytest

from paddle_tpu import profiler as jprofiler
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, profiler
from paddle_tpu_torch.observability import timeline

_SEQ = ["load", "step", "step", "save", "step", "load"]


@pytest.fixture(autouse=True)
def _clean_aggregate():
    """Leave no record-event spans behind: a later host-only export in this
    process would carry them."""
    yield
    profiler.reset_profiler()
    jprofiler.reset_profiler()


def _rows(table):
    return [(ln[:40].strip(), int(ln[40:48])) for ln in table.splitlines()[1:]]


def test_record_event_aggregation_and_summary_equal_jax(tmp_path):
    for mod in (profiler, jprofiler):
        mod.reset_profiler()
    assert profiler.summary() == jprofiler.summary()              # the empty marker
    tables = []
    for mod in (profiler, jprofiler):
        mod.start_profiler("CPU")
        for name in _SEQ:
            with mod.record_event(name):
                pass
        with mod.RecordEvent("step"):
            pass
        tables.append(mod.stop_profiler("calls", str(tmp_path / f"{mod.__name__}.txt")))
    assert _rows(tables[0]) == _rows(tables[1]) == [("step", 4), ("load", 2), ("save", 1)]
    assert tables[0].splitlines()[0] == tables[1].splitlines()[0]
    with open(tmp_path / f"{profiler.__name__}.txt") as f:
        assert f.read() == tables[0]
    with pytest.raises(ValueError, match="state"):
        profiler.start_profiler("TPU")


def _mlp():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [16], "float32")
        loss = pt.layers.mean(pt.layers.fc(x, 8))
        pt.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def test_a_session_exports_one_trace_with_the_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(flags._REGISTRY["profile_executor"], "value", True)
    main, startup, loss = _mlp()
    exe = pt.Executor(pt.CPUPlace())
    feed = {"x": np.ones((4, 16), "float32")}
    tdir = tmp_path / "trace"
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        timeline.clear()
        with profiler.profiler("All", "total", str(tmp_path / "sum.txt"), trace_dir=str(tdir)):
            with pytest.raises(RuntimeError, match="already active"):
                profiler.start_profiler("All", trace_dir=str(tmp_path / "other"))
            for _ in range(3):
                exe.run(main, feed=feed, fetch_list=[loss])
    out = profiler.export_chrome_tracing(str(tdir), str(tmp_path / "timeline.json"))
    events = timeline.validate_trace(out)
    runs = [e for e in events if e.get("cat") == "user_annotation"
            and e["name"] == f"executor_run_v{main._version}"]
    spans = [e for e in events if e.get("pid") == timeline.PID_PHASES and e.get("ph") == "X"
             and e["name"] == "dispatch"]
    assert len(runs) == 3 and len(spans) == 3
    # one clock: each dispatch span sits inside its run's record-event range
    for r, s in zip(sorted(runs, key=lambda e: e["ts"]), sorted(spans, key=lambda e: e["ts"])):
        assert r["ts"] - 50 <= s["ts"] and s["ts"] + s["dur"] <= r["ts"] + r["dur"] + 50
    assert any(e.get("cat") == "cpu_op" for e in events)
    with open(tmp_path / "sum.txt") as f:
        assert f"executor_run_v{main._version}" in f.read()
    # without a trace_dir: a host-only timeline of the record events and spans
    host = timeline.validate_trace(profiler.export_chrome_tracing(
        None, str(tmp_path / "host.json")))
    assert {"dispatch", f"executor_run_v{main._version}"} <= {e.get("name") for e in host}
    with pytest.raises(FileNotFoundError):
        profiler.export_chrome_tracing(str(tmp_path / "nothing"), str(tmp_path / "x.json"))


def test_spans_keep_the_clock_when_the_first_range_was_dropped(monkeypatch):
    """A late session drops its first records: the trace holds only the
    last two of three record-event ranges of one name. The spans are
    re-clocked on the last pair, so they land where the trace has them."""
    shift_us = -9e6                              # trace ts = perf_counter us + shift
    monkeypatch.setattr(profiler._agg, "spans",
                        [("run", 10.0, 0.1), ("run", 10.2, 0.1), ("run", 10.4, 0.1)])
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "run", "ts": t * 1e6 + shift_us,
         "dur": 1e5} for t in (10.2, 10.4)]}
    spans = [{"ph": "X", "pid": timeline.PID_PHASES, "tid": 0, "name": "dispatch",
              "ts": t * 1e6 + 10.0, "dur": 5.0} for t in (10.0, 10.2, 10.4)]
    out = timeline._shift_onto_trace(spans, trace)
    assert [e["ts"] for e in out] == pytest.approx(
        [t * 1e6 + shift_us + 10.0 for t in (10.0, 10.2, 10.4)])


def test_merge_chrome_traces_equals_jax(tmp_path):
    paths = []
    for i in range(2):
        p = tmp_path / f"t{i}.json"
        p.write_text(json.dumps({"traceEvents": [
            {"ph": "M", "pid": 7, "name": "process_name", "args": {"name": f"p{i}"}},
            {"ph": "X", "pid": 7, "tid": 0, "name": "a", "ts": 10.0 - i, "dur": 1.0},
            {"ph": "X", "pid": 9, "tid": 0, "name": "b", "ts": 5.0 + i, "dur": 2.0}]}))
        paths.append(str(p))
    t = json.load(open(profiler.merge_chrome_traces(paths, str(tmp_path / "t.json"))))
    j = json.load(open(jprofiler.merge_chrome_traces(paths, str(tmp_path / "j.json"))))
    assert t == j


def test_cuda_profiler_needs_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this CPU check asserts the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA card"):
        with profiler.cuda_profiler():
            pass
