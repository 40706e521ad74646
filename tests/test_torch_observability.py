"""The port's flight-recorder timeline, registry export and ``/metrics``
endpoint (``paddle_tpu_torch/observability/{timeline,export,server}.py``)
against the JAX package's.

The same spans and metrics are recorded in both packages' registries; the
Chrome-trace events, the JSON snapshot and the Prometheus text must be
identical up to the process-track names. The endpoint is started on
``127.0.0.1`` port 0 (an ephemeral local port) and read with ``urllib``.
"""
import json
import urllib.error
import urllib.request

import pytest

from paddle_tpu.observability import export as jexport
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import timeline as jtimeline
from paddle_tpu_torch.observability import export, journal, metrics, server, timeline


def _fill(mod):
    reg = mod.MetricsRegistry()
    reg.counter("serving_requests_total", "requests", tenant="a", outcome="ok").inc(3)
    reg.gauge("serving_queue_depth", "depth").set(7)
    h = reg.histogram("serving_request_seconds", "latency", tenant="a\"b\\c")
    for v in (0.001, 0.02, 0.3, 4.0):
        h.observe(v)
    return reg


def test_export_equals_jax():
    t, j = _fill(metrics), _fill(jmetrics)
    assert export.to_prometheus(t) == jexport.to_prometheus(j)
    assert export.to_json(t) == jexport.to_json(j)
    parsed = export.parse_prometheus(export.to_prometheus(t))
    assert parsed == jexport.parse_prometheus(jexport.to_prometheus(j))
    assert parsed[("serving_request_seconds_count", (("tenant", "a\"b\\c"),))] == 4


def test_timeline_events_equal_jax(tmp_path):
    for mod in (timeline, jtimeline):
        mod.clear()
        mod.record_span("feed_prep", 1.0, 0.25, cat="predictor")
        mod.record_span("dispatch", 1.25, 0.5, cat="predictor", sig="s")
        mod.counter_sample("memory", {"bytes": 5.0}, t=2.0)
    te, je = timeline._trace_events(), jtimeline._trace_events()
    strip = lambda evs: [{k: v for k, v in e.items() if k != "args" or e["ph"] != "M"}
                         for e in evs]
    assert strip(te) == strip(je)
    assert [s[:5] for s in timeline.spans()] == [s[:5] for s in jtimeline.spans()]
    path = timeline.export_chrome_trace(str(tmp_path / "t.json"))
    events = timeline.validate_trace(path)
    assert [e["name"] for e in events if e["ph"] == "X"] == ["feed_prep", "dispatch"]
    with timeline.phase("fetch_sync", cat="predictor"):
        pass
    assert timeline.spans("fetch_sync")[0][1] == "predictor"
    timeline.clear()
    jtimeline.clear()


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_the_endpoint_serves_metrics_health_and_the_journal():
    calls = []
    server.register_refresher(lambda: calls.append(1))
    srv = server.start(port=0, host="127.0.0.1")
    try:
        assert srv is not None and srv.host == "127.0.0.1" and srv.port > 0
        metrics.REGISTRY.counter("obs_test_total", "a test counter").inc()
        journal.emit({"event": "obs_test", "n": 1})
        code, body = _get(srv.url + "/metrics")
        assert code == 200 and calls
        assert export.parse_prometheus(body)[("obs_test_total", ())] >= 1
        code, body = _get(srv.url + "/healthz")
        assert code in (200, 503) and json.loads(body)["status"] in ("ok", "unhealthy")
        code, body = _get(srv.url + "/journal?n=5")
        assert code == 200 and any(json.loads(ln)["event"] == "obs_test"
                                   for ln in body.splitlines() if ln)
        code, body = _get(srv.url + "/goodput")
        assert code == 200 and "goodput_fraction" in json.loads(body)
        code, body = _get(srv.url + "/alerts")
        assert code == 200 and json.loads(body)["armed"] is False
        assert _get(srv.url + "/nope")[0] == 404
        assert server.start() is srv          # idempotent
    finally:
        server.stop()
        server._refreshers.clear()
    assert server.current() is None


def test_maybe_start_is_one_env_read_when_unset(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_OBS_PORT", raising=False)
    assert server.maybe_start() is None and server.current() is None
    monkeypatch.setenv("PADDLE_TPU_OBS_PORT", "not-a-port")
    with pytest.warns(UserWarning, match="not a port number"):
        assert server.port_from_env() is None
