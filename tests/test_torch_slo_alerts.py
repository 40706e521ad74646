"""The port's SLO engine, alerts and step-time anomaly detector
(``paddle_tpu_torch/observability/{slo,alerts,anomaly}.py``) against the
JAX package's, and the endpoint and serving pool that arm them.

The rule grammar's problems must read the same; the engine, driven on an
injected clock over the same metric history in a registry of each package,
must fire and resolve the same alerts in the same order; the detector fed
the same step times must flag the same steps with the same records.
"""
import json
import urllib.request

import numpy as np
import pytest

from paddle_tpu.observability import anomaly as janomaly
from paddle_tpu.observability import metrics as jmetrics
from paddle_tpu.observability import slo as jslo
import paddle_tpu_torch as pt
from paddle_tpu_torch.observability import anomaly, metrics, server, slo

_BAD = [
    {"rules": []},
    {"format": "v0", "rules": [{"id": "a", "metric": "x", "objective": "<= 1"}]},
    {"rules": [{"metric": "x{", "objective": "~ 1", "error_budget": 2,
                "windows": [{"long_s": 10, "short_s": 20, "burn": -1, "zz": 1}, 3],
                "extra": 1}]},
    {"rules": [{"id": "a", "metric": "x", "objective": "p99 <= 5qs"},
               {"id": "a", "metric": "y", "windows": "no"}]},
    "not a document",
]


@pytest.mark.parametrize("doc", _BAD, ids=[f"bad{i}" for i in range(len(_BAD))])
def test_rule_validation_messages_equal_jax(doc):
    got, want = slo.validate_rules(doc), jslo.validate_rules(doc)
    assert got == want and got
    if isinstance(doc, dict):
        with pytest.raises(slo.SLOConfigError) as e:
            slo.parse_rules(doc)
        with pytest.raises(jslo.SLOConfigError) as je:
            jslo.parse_rules(doc)
        assert str(e.value) == str(je.value)


_RULES = {"format": "paddle_tpu_slo_rules_v1", "rules": [
    {"id": "p99", "metric": "serving_request_seconds{tenant}", "objective": "p99 <= 25ms",
     "severity": "page", "windows": [{"long_s": 8, "short_s": 2, "burn": 2.0},
                                     {"long_s": 20, "short_s": 6, "burn": 1.0,
                                      "severity": "ticket"}],
     "error_budget": 0.25},
    {"id": "nonfinite", "metric": "tensor_nonfinite_total", "objective": "== 0"},
    {"id": "errors", "metric": "serving_requests_total{outcome=\"error\"}",
     "objective": "rate <= 0.5", "severity": "ticket"},
]}


def _drive(mod_metrics, mod_slo):
    """One engine over a registry fed the same history; the transitions."""
    reg = mod_metrics.MetricsRegistry()
    engine = mod_slo.SLOEngine(mod_slo.parse_rules(_RULES), registry=reg)
    rng = np.random.RandomState(0)
    seen = []
    for t in range(40):
        slow = 10 <= t < 22
        for tenant in ("a", "b"):
            h = reg.histogram("serving_request_seconds", "latency", tenant=tenant)
            for _ in range(20):
                v = rng.uniform(0.002, 0.01)
                h.observe(v * (40 if slow and tenant == "a" else 1))
        if t == 25:
            reg.counter("tensor_nonfinite_total", "nonfinite").inc()
        reg.counter("serving_requests_total", "reqs", outcome="error").inc(
            3 if 30 <= t < 33 else 0)
        active = engine.evaluate(now=float(t))
        seen.append([a.to_dict() for a in active])
    return seen, [a.to_dict() for a in engine.alerts.history()], engine.to_doc()


def test_engine_transitions_equal_jax():
    (t_seen, t_hist, t_doc), (j_seen, j_hist, j_doc) = _drive(metrics, slo), \
        _drive(jmetrics, jslo)
    assert t_seen == j_seen and t_hist == j_hist
    assert json.dumps(t_doc, sort_keys=True) == json.dumps(j_doc, sort_keys=True)
    fired = {(a["rule"], a["window"], a["severity"]) for s in t_seen for a in s}
    assert ("p99", "8s/2s", "page") in fired and ("nonfinite", "instant", "page") in fired
    # the error rate resolves when it stops; the p99 of a cumulative histogram
    # keeps the slow period's share
    assert {a["rule"] for a in t_hist} == {"errors"}


def _times():
    rng = np.random.RandomState(1)
    out = list(0.05 + rng.normal(0, 0.002, 40))
    out[12], out[30] = 0.4, 0.2           # two hangs
    out += [0.0004 + 0.0001 * (i % 3) for i in range(20)]   # a sub-ms program's jitter
    return out


def test_anomaly_detector_flags_the_same_steps_as_jax():
    t = anomaly.StepTimeAnomalyDetector(registry=metrics.MetricsRegistry())
    j = janomaly.StepTimeAnomalyDetector(registry=jmetrics.MetricsRegistry())
    got, want = [], []
    for i, s in enumerate(_times()):
        key = "fast" if i >= 40 else "slow"
        got.append((i, t.observe("p", s, key=key)))
        want.append((i, j.observe("p", s, key=key)))
    flagged = [i for i, r in got if r is not None]
    assert [(i, r) for i, r in got if r] == [(i, r) for i, r in want if r]
    assert flagged == [12, 30]
    t.retire("slow")
    assert t.observe("p", 1.0, key="slow") is None   # a fresh window: no verdict


def test_alerts_endpoint_serves_the_armed_engine(tmp_path, monkeypatch):
    path = tmp_path / "rules.json"
    path.write_text(json.dumps({"rules": [{"id": "test", "metric": "slo_test_total",
                                           "objective": "== 0"}]}))
    monkeypatch.setenv(slo.INTERVAL_ENV, "3600")
    engine = slo.arm(str(path))
    srv = server.start(port=0, host="127.0.0.1")
    try:
        metrics.REGISTRY.counter("slo_test_total", "a test counter").inc()
        engine.evaluate(now=1.0)
        with urllib.request.urlopen(srv.url + "/alerts", timeout=10) as r:
            body = json.loads(r.read())
        assert r.status == 200 and body["armed"] is True
        assert body == json.loads(json.dumps(slo.alerts_doc(), sort_keys=True, default=str))
        assert [a["rule"] for a in body["active"]] == ["test"]
        with urllib.request.urlopen(srv.url + "/goodput", timeout=10) as r:
            assert r.status == 200 and "breakdown_seconds" in json.loads(r.read())
    finally:
        server.stop()
        slo.disarm()
    assert slo.ENGINE is None and slo.alerts_doc()["armed"] is False


def test_predictor_pool_arms_the_engine(tmp_path, monkeypatch):
    from paddle_tpu_torch.serving import PredictorPool
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [8], "float32")
        out = pt.layers.fc(x, 4)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        pt.io.save_inference_model(str(tmp_path / "m"), ["x"], [out], exe, main_program=main)
    path = tmp_path / "rules.json"
    path.write_text(json.dumps(_RULES))
    monkeypatch.setenv(slo.SLO_ENV, str(path))
    monkeypatch.setenv(slo.INTERVAL_ENV, "3600")
    pool = PredictorPool(str(tmp_path / "m"), size=1, device="cpu")
    try:
        assert slo.ENGINE is not None
        assert [r.id for r in slo.ENGINE.rules] == ["p99", "nonfinite", "errors"]
        pool.run({"x": np.ones((2, 8), "float32")}, tenant="t0", timeout=60)
        slo.ENGINE.evaluate(now=0.0)
        assert "p99" in slo.alerts_doc()["evaluations"]
    finally:
        pool.close(drain_timeout=5.0)
        slo.disarm()
    monkeypatch.delenv(slo.SLO_ENV)
    assert slo.maybe_arm() is None and slo.ENGINE is None
