"""The port's goodput ledger and the executor's flight-recorder hooks
(``paddle_tpu_torch/observability/goodput.py``, ``core/executor.py``)
against the JAX package's.

``goodput.compute`` is pure: the same journal events, metrics snapshot and
spans must give equal ``to_dict()`` in both packages. The live ledger, the
spans and the ``run`` / ``megastep`` events are read after steps of a small
MLP (and of tests/test_torch_training.py's tiny BERT) on the CPU; the JAX
executor runs the same MLP for the event keys and span names. The idle
guard: with nothing armed a step opens no file and never synchronises.
"""
import builtins
import os
import time

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.observability import goodput as jgoodput
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.observability import timeline as jtimeline
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.observability import goodput, journal, timeline
from paddle_tpu_torch.utils.checkpointer import Checkpointer

from test_torch_training import _build, _feeds

_EVENTS = [
    {"event": "run", "cache": "miss", "compile_ms": 120.0, "run_ms": 30.0, "ts": 100.0},
    {"event": "run", "cache": "hit", "run_ms": 10.0, "ts": 100.2},
    {"event": "run", "cache": "hit", "run_ms": 12.0, "ts": 100.3},
    {"event": "megastep", "cache": "hit", "k": 4, "run_ms": 40.0, "amortized_ms": 10.0,
     "ts": 100.5},
    {"event": "ckpt_save", "step": 3, "blocked_ms": 25.0, "ts": 100.6},
    {"event": "retry", "site": "dispatch", "step": 4, "backoff_ms": 50.0, "ts": 100.7},
    {"event": "skip", "step": 5, "ts": 100.8},
    {"event": "rollback", "step": 7, "to_step": 5, "ts": 100.9},
]
_SNAPSHOT = {"families": [
    {"name": "phase_seconds", "type": "histogram", "samples": [
        {"labels": {"phase": p, "cat": c}, "count": 4, "sum": s}
        for p, c, s in (("dispatch", "executor", 0.08), ("fetch_sync", "executor", 0.02),
                        ("feed_prep", "executor", 0.004), ("journal", "executor", 0.003),
                        ("compile", "executor", 0.12), ("feed_wait", "dataset", 0.01),
                        ("dispatch", "predictor", 9.0), ("megastep", "executor", 0.05))]},
    {"name": "autotune_search_seconds", "type": "histogram",
     "samples": [{"labels": {}, "count": 1, "sum": 0.2}]},
    {"name": "checkpoint_blocked_seconds", "type": "histogram",
     "samples": [{"labels": {}, "count": 2, "sum": 0.04}]},
    {"name": "steps_skipped_total", "type": "counter",
     "samples": [{"labels": {}, "value": 2.0}]}]}
_SPANS = [("compile", "executor", 10.0, 0.12, None, 1),
          ("dispatch", "executor", 10.2, 0.05, None, 1),
          ("fetch_sync", "predictor", 9.0, 5.0, None, 2),
          ("feed_wait", "dataset", 11.0, 0.01, None, 3)]


@pytest.mark.parametrize("kw", [
    dict(events=_EVENTS, snapshot=_SNAPSHOT, spans=_SPANS),
    dict(events=_EVENTS, snapshot=_SNAPSHOT, spans=_SPANS, count_sync_as_productive=False),
    dict(events=_EVENTS, snapshot=None, spans=None),
    dict(events=None, snapshot=_SNAPSHOT, spans=None, wall_seconds=2.5),
    dict(events=[], snapshot={"families": [{"name": "goodput_wall_seconds",
                                            "samples": [{"labels": {}, "value": 3.0}]}]}),
], ids=["all", "strict", "journal_only", "snapshot_wall", "exported_window"])
def test_compute_equals_jax(kw):
    t, j = goodput.compute(**kw), jgoodput.compute(**kw)
    assert t.to_dict() == j.to_dict()
    assert t.summary() == j.summary()
    assert sum(t.breakdown.values()) == pytest.approx(t.wall_seconds + t.overaccounted_seconds)


def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [16], "float32")
        y = pkg.data("y", [1], "int64")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(pkg.layers.fc(x, 32, act="relu"), 4), y))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


_MLP_FEED = {"x": np.random.RandomState(0).randn(8, 16).astype("float32"),
             "y": np.arange(8).reshape(8, 1).astype("int64") % 4}


def _obs_run(pkg, tl, jn, exe):
    main, startup, loss = _mlp(pkg)
    tl.clear()
    jn.clear()
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=_MLP_FEED, fetch_list=[loss])
        exe.run_fused(main, feeds=[_MLP_FEED] * 2, fetch_list=[loss])
    return {s[0] for s in tl.spans() if s[1] == "executor"}, jn.recent()


def test_executor_spans_and_events_carry_the_jax_names_and_keys(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_OBS", "1")
    monkeypatch.setenv("PADDLE_TPU_OBS_JOURNAL", str(tmp_path / "j.jsonl"))
    t_spans, t_events = _obs_run(pt, timeline, journal, pt.Executor(pt.CPUPlace()))
    j_spans, j_events = _obs_run(fluid, jtimeline, jjournal, fluid.Executor())
    # the JAX compile span is its XLA compile; the port's is a capture (none here)
    assert t_spans == j_spans - {"compile"} == {"feed_prep", "dispatch", "fetch_sync",
                                                "journal", "megastep"}
    for ev in ("run", "megastep"):
        t = [e for e in t_events if e["event"] == ev]
        j = [e for e in j_events if e["event"] == ev]
        assert t and set(t[-1]) == set(j[-1]), ev
    runs = [e for e in t_events if e["event"] == "run"]
    assert [e["cache"] for e in runs][-3:] == ["miss", "hit", "hit"]
    assert runs[-1]["feed"] == {"x": [[8, 16], "float32"], "y": [[8, 1], "int64"]}
    mega = [e for e in t_events if e["event"] == "megastep"][-1]
    assert (mega["k"], mega["cache"]) == (2, "hit")


def test_live_ledger_over_cpu_steps_with_a_checkpoint(monkeypatch, tmp_path):
    """Five tiny-BERT steps and one async save: every second of the window
    lands in a cause, and the save's blocked time in ``checkpoint``."""
    monkeypatch.setenv("PADDLE_TPU_OBS", "1")
    monkeypatch.setenv("PADDLE_TPU_OBS_JOURNAL", str(tmp_path / "j.jsonl"))
    main, startup, total, _ = _build(pt, tbert)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        ck = Checkpointer(exe, main, str(tmp_path / "ck"), async_save=True)
        time.sleep(0.01)     # the startup's event stamps before the ledger's 1 ms slack
        with goodput.run_ledger() as led:
            for i in range(5):
                exe.run(main, feed=_feeds(), fetch_list=[total])
                if i == 2:
                    ck.save(i)
            ck.wait()
        ck.close()
    rep = led.report()
    d = rep.to_dict()
    assert sum(rep.breakdown.values()) == pytest.approx(rep.wall_seconds, rel=1e-9)
    assert rep.overaccounted_seconds == 0.0
    assert d["n_steps"] == 5 and d["median_step_ms"] > 0
    assert rep.breakdown["checkpoint"] > 0 and rep.breakdown["dispatch"] > 0
    assert 0 < rep.goodput_fraction < 1
    assert "checkpoint" in rep.summary()
    exported = goodput.export(rep, pt.observability.metrics.MetricsRegistry())
    assert exported is rep


def test_recovery_events_carry_the_keys_the_ledger_reads(monkeypatch, tmp_path):
    """``ckpt_save``, ``retry``, ``skip`` and ``rollback`` as the port's
    checkpointer and guardian journal them feed the ledger's causes."""
    from paddle_tpu_torch.resilience import StepGuardian, faults
    monkeypatch.setenv("PADDLE_TPU_OBS", "1")
    monkeypatch.setenv("PADDLE_TPU_OBS_JOURNAL", str(tmp_path / "j.jsonl"))
    main, startup, loss = _mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    journal.clear()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        ck = Checkpointer(exe, main, str(tmp_path / "ck"))
        g = StepGuardian(exe, main, checkpointer=ck, max_retries=2, retry_backoff=0.001,
                         nonfinite_policy="rollback")
        faults.install("exc@dispatch:step=1;nan:step=3")
        try:
            for _ in range(5):
                g.run(feed=_MLP_FEED, fetch_list=[loss])
                ck.save(main._rng_run_counter)
        finally:
            faults.clear()
            g.close()
    evs = {e["event"]: e for e in journal.recent()}
    assert {"blocked_ms"} <= set(evs["ckpt_save"])
    assert {"backoff_ms"} <= set(evs["retry"])
    assert {"step", "to_step"} <= set(evs["rollback"])
    rep = goodput.compute(events=journal.recent())
    assert rep.breakdown["checkpoint"] > 0 and rep.breakdown["retry_backoff"] > 0
    assert rep.breakdown["rollback"] >= 0


def test_an_idle_step_opens_no_file_and_never_synchronises(monkeypatch, tmp_path):
    for var in ("PADDLE_TPU_OBS", "PADDLE_TPU_OBS_ATTRIB", "PADDLE_TPU_OBS_HEALTH",
                "PADDLE_TPU_OBS_SLO", "PADDLE_TPU_OBS_MEM_INTERVAL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.chdir(tmp_path)
    main, startup, loss = _mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    synced, opened = [], []
    real_open = builtins.open
    monkeypatch.setattr(pt.Executor, "_sync", lambda self: synced.append(1))
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        exe.run(main, feed=_MLP_FEED, fetch_list=[loss])        # the miss, outside the spy
        monkeypatch.setattr(builtins, "open",
                            lambda f, *a, **k: opened.append(str(f)) or real_open(f, *a, **k))
        try:
            for _ in range(3):
                exe.run(main, feed=_MLP_FEED, fetch_list=[loss])
            exe.run_fused(main, feeds=[_MLP_FEED] * 2, fetch_list=[loss])
        finally:
            monkeypatch.setattr(builtins, "open", real_open)
    assert opened == [] and synced == []
    assert list(tmp_path.iterdir()) == []
    assert timeline.spans("dispatch")       # the in-memory ring stays on
    assert not os.path.exists(journal.journal_path())
