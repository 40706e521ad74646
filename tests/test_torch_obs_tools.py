"""The port's operator tools (``paddle_tpu_torch/tools/obs_report.py``,
``postmortem.py``, ``ckpt_doctor.py``, ``timeline.py``) against the JAX
package's root ``tools/`` on the CPU.

- ``obs_report``: the JAX selftest's own inputs (its registry, journal and
  trace, caught as they reach the JAX ``render_report``) go through the
  port's ``render_report`` and give the same text, save the line that names
  the triage tool; ``load_metrics`` reads the selftest's JSON and Prometheus
  dumps as the JAX one does. Then the port's own journal and registry from
  CPU runs render every section they feed. The oracles are
  ``tests/test_observability.py``, ``tests/test_flight_recorder.py`` and
  ``tests/test_fused_steps.py``'s selftest runs.
- ``postmortem``: both triages of one port-written bundle give the same JSON
  (oracle ``tests/test_slo_blackbox.py``).
- ``ckpt_doctor``: ``verify`` of a port checkpoint tree, and ``fuzz`` of two
  copies of it with one seed, give the JAX doctor's verdicts (the packages
  share the format; oracle ``tests/test_checkpoint_durability.py``).
- ``timeline``: the CLI over a CPU profile writes a trace that
  ``validate_trace`` accepts (oracle ``tests/test_aux.py``).

Everything is exact: the tools compute no floating-point result of their
own beyond what they read.
"""
import copy
import json
import os
import shutil

import numpy as np
import pytest

from tools import ckpt_doctor as jdoctor
from tools import obs_report as jreport
from tools import postmortem as jpm
import paddle_tpu_torch as pt
from paddle_tpu_torch import flags, profiler
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.observability import export, journal, timeline
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.resilience import __main__ as tchaos
from paddle_tpu_torch.tools import ckpt_doctor, obs_report, postmortem
from paddle_tpu_torch.tools import timeline as timeline_cli

JAX_TRIAGE = "triage with: python tools/postmortem.py <bundle dir>"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    tres.faults.clear()
    tres.recovery.clear_preemption()


def test_the_jax_selftest_inputs_render_the_same_report(monkeypatch):
    calls, loads = [], []
    render, load = jreport.render_report, jreport.load_metrics

    def caught_render(*args, **kw):
        calls.append((copy.deepcopy(args), copy.deepcopy(kw)))
        return render(*args, **kw)

    def caught_load(path):
        loads.append((load(path), obs_report.load_metrics(path)))
        return loads[-1][0]

    monkeypatch.setattr(jreport, "render_report", caught_render)
    monkeypatch.setattr(jreport, "load_metrics", caught_load)
    assert jreport.selftest() == 0
    assert len(calls) == 2 and len(loads) == 2      # the full report, the Prometheus one
    for jax_snapshot, port_snapshot in loads:
        assert port_snapshot == jax_snapshot
    for args, kw in calls:
        want = render(*args, **kw)
        got = obs_report.render_report(*args, **kw)
        assert got.replace(f"triage with: {obs_report.TRIAGE}", JAX_TRIAGE) == want
    full = obs_report.render_report(*calls[0][0], **calls[0][1])
    for section in ("Run journal", "Health", "Resilience", "Serving", "Ingestion",
                    "Warm starts", "Alerts & post-mortems", "Goodput", "Fleet", "Timeline",
                    "Metrics registry"):
        assert f"== {section} ==" in full
    # the empty inputs degrade the same way, the hints aside
    for fn in ("render_health", "render_resilience", "render_checkpoint", "render_megastep",
               "render_timeline", "render_fleet", "render_alerts", "render_warmstore"):
        assert getattr(obs_report, fn)([]) == getattr(jreport, fn)([]), fn
    assert obs_report.render_memory({"families": []}) == jreport.render_memory({"families": []})


def test_the_port_selftest_and_the_bench_refusal(capsys):
    assert obs_report.selftest() == 0
    assert obs_report.main(["--bench", "BENCH_r01.json"]) == 2
    assert "benchmark" in capsys.readouterr().err


def test_the_ports_own_journal_renders_every_section_it_feeds(tmp_path, monkeypatch):
    jpath = tmp_path / "journal.jsonl"
    monkeypatch.setenv("PADDLE_TPU_OBS", "1")
    monkeypatch.setenv("PADDLE_TPU_OBS_JOURNAL", str(jpath))
    # a guarded run under faults with a checkpoint and a preemption, and a
    # streamed one with poison lines, on the CPU
    s = tchaos.run_chaos(steps=6, faults_spec="nan:step=1:var=LOSS;exc@dispatch:step=2;"
                         "preempt:step=4", seed=3, dim=4, batch=2,
                         ckpt_dir=str(tmp_path / "ck"), device="cpu")
    assert s["steps_completed"] == 6 and s["resumed"]
    tres.faults.clear()
    tres.recovery.clear_preemption()
    st = tchaos.run_stream_chaos(steps=6, batch=3, dim=4, seed=2, poison_rate=0.2,
                                 read_fault_prob=0.2, preempt_step=2,
                                 work_dir=str(tmp_path / "stream"), device="cpu")
    assert st["ok"]
    # a served model
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        y = pt.layers.fc(x, 2)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        pt.io.save_inference_model(str(tmp_path / "m"), ["x"], [y], exe, main)
    pred = pt.inference.Predictor(str(tmp_path / "m"), device="cpu")
    for _ in range(3):
        pred.run({"x": np.ones((2, 4), "float32")})
    mpath = str(tmp_path / "metrics.json")
    export.dump_json(mpath, REGISTRY)
    events = journal.read_journal(str(jpath))
    rep = obs_report.render_report(events, obs_report.load_metrics(mpath), goodput=True)
    runs = sum(1 for e in events if e["event"] == "run")
    assert runs > 0 and f"{len(events)} events: {runs} executor runs" in rep
    assert "3 predictor requests" in rep
    assert "injected fault(s): exc@dispatch x1, exc@read x" in rep
    assert "nan@fetch x1, preempt@dispatch x2" in rep
    assert "PREEMPT at step" in rep and "1 skipped nonfinite step(s)" in rep
    assert "sync save(s)" in rep
    assert "QUARANTINED clickstream:" in rep and "records ingested:" in rep
    assert "-> goodput" in rep and "predictor_request_seconds" in rep


@pytest.fixture
def fresh_observability():
    """An empty black-box journal ring and metrics registry: the bundle
    snapshots both, and they are process-wide, so fault events of test
    files that ran earlier in the same process (a warm-store file's
    ``warmstore_write`` faults) would join this bundle's causes."""
    journal.clear()
    REGISTRY.reset()
    yield


def test_both_triages_of_a_port_bundle_are_the_same(tmp_path, monkeypatch,
                                                     fresh_observability):
    monkeypatch.setenv("PADDLE_TPU_OBS_BLACKBOX", str(tmp_path / "pm"))
    # a transient fault at every dispatch from step 1 exhausts the retries
    with pytest.raises(tres.TransientFault, match="injected"):
        tchaos.run_chaos(steps=4, faults_spec="exc@dispatch:step=1:times=0", retries=1,
                         seed=3, dim=4, batch=2, device="cpu")
    (bundle_dir,) = [os.path.join(tmp_path / "pm", d) for d in os.listdir(tmp_path / "pm")]
    b = postmortem.load_bundle(bundle_dir)
    assert b == jpm.load_bundle(bundle_dir) and b["reason"] == "retries_exhausted"
    for last in (30.0, 1.0):
        mine, theirs = postmortem.triage(b, last_s=last), jpm.triage(b, last_s=last)
        assert json.dumps(mine, sort_keys=True, default=str) == \
            json.dumps(theirs, sort_keys=True, default=str)
        assert postmortem.render(mine, last) == jpm.render(theirs, last)
    top = postmortem.probable_causes(b)[0]["cause"]
    assert top.startswith("injected fault(s) exc@dispatch")
    assert postmortem.main([bundle_dir, "--format", "json"]) == 0
    assert postmortem.main([str(tmp_path / "nothing")]) == 2
    assert postmortem.selftest() == 0


def _port_tree(root, device="cpu"):
    """A 4-step port checkpoint tree of the chaos workload."""
    from paddle_tpu_torch.utils.checkpointer import Checkpointer
    main, startup, loss = tchaos._build_workload(dim=4, seed=11)
    rs = np.random.RandomState(11)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(device)
        exe.run(startup)
        ck = Checkpointer(exe, main, root, max_to_keep=4)
        for step in range(4):
            exe.run(main, feed={"x": rs.rand(2, 4).astype("float32")}, fetch_list=[loss])
            ck.save(step)
    return root


def test_the_doctors_verdicts_on_a_port_tree_are_the_jax_doctors(tmp_path):
    tree = _port_tree(str(tmp_path / "ck"))

    def strip(rep):
        """The report with its tree's path written as TREE."""
        return json.loads(json.dumps(rep, default=str).replace(rep["dir"], "TREE"))

    for level in ("size", "crc"):
        mine = ckpt_doctor.verify_tree(tree, level=level)
        assert mine["ok"] and mine["latest_complete_step"] == 3
        assert strip(mine) == strip(jdoctor.verify_tree(tree, level=level))
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    shutil.copytree(tree, a)
    shutil.copytree(tree, b)
    mine, theirs = ckpt_doctor.fuzz_tree(a, seed=7), jdoctor.fuzz_tree(b, seed=7)
    assert mine["ok"] and sorted(c["case"] for c in mine["cases"]) == \
        sorted(ckpt_doctor.FUZZ_CASES)
    assert not any(c.get("skipped") for c in mine["cases"])
    assert strip(mine) == strip(theirs)
    assert strip(ckpt_doctor.verify_tree(a)) == strip(jdoctor.verify_tree(b))
    assert ckpt_doctor.main(["verify", tree]) == 0
    assert ckpt_doctor.main(["verify", a]) == 1
    assert ckpt_doctor.main(["fuzz", tree, "--cases", "nope"]) == 2
    assert ckpt_doctor.selftest("cpu") == 0


def test_timeline_cli_writes_a_valid_trace(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(flags._REGISTRY["profile_executor"], "value", True)
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [8], "float32")
        loss = pt.layers.mean(pt.layers.fc(x, 4))
        pt.optimizer.SGD(0.1).minimize(loss)
    exe = pt.Executor(pt.CPUPlace())
    tdir = str(tmp_path / "trace")
    try:
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            with profiler.profiler("All", "total", str(tmp_path / "sum.txt"), trace_dir=tdir):
                for _ in range(2):
                    exe.run(main, feed={"x": np.ones((2, 8), "float32")}, fetch_list=[loss])
        out = str(tmp_path / "timeline.json")
        assert timeline_cli.main(["--trace_dir", tdir, "--timeline_path", out]) == 0
        assert f"wrote {out}" in capsys.readouterr().out
        events = timeline.validate_trace(out)
        assert any(e.get("name") == f"executor_run_v{main._version}" for e in events)
        assert any(e.get("pid") == timeline.PID_PHASES and e.get("name") == "dispatch"
                   for e in events)
        merged = str(tmp_path / "merged.json")
        assert timeline_cli.main(["--profile_path", f"{out},{out}",
                                  "--timeline_path", merged]) == 0
        assert timeline.validate_trace(merged)
        with pytest.raises(SystemExit):
            timeline_cli.main([])
    finally:
        profiler.reset_profiler()
