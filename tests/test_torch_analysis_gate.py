"""The port executor's verification gate and the static memory planner.

``PADDLE_TPU_VALIDATE`` / ``PADDLE_TPU_MEM_BUDGET`` at a signature's miss
(``paddle_tpu_torch/core/executor.py::_maybe_verify``), ported from
``tests/test_analysis.py``'s ``test_validate_*`` and
``tests/test_analysis_distributed.py``'s memplan and gate cases, on
``CPUPlace()``; the planner's findings and byte counts against the JAX
package's on the same programs; ``program_static_peak_bytes`` once a
signature; the ``verify`` span, counter and journal event; and the two
environment gates of ROADMAP fault 3.32 that are not the verifier's:
``PADDLE_TPU_WARMSTORE`` arms the warm store (``warmstore/``), consulted
after the gate at a signature's miss, ``PADDLE_TPU_CKPT_VERIFY=0`` skips
the size and crc32 check on load.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import analysis as janalysis
import paddle_tpu_torch as pt
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis import VerificationError, memplan
from paddle_tpu_torch.observability import REGISTRY, goodput, journal, memory, timeline


def codes(diags):
    return {d.code for d in diags}


def key(d):
    return (d.code, d.severity, d.block_idx, d.op_idx, d.op_type, d.var)


@pytest.fixture(autouse=True)
def _gate_env(monkeypatch):
    for k in ("PADDLE_TPU_VALIDATE", "PADDLE_TPU_MEM_BUDGET", "PADDLE_TPU_WARMSTORE",
              "PADDLE_TPU_CKPT_VERIFY"):
        monkeypatch.delenv(k, raising=False)
    journal.clear()


def _gate_program():
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        loss = pt.layers.mean(pt.layers.fc(x, 2))
    return main, startup, loss


def _ghost_program():
    p = pt.Program()
    b = p.global_block()
    b.create_var("x", (4,), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["ghost"]}, outputs={"Out": ["y"]}, infer_shape=False)
    return p


def _relu_program():
    p = pt.Program()
    b = p.global_block()
    b.create_var("x", (-1, 4), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    return p


def _count(monkeypatch, module, name):
    calls = {"n": 0}
    real = getattr(module, name)

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(module, name, counting)
    return calls


X2 = {"x": np.ones((2, 4), "float32")}


# ------------------------------------------------------------------ the gate --

def test_validate_unset_adds_no_per_step_work(monkeypatch):
    calls = _count(monkeypatch, analysis, "verify")
    est = _count(monkeypatch, memplan, "estimate_program_memory")
    main, startup, loss = _gate_program()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=X2, fetch_list=[loss])
    assert calls["n"] == 0 and not journal.recent(event="verify")
    assert not timeline.spans("verify") or all(
        s[4]["program"] not in (id(main), id(startup)) for s in timeline.spans("verify"))
    # the static estimate: once a signature (startup + main), never a step
    assert est["n"] == 2
    label = f"{id(main)}:v{main._version}"
    want = analysis.estimate_program_memory(main, feed_names=["x"], fetch_names=[loss.name],
                                            batch=2).peak_bytes
    assert REGISTRY.gauge("program_static_peak_bytes", program=label).value == want
    # the CPU has no graph pool: no ratio
    fam = REGISTRY.get("program_static_peak_ratio")
    assert fam is None or not any(("program", label) in k for k, _ in fam.items())


def test_validate_warn_runs_once_per_program_version(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "warn")
    calls = _count(monkeypatch, analysis, "verify")
    main, startup, loss = _gate_program()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=X2, fetch_list=[loss])
        # a new feed shape is a new signature but the same program version
        exe.run(main, feed={"x": np.ones((5, 4), "float32")}, fetch_list=[loss])
    assert calls["n"] == 2
    evs = journal.recent(event="verify")
    assert len(evs) == 2 and {e["mode"] for e in evs} == {"warn"}
    assert all("findings" in e and "error" in e for e in evs)


def test_validate_warn_warns_on_findings(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "warn")
    main, startup, loss = _gate_program()
    main.global_block().append_op("relu", inputs={"X": [loss.name]},
                                  outputs={"Out": ["deadend"]})
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        with pytest.warns(UserWarning, match="PT010"):
            exe.run(main, feed=X2, fetch_list=[loss])


def test_validate_raise_stops_before_the_run_and_on_every_retry(monkeypatch):
    """A failing program raises before any op runs and never enters the
    cache of steps, so each retry is a miss again: the memoized verdict
    raises again (one verify)."""
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "raise")
    p = _ghost_program()
    calls = _count(monkeypatch, analysis, "verify")
    ran = _count(monkeypatch, pt.core.executor, "trace_block")
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        for _ in range(3):
            with pytest.raises(VerificationError, match="PT001") as ei:
                exe.run(p, feed={"x": np.ones((4,), "float32")}, fetch_list=["y"])
            assert any(d.code == "PT001" for d in ei.value.diagnostics)
    assert calls["n"] == 1 and ran["n"] == 0 and not exe._cache


def test_validate_reverifies_on_new_fetch_intent(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "raise")
    main, startup, loss = _gate_program()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        exe.run(main, feed=X2, fetch_list=[loss])
        with pytest.raises(VerificationError, match="PT012"):
            exe.run(main, feed=X2, fetch_list=["lsss"])


def test_validate_rejects_unknown_mode(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "rasie")
    main, startup, loss = _gate_program()
    with pt.scope_guard(pt.Scope()):
        with pytest.raises(ValueError, match="PADDLE_TPU_VALIDATE"):
            pt.Executor(pt.CPUPlace()).run(startup)


def test_validate_raise_passes_clean_program_with_span_counter_and_event(monkeypatch):
    """A clean program runs under ``raise``; its verify leaves one ``verify``
    span (the goodput ledger's ``verify`` cause, to the second), the
    findings counter by severity and one journal event."""
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "raise")
    main, startup, loss = _gate_program()
    info0 = REGISTRY.counter("verifier_findings_total", severity="info").value
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        with goodput.run_ledger() as led:
            for _ in range(3):
                out, = exe.run(main, feed=X2, fetch_list=[loss])
    assert np.isfinite(out).all()
    spans = [s for s in timeline.spans("verify") if s[4]["program"] == id(main)]
    assert len(spans) == 1
    verify_s = led.report().to_dict()["breakdown_seconds"]["verify"]
    assert verify_s > 0 and verify_s == pytest.approx(spans[0][3], abs=2e-6)
    evs = [e for e in journal.recent(event="verify") if e["program"] == id(main)]
    assert len(evs) == 1 and evs[0]["mode"] == "raise" and evs[0]["error"] == 0
    assert evs[0]["info"] > 0      # PT031: x's dynamic batch dim
    assert REGISTRY.counter("verifier_findings_total", severity="info").value == \
        info0 + sum(e["info"] for e in journal.recent(event="verify"))   # main + startup


def test_run_fused_passes_its_k(monkeypatch):
    """``run_fused`` verifies with ``fuse_k=K``: a dynamic batch dim under
    fused intent is PT034 (info, so journal-only), as in the JAX package."""
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "warn")
    main, startup, loss = _gate_program()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        exe.run_fused(main, feeds=[X2, X2], fetch_list=[loss])
    ev = [e for e in journal.recent(event="verify") if e["program"] == id(main)]
    assert len(ev) == 1
    assert "PT034" in {f["code"] for f in ev[0]["findings"]}
    want = janalysis.verify(fluid.Program.from_json(main.to_json()), feed_names=["x"],
                            fetch_names=[loss.name], fuse_k=2)
    assert [(f["code"], f["var"]) for f in ev[0]["findings"]] == \
        [(d.code, d.var) for d in want]


# ------------------------------------------------------------ the planner --

def _mem_program(pkg):
    p = pkg.Program()
    b = p.global_block()
    b.create_var("x", (-1, 256), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["h"]})
    b.append_op("sigmoid", inputs={"X": ["h"]}, outputs={"Out": ["y"]})
    return p


@pytest.mark.parametrize("kw,has,lacks", [
    ({"batch": 4, "passes": "default+memplan"}, {"PT050"}, {"PT051", "PT052"}),
    ({"batch": 4, "mem_budget": 1024}, {"PT050", "PT051"}, {"PT052"}),
    ({"batch": 4, "mem_budget": 1 << 30}, {"PT050"}, {"PT051", "PT052"}),
    ({"batch": 4, "mem_budget": 16, "passes": ["dataflow"]}, {"PT051"}, set()),
    ({"mem_budget": 1 << 30}, {"PT052", "PT050"}, {"PT051"}),
], ids=["pt050_report", "pt051_over", "pt051_under", "budget_engages_planner",
        "pt052_assumed_batch"])
def test_memplan_findings_equal_jax(kw, has, lacks):
    out = {}
    for name, pkg, an in (("jax", fluid, janalysis), ("port", pt, analysis)):
        k = dict(kw)
        if k.get("passes") == "default+memplan":
            k["passes"] = an.default_passes() + ["memplan"]
        out[name] = an.verify(_mem_program(pkg), feed_names=["x"], fetch_names=["y"], **k)
    assert [d.key() for d in out["port"]] == [d.key() for d in out["jax"]]
    got = codes(out["port"])
    assert has <= got and not (lacks & got)
    d = next(d for d in out["port"] if d.code == "PT050")
    assert d.severity == "info" and "estimated peak" in d.message and "top live" in d.message
    if "PT051" in got:
        d = next(d for d in out["port"] if d.code == "PT051")
        assert d.severity == "error" and "exceeds the memory budget" in d.message


def test_estimate_accounts_liveness_and_in_place_state():
    """Exact byte accounting on hand-sized programs (the non-sharded parts
    of the JAX package's pin); a strategy raises, naming ROADMAP item 13."""
    def plain(pkg):
        p = pkg.Program()
        b = p.global_block()
        b.create_var("x", (8, 100), "float32", is_data=True)
        b.create_var("w", (100, 100), "float32", persistable=True)
        b.append_op("mul", inputs={"X": ["x"], "Y": ["w"]}, outputs={"Out": ["h"]})
        b.append_op("relu", inputs={"X": ["h"]}, outputs={"Out": ["h2"]})
        b.append_op("relu", inputs={"X": ["h2"]}, outputs={"Out": ["y"]})
        return p

    def in_place(pkg):
        p = pkg.Program()
        b = p.global_block()
        b.create_var("x", (8, 100), "float32", is_data=True)
        b.create_var("w", (100, 100), "float32", persistable=True)
        b.append_op("mul", inputs={"X": ["x"], "Y": ["w"]}, outputs={"Out": ["h"]})
        b.append_op("scale", inputs={"X": ["w"]}, outputs={"Out": ["w"]},
                    attrs={"scale": 0.99}, infer_shape=False)
        return p

    est = analysis.estimate_program_memory(plain(pt), feed_names=["x"], fetch_names=["y"])
    assert est.arg_bytes == 8 * 100 * 4 + 100 * 100 * 4
    assert est.temp_bytes == 2 * 8 * 100 * 4
    assert est.peak_bytes == est.arg_bytes + est.temp_bytes
    assert est.top[0]["name"] == "w" and est.top[0]["kind"] == "state"
    est2 = analysis.estimate_program_memory(in_place(pt), feed_names=["x"],
                                            fetch_names=["h"])
    assert est2.arg_bytes == est.arg_bytes
    assert est2.temp_bytes == 8 * 100 * 4
    for build, fetch in ((plain, "y"), (in_place, "h")):
        j = janalysis.estimate_program_memory(build(fluid), feed_names=["x"],
                                              fetch_names=[fetch])
        t = analysis.estimate_program_memory(build(pt), feed_names=["x"], fetch_names=[fetch])
        assert t.to_dict() == j.to_dict()
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        analysis.estimate_program_memory(_mem_program(pt), feed_names=["x"],
                                         fetch_names=["y"], batch=64,
                                         strategy=fluid.DistributedStrategy(
                                             mesh_shape={"dp": 8}))
    assert memplan.infer_batch(_mem_program(pt), {"x": (6, 256)}) == 6
    assert [analysis.parse_bytes(s) for s in ("67108864", "64M", "8G", "1.5G", "1K")] == \
        [67108864, 64000000, 8000000000, 1500000000, 1000]
    with pytest.raises(ValueError):
        analysis.parse_bytes("lots")


def test_gate_mem_budget_env(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "raise")
    monkeypatch.setenv("PADDLE_TPU_MEM_BUDGET", "1")
    feed = {"x": np.ones((8, 4), "float32")}
    with pt.scope_guard(pt.Scope()):
        with pytest.raises(VerificationError, match="PT051"):
            pt.Executor(pt.CPUPlace()).run(_relu_program(), feed=feed, fetch_list=["y"])
    monkeypatch.setenv("PADDLE_TPU_MEM_BUDGET", "1G")
    with pt.scope_guard(pt.Scope()):
        out, = pt.Executor(pt.CPUPlace()).run(_relu_program(), feed=feed, fetch_list=["y"])
    assert out.shape == (8, 4)


def test_mem_budget_env_arms_gate_without_validate(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MEM_BUDGET", "1")
    with pt.scope_guard(pt.Scope()):
        with pytest.warns(UserWarning, match="PT051"):
            out, = pt.Executor(pt.CPUPlace()).run(
                _relu_program(), feed={"x": np.ones((8, 4), "float32")}, fetch_list=["y"])
    assert out.shape == (8, 4)
    assert journal.recent(event="verify")[-1]["mode"] == "warn"


def test_gate_rejects_malformed_mem_budget(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_MEM_BUDGET", "lots")
    with pt.scope_guard(pt.Scope()):
        with pytest.raises(ValueError, match="PADDLE_TPU_MEM_BUDGET"):
            pt.Executor(pt.CPUPlace()).run(
                _relu_program(), feed={"x": np.ones((8, 4), "float32")}, fetch_list=["y"])


def test_static_gauge_with_a_pool_sets_the_ratio():
    """At a capture the executor hands the step's argument bytes and graph
    pool to ``update_static_memory_gauges``: the ratio is the estimate over
    their sum (the CPU has no pool; the parts stand in for one)."""
    p = _relu_program()
    est = memory.update_static_memory_gauges(p, {"x": (8, 4)}, ["x"], ["y"], "ratio:v0",
                                             {"argument_bytes": 128.0, "peak_bytes": 384.0})
    assert est.peak_bytes == 8 * 4 * 4 * 2
    assert REGISTRY.gauge("program_static_peak_bytes", program="ratio:v0").value == 256
    assert REGISTRY.gauge("program_static_peak_ratio", program="ratio:v0").value == 0.5
    assert memory.update_static_memory_gauges(None, None, [], [], "x:v0") is None


# ----------------------------------------------- fault 3.32's other gates --

def test_warmstore_env_raises_in_executor_and_predictor(monkeypatch, tmp_path):
    """Since the warm store is ported (ROADMAP item 12 (b)), the variable no
    longer raises: it arms the store, which the executor and the Predictor
    consult at a signature's miss after the gate, so a program the gate
    refuses never reaches the store. A miss offers the step's record."""
    main, startup, loss = _gate_program()
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        pt.io.save_inference_model(str(tmp_path / "m"), ["x"], [loss], exe, main)
        monkeypatch.setenv("PADDLE_TPU_WARMSTORE", str(tmp_path / "ws"))
        out, = exe.run(main, feed=X2, fetch_list=[loss])
        assert np.isfinite(out).all()
    from paddle_tpu_torch import warmstore
    from paddle_tpu_torch.inference import Predictor
    pred = Predictor(str(tmp_path / "m"), device="cpu")
    assert np.isfinite(pred.run({"x": np.ones((2, 4), "float32")})[0]).all()
    assert warmstore.flush(30.0)
    assert sorted(r["kind"] for r in warmstore.active_store().ls()) == ["predict", "train_step"]
    # the gate comes first: a program it refuses is never consulted nor offered
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "raise")
    bad = _ghost_program()
    with pytest.raises(VerificationError):
        pt.Executor(pt.CPUPlace()).run(bad, feed=X2, fetch_list=[])
    assert warmstore.flush(30.0) and len(warmstore.active_store().ls()) == 2
    warmstore.reset_for_tests()


def test_ckpt_verify_off_skips_the_crc_check(monkeypatch, tmp_path):
    main, startup, loss = _gate_program()
    d = str(tmp_path / "ck")
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        pt.io.save_persistables(exe, d, main)
    manifest = json.load(open(os.path.join(d, next(f for f in os.listdir(d)
                                                   if f.endswith(".json")))))
    entry = next(v for v in manifest["vars"] if len(v["shape"]) == 2)
    path = os.path.join(d, entry["chunks"][0]["file"])
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0x40                      # a bit flip in the last element
    open(path, "wb").write(bytes(data))
    with pt.scope_guard(pt.Scope()):
        with pytest.raises(pt.io.CheckpointCorruption, match="crc"):
            pt.io.load_persistables(pt.Executor(pt.CPUPlace()), d, main)
    monkeypatch.setenv("PADDLE_TPU_CKPT_VERIFY", "0")
    fresh = pt.Scope()
    with pt.scope_guard(fresh):
        pt.io.load_persistables(pt.Executor(pt.CPUPlace()), d, main)
    got, saved = fresh.find_var(entry["name"]).numpy(), scope.find_var(entry["name"]).numpy()
    assert got.shape == saved.shape and not np.array_equal(got, saved)
    monkeypatch.setenv("PADDLE_TPU_CKPT_VERIFY", "sometimes")
    with pt.scope_guard(pt.Scope()):
        with pytest.raises(ValueError, match="PADDLE_TPU_CKPT_VERIFY"):
            pt.io.load_persistables(pt.Executor(pt.CPUPlace()), d, main)
