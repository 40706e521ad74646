"""The port's chaos CLI (``paddle_tpu_torch/resilience/__main__.py``) against
the JAX package's (``paddle_tpu/resilience/__main__.py``) on the CPU.

The same spec and seed go through ``run_chaos`` and ``run_stream_chaos`` of
both packages in process, the port starting from the JAX startup's weights
(``init``). What the recovery layer did is equal: steps completed, the
journal's event counts, the preemption, the resume and its start step; the
losses agree within ``rtol 1e-5`` (a 4 -> 4 fc layer under SGD, summed in
other orders). The stream run's ``stream_epoch`` count is not compared: it
counts the reader's finished passes, and the interrupted pass's reader runs
to its bound in the port (three events) but not in the JAX package (two).
The oracles are ``tests/test_robustness.py::test_chaos_end_to_end_recovery``
(nan at step 3, an ``exc@dispatch`` at 5, a preemption at 7) and
``tests/test_streaming.py``'s acceptance run. One subprocess runs the port's
``--selftest --device cpu``.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import resilience as jres
from paddle_tpu.resilience import __main__ as jchaos
from paddle_tpu_torch import resilience as tres
from paddle_tpu_torch.resilience import __main__ as tchaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = "nan:step=3:var=LOSS;exc@dispatch:step=5;preempt:step=7"


@pytest.fixture(autouse=True)
def _disarm():
    yield
    for pkg in (jres, tres):
        pkg.faults.clear()
        pkg.recovery.clear_preemption()


def _jax_init(dim, seed):
    main, startup, _ = jchaos._build_workload(dim, seed)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor().run(startup)
    return {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def test_chaos_run_recovers_as_the_jax_run(tmp_path):
    kw = dict(steps=10, faults_spec=SPEC, policy="skip", seed=11, dim=4, batch=2)
    j = jchaos.run_chaos(ckpt_dir=str(tmp_path / "jax"), **kw)
    jres.faults.clear()
    jres.recovery.clear_preemption()
    t = tchaos.run_chaos(ckpt_dir=str(tmp_path / "port"), device="cpu",
                         init=_jax_init(4, 11), **kw)
    keys = ("steps_completed", "events", "preempted", "resumed", "resume_start_step")
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    assert t["steps_completed"] == 10 and t["resumed"]
    assert t["events"]["skip"] == 1 and t["events"]["retry"] == 1 and t["events"]["preempt"] == 1
    assert [f["kind"] for f in t["faults_armed"]] == [f["kind"] for f in j["faults_armed"]]
    np.testing.assert_allclose(t["final_loss"], j["final_loss"], rtol=1e-5)


def test_stream_chaos_resumes_as_the_jax_run(tmp_path):
    kw = dict(steps=8, batch=3, dim=4, seed=11, poison_rate=0.1, read_fault_prob=0.1,
              preempt_step=3, hermetic=True)
    j = jchaos.run_stream_chaos(work_dir=str(tmp_path / "jax"), **kw)
    t = tchaos.run_stream_chaos(work_dir=str(tmp_path / "port"), device="cpu",
                                init=_jax_init(4, 11), **kw)
    assert t["ok"] and j["ok"]
    keys = ("steps_completed", "poison_lines", "preempted", "resumed", "resume_start_step",
            "byte_identical", "dead_letters_attributed", "metrics_live")
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
    drop = ("stream_epoch",)
    assert ({k: v for k, v in t["events"].items() if k not in drop}
            == {k: v for k, v in j["events"].items() if k not in drop})

    def values(hexes):
        return np.array([np.frombuffer(bytes.fromhex(h), np.float32)[0] for h in hexes])

    np.testing.assert_allclose(values(t["losses_hex"]), values(j["losses_hex"]), rtol=1e-5)


def test_stream_chaos_runs_without_read_faults(tmp_path):
    s = tchaos.run_stream_chaos(steps=6, batch=3, dim=4, seed=2, poison_rate=0.1,
                                read_fault_prob=0.0, preempt_step=2,
                                work_dir=str(tmp_path), hermetic=True, device="cpu")
    assert s["ok"], s
    assert s["events"]["source_retry"] == 0


def test_ranks_exit_2_naming_item_13(capsys):
    assert tchaos.main(["--ranks", "2", "--device", "cpu"]) == 2
    assert "ROADMAP item 13" in capsys.readouterr().err


def test_cli_selftest_on_the_cpu():
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.resilience", "--selftest",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "chaos selftest: OK" in r.stdout
