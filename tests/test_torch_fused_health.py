"""The health watchdog of a fused call (``Executor.run_fused``) in the port,
held against the JAX package on the CPU (the oracle is
``tests/test_fused_steps.py::test_fused_health_one_packed_read_with_substep``).

Two fused calls of K 4 over 8 steps of an SGD MLP, with an Inf fed at
step 5: one packed flag read a call, and the journal's ``tensor_nonfinite``
event names the loss with ``substep`` 5 and ``k`` 4, in both packages.
With ``PADDLE_TPU_OBS_HEALTH_STATE=1`` and no fetch, the state the
substep wrote is what is watched: the first weight that turns NaN is
named at substep 5; without it nothing is watched and nothing is read.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.observability import health as jhealth
from paddle_tpu.observability import journal as jjournal
import paddle_tpu_torch as pt
from paddle_tpu_torch.observability import health as thealth
from paddle_tpu_torch.observability import journal as tjournal


def _program(pkg, seed=17):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [8], "float32")
        label = pkg.data("label", [1], "int64")
        h = pkg.layers.fc(x, 8, act="relu")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(h, 4), label))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss


def _feeds():
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.rand(4, 8).astype("float32"),
              "label": rng.randint(0, 4, (4, 1)).astype("int64")} for _ in range(8)]
    feeds[5]["x"][0, 0] = np.inf   # the loss goes non-finite at step 5
    return feeds


def _spy(monkeypatch, mod):
    reads = []
    real = mod.read_flags
    monkeypatch.setattr(mod, "read_flags", lambda f: (reads.append(1), real(f))[1])
    return reads


def _run_port(fetch):
    main, startup, loss = _program(pt)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        main._rng_run_counter = 0
        feeds = _feeds()
        for i in range(0, 8, 4):
            exe.run_fused(main, feeds=feeds[i:i + 4], fetch_list=[loss] if fetch else [])
    return loss.name


def test_fused_health_one_packed_read_with_substep(monkeypatch):
    """NaN at step 5 under K 4: two packed reads over 8 steps, the event's
    ``substep`` 5 and ``k`` 4 naming the loss, in the port as in JAX."""
    monkeypatch.setenv("PADDLE_TPU_OBS_HEALTH", "warn")
    monkeypatch.delenv("PADDLE_TPU_OBS_HEALTH_STATE", raising=False)
    events = {}
    jreads = _spy(monkeypatch, jhealth)
    jjournal.clear()
    main, startup, loss = _program(fluid)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        feeds = _feeds()
        with pytest.warns(UserWarning, match="substep 5"):
            for i in range(0, 8, 4):
                exe.run_fused(main, feeds=feeds[i:i + 4], fetch_list=[loss])
    events["jax"] = jjournal.recent(event="tensor_nonfinite")[0]
    treads = _spy(monkeypatch, thealth)
    tjournal.clear()
    with pytest.warns(UserWarning, match="substep 5"):
        name = _run_port(fetch=True)
    events["port"] = tjournal.recent(event="tensor_nonfinite")[0]
    assert len(treads) == len(jreads) == 2
    for ev in events.values():
        assert ev["substep"] == 5 and ev["k"] == 4 and ev["var"] == name


@pytest.mark.parametrize("state", [True, False], ids=["state", "no_state"])
def test_fused_health_watches_the_state(monkeypatch, state):
    """No fetch: with ``PADDLE_TPU_OBS_HEALTH_STATE=1`` the state each
    substep wrote is flagged (the NaN gradient of step 5 reaches the first
    fc's weight at substep 5); without it nothing is watched or read."""
    monkeypatch.setenv("PADDLE_TPU_OBS_HEALTH", "warn")
    if state:
        monkeypatch.setenv("PADDLE_TPU_OBS_HEALTH_STATE", "1")
    else:
        monkeypatch.delenv("PADDLE_TPU_OBS_HEALTH_STATE", raising=False)
    reads = _spy(monkeypatch, thealth)
    tjournal.clear()
    if state:
        with pytest.warns(UserWarning, match="substep 5"):
            _run_port(fetch=False)
        ev = tjournal.recent(event="tensor_nonfinite")[0]
        assert ev["substep"] == 5 and ev["k"] == 4 and ev["var"].startswith("fc_")
        assert len(reads) == 2
    else:
        _run_port(fetch=False)
        assert not tjournal.recent(event="tensor_nonfinite") and not reads
