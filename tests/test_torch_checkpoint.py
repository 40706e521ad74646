"""Checkpoints (``utils/checkpointer.py``, ``io.snapshot_persistables`` /
``write_snapshot`` / ``verify_checkpoint``) and the step guardian
(``resilience/recovery.py``, ``resilience/faults.py``,
``observability/health.py`` and ``blackbox.py``) on the CPU, against the
JAX package.

Tolerances: the on-disk format is shared, so a directory saved by either
package verifies and restores in the other bit for bit. Training in the two
packages differs by the frameworks' f32 sums: losses ``rtol 1e-5``, state
``atol 5e-5`` (as ``tests/test_torch_ctr.py``). The port against itself
(a retried, skipped, rolled-back or resumed run against the clean or
uninterrupted one) runs the same lowerings on the same tensors: bit for
bit.
"""
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import io as jio
from paddle_tpu.data import FileTailSource as JFileTailSource
from paddle_tpu.data import StreamingDataset as JStreamingDataset
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.resilience import recovery as jrecovery
from paddle_tpu.utils.checkpointer import Checkpointer as JCheckpointer
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.data import FileTailSource, StreamingDataset
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.observability import blackbox, journal
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.resilience import StepGuardian, faults, recovery
from paddle_tpu_torch.utils.checkpointer import Checkpointer
from tests.test_torch_graph_step import stand_in  # noqa: F401  (the fixture)


@pytest.fixture(autouse=True)
def _pristine():
    for f in (faults, jfaults):
        f.clear()
    for r in (recovery, jrecovery):
        r.clear_preemption()
    yield
    for f in (faults, jfaults):
        f.clear()
    for r in (recovery, jrecovery):
        r.clear_preemption()
        r.uninstall_signal_handlers(force=True)


def _mlp(pkg, dropout=0.0):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [4], "float32")
        h = pkg.layers.fc(x, 8, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout_prob=dropout)
        loss = pkg.layers.mean(pkg.layers.fc(h, 1))
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss


def _feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(6, 4).astype("float32")} for _ in range(n)]


def _names(main):
    return sorted(n for n, v in main.global_block().vars.items() if v.persistable)


def _port_init(main, startup):
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {n: scope.find_var(n).clone() for n in _names(main)}


def _scope(init):
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    return scope


def _state(scope, names):
    return {n: scope.find_var(n).clone() for n in names}


def _equal(a, b):
    return [n for n in a if not torch.equal(a[n], b[n])]


# ---------------------------------------------------------------- the layout


def test_layout_rotation_and_verify_equal_jax(tmp_path):
    """Saves every step keep the newest 3 ``ckpt-N`` dirs, LATEST and each
    ``trainstate.json``; ``verify_checkpoint`` reports what the JAX
    package's reports on the same directory, at both levels."""
    main, startup, loss = _mlp(pt)
    scope, exe = _scope(_port_init(main, startup)), pt.Executor(pt.CPUPlace())
    d = str(tmp_path / "ck")
    with pt.scope_guard(scope):
        ck = Checkpointer(exe, main, d, save_interval_steps=1, max_to_keep=3)
        for step, f in enumerate(_feeds(5)):
            exe.run(main, feed=f, fetch_list=[loss])
            ck.maybe_save(step)
    assert sorted(os.listdir(d)) == ["LATEST", "ckpt-2", "ckpt-3", "ckpt-4"]
    assert json.load(open(os.path.join(d, "LATEST")))["step"] == 4
    doc = json.load(open(os.path.join(d, "ckpt-4", "trainstate.json")))
    assert doc["step"] == 4 and doc["rng_counter"] == 5 and ck.latest_step() == 4
    for level in ("size", "crc"):
        mine = pt.io.verify_checkpoint(os.path.join(d, "ckpt-4"), level=level)
        theirs = jio.verify_checkpoint(os.path.join(d, "ckpt-4"), level=level)
        assert mine == theirs and mine["ok"]


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_a_checkpoint_restores_in_the_other_package(tmp_path, saver):
    """One package trains 3 steps and saves through its ``Checkpointer``;
    the other restores it: every state tensor bit for bit and the run
    counter."""
    jm, js, jl = _mlp(fluid)
    tm, ts, tl = _mlp(pt)
    names = _names(tm)
    d = str(tmp_path / "ck")
    feeds = _feeds(3)
    if saver == "jax":
        jscope, jexe = fluid.Scope(), fluid.Executor()
        with fluid.scope_guard(jscope):
            jexe.run(js)
            for f in feeds:
                jexe.run(jm, feed=f, fetch_list=[jl])
            JCheckpointer(jexe, jm, d).save(2)
        saved = {n: np.asarray(jscope.find_var(n)) for n in names}
        scope = _scope(_port_init(tm, ts))
        with pt.scope_guard(scope):
            ck = Checkpointer(pt.Executor(pt.CPUPlace()), tm, d)
            assert ck.restore() == 2
        for n in names:
            np.testing.assert_array_equal(scope.find_var(n).numpy(), saved[n], err_msg=n)
        assert tm._rng_run_counter == 3 and ck.train_state["step"] == 2
    else:
        scope, exe = _scope(_port_init(tm, ts)), pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            for f in feeds:
                exe.run(tm, feed=f, fetch_list=[tl])
            Checkpointer(exe, tm, d, async_save=True).save(2)
        saved = _state(scope, names)
        jscope, jexe = fluid.Scope(), fluid.Executor()
        with fluid.scope_guard(jscope):
            jexe.run(js)
            assert JCheckpointer(jexe, jm, d).restore() == 2
        for n in names:
            np.testing.assert_array_equal(np.asarray(jscope.find_var(n)), saved[n].numpy(),
                                          err_msg=n)
        assert jm._rng_run_counter == 3


def test_an_async_save_writes_the_sync_bytes_from_a_host_snapshot(tmp_path, monkeypatch):
    """The async save's snapshot holds numpy arrays only (the writer thread
    touches no tensor) taken before the next step's in-place update; its
    chunks equal the sync save's byte for byte; a writer's error surfaces
    on ``wait``."""
    main, startup, loss = _mlp(pt)
    scope, exe = _scope(_port_init(main, startup)), pt.Executor(pt.CPUPlace())
    seen = []
    real = pt.io.write_snapshot

    def spy(snap, d, filename=None):
        seen.append((threading.current_thread().name,
                     all(isinstance(c["data"], np.ndarray) for e in snap["entries"]
                         for c in e["chunks"])))
        return real(snap, d, filename)
    monkeypatch.setattr(pt.io, "write_snapshot", spy)
    with pt.scope_guard(scope):
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss])
        Checkpointer(exe, main, str(tmp_path / "sync")).save(0)
        ack = Checkpointer(exe, main, str(tmp_path / "async"), async_save=True)
        ack.save(0)
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss])   # updates in place
        ack.wait()
    assert seen == [("checkpointer-writer", True)]
    a, s = tmp_path / "async" / "ckpt-0", tmp_path / "sync" / "ckpt-0"
    files = sorted(f for f in os.listdir(s) if f.endswith(".npy"))
    assert files == sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    assert all((a / f).read_bytes() == (s / f).read_bytes() for f in files)

    def broken(snap, d, filename=None):
        raise OSError("disk full")
    monkeypatch.setattr(pt.io, "write_snapshot", broken)
    with pt.scope_guard(scope):
        ack.save(1)
        with pytest.raises(OSError, match="disk full"):
            ack.wait()
    assert ack._last_save_step is None


@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_a_damaged_checkpoint_is_quarantined_and_skipped(tmp_path, kind):
    """A chunk the save damaged fails its check and ``restore`` falls
    through to the step before: a chunk cut in half fails the size scan
    (the step never counts as complete), a bit flip the crc32 read at load
    (the step is quarantined as ``ckpt-N.corrupt``). The JAX package's
    scan sees the same newest complete step on the same directory."""
    main, startup, loss = _mlp(pt)
    scope, exe = _scope(_port_init(main, startup)), pt.Executor(pt.CPUPlace())
    d = str(tmp_path / "ck")
    with pt.scope_guard(scope):
        ck = Checkpointer(exe, main, d)
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss])
        ck.save(0)
        good = _state(scope, _names(main))
        exe.run(main, feed=_feeds(1)[0], fetch_list=[loss])
        faults.install(f"{kind}:step=1:seed=3")
        ck.save(1)
        faults.clear()
        assert not pt.io.verify_checkpoint(os.path.join(d, "ckpt-1"))["ok"]
        latest = Checkpointer(exe, main, d).latest_step()
        assert latest == JCheckpointer(None, None, d).latest_step() == \
            (1 if kind == "corrupt" else 0)
        before = REGISTRY.counter("checkpoint_quarantine_total").value
        assert Checkpointer(exe, main, d).restore() == 0
    assert not _equal(_state(scope, _names(main)), good)
    quarantined = kind == "corrupt"
    assert os.path.isdir(os.path.join(d, "ckpt-1.corrupt")) == quarantined
    assert REGISTRY.counter("checkpoint_quarantine_total").value == before + quarantined
    if quarantined:
        assert journal.recent(event="ckpt_quarantine")[-1]["step"] == 1


# ----------------------------------------------------------------- the guardian


def test_a_retried_dropout_step_draws_the_same_masks():
    """A transient fault at dispatch is retried with the run counter
    rewound: the run with dropout 0.5 equals the clean run bit for bit,
    losses and state."""
    main, startup, loss = _mlp(pt, dropout=0.5)
    init = _port_init(main, startup)
    out = {}
    for spec in (None, "exc@dispatch:step=2"):
        scope = _scope(init)
        main._rng_run_counter = 0
        if spec:
            faults.install(spec)
        r0 = REGISTRY.counter("step_retries_total", site="dispatch").value
        with pt.scope_guard(scope):
            g = StepGuardian(pt.Executor(pt.CPUPlace()), main, retry_backoff=0.001)
            losses = [g.run(feed=f, fetch_list=[loss])[0] for f in _feeds(4)]
        out[spec] = (losses, _state(scope, init), main._rng_run_counter,
                     REGISTRY.counter("step_retries_total", site="dispatch").value - r0)
        faults.clear()
    (cl, cs, cc, cr), (fl, fs, fc, fr) = out[None], out["exc@dispatch:step=2"]
    assert all(np.array_equal(a, b) for a, b in zip(cl, fl)) and not _equal(cs, fs)
    assert cc == fc == 4 and (cr, fr) == (0, 1)


@pytest.mark.parametrize("path", ["eager", "graph", "fused"])
def test_a_fault_after_the_step_is_retried_on_the_state_before_it(path, request):
    """``exc@fetch`` fires after the step has updated the scope in place:
    the executor puts the state the step wrote back before it raises, so
    the guardian's retry equals the clean run bit for bit (losses, state,
    counter), with dropout 0.5, eagerly, on the CPU stand-in graph and
    under ``run_fused`` (whose substeps each have their fetch site)."""
    if path == "graph":
        request.getfixturevalue("stand_in")
    main, startup, loss = _mlp(pt, dropout=0.5)
    init = _port_init(main, startup)
    feeds = _feeds(4)
    out = {}
    for spec in (None, "exc@fetch:step=3"):
        scope = _scope(init)
        main._rng_run_counter = 0
        if spec:
            faults.install(spec)
        r0 = REGISTRY.counter("step_retries_total", site="fetch").value
        with pt.scope_guard(scope):
            g = StepGuardian(pt.Executor(pt.CPUPlace()), main, retry_backoff=0.001)
            if path == "fused":
                losses = [g.run_fused(feeds=feeds[i:i + 2], fetch_list=[loss])[0]
                          for i in (0, 2)]
            else:
                losses = [g.run(feed=f, fetch_list=[loss])[0] for f in feeds]
        out[spec] = (losses, _state(scope, init), main._rng_run_counter,
                     REGISTRY.counter("step_retries_total", site="fetch").value - r0)
        faults.clear()
    (cl, cs, cc, cr), (fl, fs, fc, fr) = out[None], out["exc@fetch:step=3"]
    assert all(np.array_equal(a, b) for a, b in zip(cl, fl)) and not _equal(cs, fs)
    assert cc == fc == 4 and (cr, fr) == (0, 1)


def test_a_fetch_fault_retry_equals_the_jax_clean_run():
    """The port's ``exc@fetch`` retry against the JAX package's run without
    the fault, from the same state: losses ``rtol 1e-5``, state ``atol
    5e-5``. (The JAX package's own retry of that fault raises: its step
    donated the state buffers it did not commit, ROADMAP fault 3.17.)"""
    jm, js, jl = _mlp(fluid)
    tm, _, tl = _mlp(pt)
    names = _names(tm)
    feeds = _feeds(4)
    jscope, jexe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jl_ = [jexe.run(jm, feed=f, fetch_list=[jl])[0] for f in feeds]
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(scope):
        faults.install("exc@fetch:step=2")
        g = StepGuardian(pt.Executor(pt.CPUPlace()), tm, retry_backoff=0.001)
        tl_ = [g.run(feed=f, fetch_list=[tl])[0] for f in feeds]
    assert [f.fired for f in faults.active()] == [1] and tm._rng_run_counter == 4
    np.testing.assert_allclose(tl_, jl_, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                                   atol=5e-5, err_msg=n)


def test_the_skip_policy_drops_exactly_the_bad_update():
    main, startup, loss = _mlp(pt)
    init = _port_init(main, startup)
    feeds = _feeds(4)
    scope = _scope(init)
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        g = StepGuardian(pt.Executor(pt.CPUPlace()), main, nonfinite_policy="skip")
        faults.install(f"nan:step=2:var={loss.name}")
        losses = [g.run(feed=f, fetch_list=[loss])[0] for f in feeds]
    assert np.isnan(losses[2]).all() and np.isfinite(losses[3]).all()
    ref = _scope(init)
    main._rng_run_counter = 0
    with pt.scope_guard(ref):
        exe = pt.Executor(pt.CPUPlace())
        for i, f in enumerate(feeds):
            if i == 2:
                main._rng_run_counter += 1     # the skipped step's counter
                continue
            exe.run(main, feed=f, fetch_list=[loss])
    assert not _equal(_state(scope, init), _state(ref, init))
    ev = journal.recent(event="skip")[-1]
    assert ev["step"] == 2 and ev["source"] == "ring"


def test_the_rollback_policy_matches_jax():
    """``rollback`` with snapshots every 2 steps: a NaN at step 3 restores
    the step-2 snapshot and its counter, in both packages; the states after
    the next step agree."""
    jm, js, jl = _mlp(fluid)
    tm, ts, tl = _mlp(pt)
    names = _names(tm)
    feeds = _feeds(5)
    jscope, jexe = fluid.Scope(), fluid.Executor()
    with fluid.scope_guard(jscope):
        jexe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jg = jrecovery.StepGuardian(jexe, jm, nonfinite_policy="rollback", snapshot_interval=2)
        jfaults.install(f"nan:step=3:var={jl.name}")
        jl_ = [jg.run(feed=f, fetch_list=[jl])[0] for f in feeds]
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(scope):
        g = StepGuardian(pt.Executor(pt.CPUPlace()), tm, nonfinite_policy="rollback",
                         snapshot_interval=2)
        faults.install(f"nan:step=3:var={tl.name}")
        tl_ = [g.run(feed=f, fetch_list=[tl])[0] for f in feeds]
    assert tm._rng_run_counter == jm._rng_run_counter == 3
    ev = journal.recent(event="rollback")[-1]
    assert ev["to_step"] == 2 and ev["source"] == "ring"
    np.testing.assert_allclose([x for i, x in enumerate(tl_) if i != 3],
                               [x for i, x in enumerate(jl_) if i != 3], rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                                   atol=5e-5, err_msg=n)


def test_the_health_watchdog_raises_and_the_guardian_consumes_its_verdict(monkeypatch):
    """``PADDLE_TPU_OBS_HEALTH=raise``: a NaN state tensor raises inside the
    step (one packed flag vector, state included); under ``skip`` the
    guardian takes the watchdog's verdict and drops the update."""
    from paddle_tpu_torch.observability import health
    main, startup, loss = _mlp(pt)
    init = _port_init(main, startup)
    w = main.all_parameters()[0].name
    monkeypatch.setenv("PADDLE_TPU_OBS_HEALTH", "raise")
    monkeypatch.setenv("PADDLE_TPU_OBS_HEALTH_STATE", "1")
    assert health.nonfinite_names([("a", torch.ones(2)), ("b", torch.tensor([np.nan])),
                                   ("c", np.array([np.inf])), ("i", torch.ones(2).long())]) \
        == ["b", "c"]
    scope = _scope(init)
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        faults.install(f"nan:step=0:var={w}")
        with pytest.raises(FloatingPointError, match=w):
            exe.run(main, feed=_feeds(1)[0], fetch_list=[loss])
    scope = _scope(init)
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        g = StepGuardian(pt.Executor(pt.CPUPlace()), main, nonfinite_policy="skip")
        faults.install(f"nan:step=1:var={w}")
        g.run(feed=_feeds(1)[0], fetch_list=[loss])
        before = _state(scope, init)
        out = g.run(feed=_feeds(1)[0], fetch_list=[loss])
    assert np.isnan(out[0]).all() and not _equal(_state(scope, init), before)
    assert journal.recent(event="skip")[-1]["vars"] == [w]


def test_a_hung_step_times_out_and_a_terminal_error_writes_a_bundle(tmp_path, monkeypatch):
    main, startup, loss = _mlp(pt)
    scope = _scope(_port_init(main, startup))
    monkeypatch.setenv("PADDLE_TPU_OBS_BLACKBOX", str(tmp_path / "pm"))
    blackbox.reset()
    with pt.scope_guard(scope):
        g = StepGuardian(pt.Executor(pt.CPUPlace()), main, step_timeout=0.2)
        faults.install("hang@fetch:seconds=0.5")
        with pytest.raises(recovery.StepTimeout):
            g.run(feed=_feeds(1)[0], fetch_list=[loss])
        faults.clear()
        for t in threading.enumerate():     # the hung step ends on its own
            if t.name == "resilience-step":
                t.join(timeout=5)
                assert not t.is_alive()
        g2 = StepGuardian(pt.Executor(pt.CPUPlace()), main, max_retries=1,
                          retry_backoff=0.001)
        faults.install("exc@dispatch:times=0")
        with pytest.raises(faults.TransientFault):
            g2.run(feed=_feeds(1)[0], fetch_list=[loss])
    bundles = sorted(os.listdir(tmp_path / "pm"))
    docs = [json.load(open(tmp_path / "pm" / b / "bundle.json")) for b in bundles]
    # a deadline writes its own bundle and, raised through the step, a
    # terminal one, as in the JAX package
    assert [d["reason"] for d in docs] == ["step_timeout", "terminal_error",
                                           "retries_exhausted"]
    assert {"journal", "metrics", "timeline", "alerts", "executors",
            "attribution"} <= set(docs[1])
    # the retry counter is registered at the first retry (as in the JAX
    # package): the bundle of the guardian that retried holds it
    assert "step_retries_total" in docs[2]["metrics"]


def test_signal_handlers_route_sigterm_to_the_preemption_flag():
    prev = signal.getsignal(signal.SIGTERM)
    assert recovery.install_signal_handlers()
    assert recovery.install_signal_handlers()          # a second holder
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert recovery.preemption_requested()
        recovery.uninstall_signal_handlers()
        assert signal.getsignal(signal.SIGTERM) is not prev   # one holder left
    finally:
        recovery.uninstall_signal_handlers()
    assert signal.getsignal(signal.SIGTERM) is prev
    box = []
    t = threading.Thread(target=lambda: box.append(recovery.install_signal_handlers()))
    t.start()
    t.join(timeout=5)
    assert box == [False] and signal.getsignal(signal.SIGTERM) is prev


def test_a_restore_writes_into_the_bound_tensors_without_recapture(tmp_path, stand_in):
    """On the CPU stand-in graph: after a restore the scope holds the very
    tensors the captured step reads (copied into, not rebound), nothing is
    recaptured, and the steps after it repeat the ones after the save."""
    main, startup, loss = _mlp(pt, dropout=0.3)
    names = _names(main)
    scope, exe = _scope(_port_init(main, startup)), pt.Executor(pt.CPUPlace())
    feeds = _feeds(3)
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        for f in feeds:
            exe.run(main, feed=f, fetch_list=[loss])
        ck = Checkpointer(exe, main, str(tmp_path / "ck"), async_save=True)
        ck.save(2)
        after = [exe.run(main, feed=f, fetch_list=[loss])[0] for f in feeds]
        final = _state(scope, names)
        (step,) = exe._cache.values()
        bound = {n: scope.find_var(n) for n in names}
        assert ck.restore() == 2
        assert all(scope.find_var(n) is bound[n] for n in names)
        again = [exe.run(main, feed=f, fetch_list=[loss])[0] for f in feeds]
    assert stand_in.captures == 1 and exe._cache[next(iter(exe._cache))] is step
    assert all(np.array_equal(a, b) for a, b in zip(after, again))
    assert not _equal(_state(scope, names), final)


def test_the_guardian_refuses_autotuned_fusion_and_fuses_a_plain_program():
    main, startup, loss = _mlp(pt)
    init = _port_init(main, startup)
    feeds = _feeds(4)
    scope = _scope(init)
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        g = StepGuardian(pt.Executor(pt.CPUPlace()), main)
        fused = g.run_fused(feeds=feeds, fetch_list=[loss])
        # fuse_steps=0 reads the autotuner's cached decision (the guardian never
        # searches); an epoch of no batches runs nothing
        assert g.train_from_dataset(
            dataset=pt.DatasetFactory().create_dataset("QueueDataset"), fuse_steps=0) is None
    ref = _scope(init)
    main._rng_run_counter = 0
    with pt.scope_guard(ref):
        exe = pt.Executor(pt.CPUPlace())
        losses = [exe.run(main, feed=f, fetch_list=[loss])[0] for f in feeds]
    assert np.array_equal(fused[0].reshape(-1), np.concatenate(losses).reshape(-1))
    assert not _equal(_state(scope, init), _state(ref, init)) and g.step == 4


# --------------------------------------------------- preempt, restore, resume


def _write_parts(tmp_path, n_parts, rows, seed=0):
    rng = np.random.RandomState(seed)
    paths = []
    for k in range(n_parts):
        paths.append(str(tmp_path / f"part-{k}.txt"))
        with open(paths[-1], "w") as f:
            for _ in range(rows):
                f.write(" ".join(map(str, rng.randint(0, 40, 4))) + ";"
                        + " ".join(f"{x:.4f}" for x in rng.rand(3)) + ";"
                        + str(rng.randint(0, 2)) + "\n")
    return paths


def _deepfm(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids, dense = pkg.data("ids", [4], "int64"), pkg.data("dense", [3], "float32")
        label = pkg.data("label", [1], "int64")
        loss, auc, _ = model.deepfm(ids, dense, label, num_fields=4, vocab_size=40,
                                    embed_dim=4, hidden=(8, 8))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss, auc, [ids, dense, label]


def _guarded_run(pt_or_fluid, mods, main, loss, auc, scope, exe, make_ds, ck_dir, spec, steps,
                 start=0, seek=None, restore=False):
    """Guarded steps from a stream: (restored step, Preempted or None)."""
    ckpt, guardian, flt, scope_guard = mods
    ck = ckpt(exe, main, ck_dir, save_interval_steps=3, async_save=True)
    with scope_guard(scope):
        restored = ck.restore() if restore else -1
        ds = make_ds(steps - restored - 1)
        if restore:
            ds.seek(ck.train_state["stream"])
        g = guardian(exe, main, checkpointer=ck, start_step=restored + 1,
                     retry_backoff=0.001)
        if spec:
            flt.install(spec)
        try:
            g.train_from_dataset(dataset=ds, fetch_list=[loss, auc])
            pre = None
        except Exception as e:  # noqa: BLE001 -- Preempted of either package
            if "Preempted" not in type(e).__name__:
                raise
            pre = e
        finally:
            flt.clear()
        ck.close()
        g.close()
    return restored, pre


@pytest.mark.parametrize("sources", [1, 3])
def test_preempt_restore_seek_resumes_a_tiny_deepfm_exactly(tmp_path, sources):
    """A transient fault at dispatch, a corrupt record at parse and a
    preemption at step 6 under the guardian with an async checkpointer;
    a fresh executor and dataset restore, seek the watermark and run to
    step 12: every state tensor (parameters, Adam moments, the AUC
    histograms) and the counter equal the uninterrupted run's, bit for bit.
    One source: also the JAX package's uninterrupted run (three sources
    merge in arrival order there, not reproducibly)."""
    tm, ts, tl, ta, tvars = _deepfm(pt, tdeepfm)
    paths = _write_parts(tmp_path, sources, 120 // sources)
    names = _names(tm)
    init = _port_init(tm, ts)
    spec = "exc@dispatch:step=2;corrupt@parse:step=9"
    mods = (Checkpointer, StepGuardian, faults, pt.scope_guard)

    def make_ds(bound, pkg_ds=StreamingDataset, src=FileTailSource, use=tvars, **kw):
        ds = pkg_ds(**kw)
        for p in paths:
            ds.add_source(src(p, name=os.path.basename(p)))
        ds.set_use_var(use)
        ds.set_batch_size(8)
        ds.set_bad_sample_policy("quarantine", dead_letter_path=str(tmp_path / "dl.jsonl"))
        ds.set_epoch_bound(steps=bound)
        return ds
    port_ds = lambda b: make_ds(b, ordered=True)  # noqa: E731

    def fresh():
        tm._rng_run_counter = 0
        return _scope(init), pt.Executor(pt.CPUPlace())
    scope_u, exe = fresh()
    _guarded_run(pt, mods, tm, tl, ta, scope_u, exe, port_ds, str(tmp_path / "u"), spec, 12)
    final_u, counter_u = _state(scope_u, names), tm._rng_run_counter
    scope_p, exe = fresh()
    _, pre = _guarded_run(pt, mods, tm, tl, ta, scope_p, exe, port_ds, str(tmp_path / "p"),
                          spec + ";preempt:step=6", 12)
    assert pre is not None and pre.saved_step == 6
    recovery.clear_preemption()
    scope_r, exe = fresh()
    restored, pre = _guarded_run(pt, mods, tm, tl, ta, scope_r, exe, port_ds,
                                 str(tmp_path / "p"), None, 12, restore=True)
    assert restored == 6 and pre is None
    assert not _equal(_state(scope_r, names), final_u) and tm._rng_run_counter == counter_u == 12
    if sources == 1:
        jm, js, jl, ja, jvars = _deepfm(fluid, jdeepfm)
        jscope, jexe = fluid.Scope(), fluid.Executor()
        with fluid.scope_guard(jscope):
            jexe.run(js)
        for n in names:
            jscope.set_var(n, init[n].numpy())
        jmods = (JCheckpointer, jrecovery.StepGuardian, jfaults, fluid.scope_guard)
        _guarded_run(fluid, jmods, jm, jl, ja, jscope, jexe,
                     lambda b: make_ds(b, JStreamingDataset, JFileTailSource, jvars),
                     str(tmp_path / "j"), spec, 12)
        for n in names:
            np.testing.assert_allclose(final_u[n].numpy(), np.asarray(jscope.find_var(n)),
                                       atol=5e-5, err_msg=n)


class _Recorded(StreamingDataset):
    """A ``StreamingDataset`` that keeps the ids of each batch it yields."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.yielded = []

    def _iter_batches(self):
        for feed in super()._iter_batches():
            self.yielded.append(np.array(feed["ids"]))
            yield feed


def test_the_arrival_merge_resumes_without_dropping_or_replaying_a_record(tmp_path):
    """The default merge (arrival order, as the JAX package's) of three
    sources under the guardian: preempted at step 6, restored and sought,
    run to step 12. The batches the two runs trained (the first 7 of the
    preempted run, every one of the resumed run) hold each record of a
    prefix of each file exactly once: a resume drops and replays
    nothing."""
    tm, ts, tl, ta, tvars = _deepfm(pt, tdeepfm)
    paths = _write_parts(tmp_path, 3, 40)
    where = {}
    for k, p in enumerate(paths):
        for i, line in enumerate(open(p)):
            where[np.array(line.split(";")[0].split(), np.int64).tobytes()] = (k, i)
    assert len(where) == 120
    made = []

    def make_ds(bound):
        ds = _Recorded()
        for p in paths:
            ds.add_source(FileTailSource(p, name=os.path.basename(p)))
        ds.set_use_var(tvars)
        ds.set_batch_size(8)
        ds.set_epoch_bound(steps=bound)
        made.append(ds)
        return ds
    init = _port_init(tm, ts)
    mods = (Checkpointer, StepGuardian, faults, pt.scope_guard)
    tm._rng_run_counter = 0
    _, pre = _guarded_run(pt, mods, tm, tl, ta, _scope(init), pt.Executor(pt.CPUPlace()),
                          make_ds, str(tmp_path / "p"), "preempt:step=6", 12)
    assert pre is not None and pre.saved_step == 6
    recovery.clear_preemption()
    tm._rng_run_counter = 0
    restored, pre = _guarded_run(pt, mods, tm, tl, ta, _scope(init),
                                 pt.Executor(pt.CPUPlace()), make_ds, str(tmp_path / "p"),
                                 None, 12, restore=True)
    assert restored == 6 and pre is None and tm._rng_run_counter == 12
    trained = made[0].yielded[:restored + 1] + made[1].yielded
    rows = [where[r.tobytes()] for b in trained for r in b]
    assert len(rows) == 12 * 8 == len(set(rows))
    for k in range(3):
        lines = sorted(i for s, i in rows if s == k)
        assert lines == list(range(len(lines)))
