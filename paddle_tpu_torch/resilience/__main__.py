"""Chaos CLI: run a small training workload under injected faults and
report what the recovery layer did (the port's copy of
``paddle_tpu/resilience/__main__.py``).

    python -m paddle_tpu_torch.resilience --steps 10 \\
        --faults "nan:step=3:var=LOSS;exc@dispatch:step=5;preempt:step=7" \\
        --policy skip --ckpt /tmp/chaos_ck
    python -m paddle_tpu_torch.resilience --stream --ckpt /tmp/stream_ck
    python -m paddle_tpu_torch.resilience --selftest --device cpu

The workload is a seeded MLP regression (``LOSS`` in a fault spec is
replaced by the real loss tensor's name). A simulated preemption triggers
the guardian's emergency checkpoint; unless ``--no-resume`` is given the CLI
then restores from it (a fresh Executor, same scope) and finishes the
remaining steps: the end-to-end recovery story in one command. The summary
counts the ``fault`` / ``retry`` / ``skip`` / ``rollback`` / ``preempt`` /
``step_timeout`` journal events of the run.

``--stream`` is the streaming data plane's chaos: a seeded stream file with
poison lines interleaved feeds a ``StreamingDataset`` under ``exc@read``
faults and a preemption mid-stream; the run restores, seeks the stream and
finishes, and a clean run over the same stream must give byte-identical
losses, every poison line must land in the dead-letter file with its
source, and the quarantine / retry / freshness series must be live.

``--device`` names the device (default: the card; ``cpu``). ``--ranks``
(the elastic kill-K-of-N mode) belongs to the distributed stack, ROADMAP
item 13, and exits 2. So ``selftest`` is the JAX one's without its elastic
part.

Exit codes: 0 all steps completed, 1 incomplete run or error, 2 usage.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

#: why --ranks exits 2
ITEM_13 = ("ROADMAP item 13 (c) (elastic): the elastic launcher, the reshard "
           "planner and the kill-K-of-N chaos (--ranks) are not ported")


def _build_workload(dim: int, seed: int):
    import paddle_tpu_torch as pt
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [dim], "float32")
        loss = pt.layers.mean(pt.layers.fc(x, dim))
        pt.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _start(exe, startup, scope, init: Optional[dict]):
    """Run the startup program, then put ``init`` (name -> numpy array,
    another build's weights) over its draw."""
    exe.run(startup)
    if init:
        from .. import convert
        convert.load_state(scope, convert.state_from_numpy(init, device=exe.device))


def run_chaos(steps: int = 10, faults_spec: Optional[str] = None,
              policy: str = "skip", retries: int = 3, timeout: float = 0.0,
              ckpt_dir: Optional[str] = None, seed: int = 0, dim: int = 8,
              batch: int = 4, resume: bool = True, device=None,
              init: Optional[dict] = None) -> dict:
    """One chaos run on ``device`` (None: the card); returns the JSON-able
    summary dict. ``init`` (name -> numpy array) replaces the startup's
    weights."""
    import numpy as np

    import paddle_tpu_torch as pt
    from ..observability import journal as _journal
    from ..utils.checkpointer import Checkpointer
    from . import faults as _faults
    from . import recovery as _recovery

    t0 = time.time()
    main, startup, loss = _build_workload(dim, seed)
    if faults_spec:
        _faults.install(faults_spec.replace("LOSS", loss.name))

    def make_feed(rs):
        return {"x": rs.rand(batch, dim).astype("float32")}

    rs = np.random.RandomState(seed)
    scope = pt.Scope()
    summary = {"steps": steps, "steps_completed": 0, "policy": policy,
               "faults_armed": _faults.describe(), "final_loss": None,
               "preempted": None, "resumed": False}
    with pt.scope_guard(scope):
        exe = pt.Executor(device)
        _start(exe, startup, scope, init)
        ck = Checkpointer(exe, main, ckpt_dir) if ckpt_dir else None
        guardian = _recovery.StepGuardian(
            exe, main, checkpointer=ck, nonfinite_policy=policy,
            max_retries=retries, retry_backoff=0.01, retry_seed=seed,
            step_timeout=timeout)
        done, preempted = 0, None
        try:
            while done < steps:
                vals = guardian.run(feed=make_feed(rs), fetch_list=[loss])
                if vals:
                    summary["final_loss"] = float(np.asarray(vals[0]).reshape(-1)[0])
                done += 1
        except _recovery.Preempted as p:
            preempted = p
            summary["preempted"] = {"step": p.step, "saved_step": p.saved_step}
        if preempted is not None and resume and ck is not None and \
                preempted.saved_step is not None:
            # the resumable exit, end to end: a new executor restores the
            # emergency checkpoint and finishes the job
            _recovery.clear_preemption()
            exe2 = pt.Executor(device)
            ck2 = Checkpointer(exe2, main, ckpt_dir)
            start = ck2.restore() + 1
            g2 = _recovery.StepGuardian(
                exe2, main, checkpointer=ck2, nonfinite_policy=policy,
                max_retries=retries, retry_backoff=0.01, retry_seed=seed,
                start_step=start)
            summary["resumed"] = True
            summary["resume_start_step"] = start
            while done < steps:
                vals = g2.run(feed=make_feed(rs), fetch_list=[loss])
                if vals:
                    summary["final_loss"] = float(np.asarray(vals[0]).reshape(-1)[0])
                done += 1
            g2.close()
        summary["steps_completed"] = done
        if preempted is None:
            guardian.close()
    events = [e for e in _journal.recent() if e.get("ts", 0) >= t0]
    summary["events"] = {k: sum(1 for e in events if e.get("event") == k)
                         for k in ("fault", "retry", "skip", "rollback",
                                   "preempt", "step_timeout")}
    return summary


def _write_stream_file(path: str, n_good: int, dim: int, seed: int,
                       poison_rate: float) -> int:
    """Seeded synthetic click-stream file: ``n_good`` parseable records (one
    slot of ``dim`` floats) with malformed lines interleaved at
    ``poison_rate``. Returns the poison-line count."""
    import numpy as np
    rs = np.random.RandomState(seed)
    n_poison = 0
    with open(path, "w") as f:
        good = 0
        while good < n_good:
            if poison_rate and rs.rand() < poison_rate:
                n_poison += 1
                f.write(f"POISON {n_poison};;\n")   # wrong slot count
                continue
            f.write(" ".join(f"{v:.6f}" for v in rs.rand(dim).astype("float32")) + "\n")
            good += 1
    return n_poison


def run_stream_chaos(steps: int = 12, batch: int = 4, dim: int = 8,
                     seed: int = 0, poison_rate: float = 0.05,
                     read_fault_prob: float = 0.1,
                     preempt_step: Optional[int] = None,
                     work_dir: Optional[str] = None,
                     save_interval: int = 3,
                     hermetic: bool = True, device=None,
                     init: Optional[dict] = None) -> dict:
    """Streaming-ingestion chaos on ``device``: a flaky source, a poison
    burst and a preemption mid-stream, end to end.

    A seeded stream file (``poison_rate`` malformed lines interleaved) feeds
    a :class:`~paddle_tpu_torch.data.StreamingDataset` under
    ``exc@read(prob=read_fault_prob)`` faults and a ``preempt`` fault at
    ``preempt_step`` (default: mid-run). The guardian saves at the
    preemption with the stream watermark in ``trainstate.json``; the run
    then restores, seeks the stream and finishes. A clean uninterrupted run
    over the same stream must give byte-identical losses; every poison line
    must land in the dead-letter file with its source; the quarantine,
    retry and freshness series must be live in the metrics registry.
    ``hermetic`` drives all stream waiting through a FakeClock (no sleeps).
    ``init`` (name -> numpy array) replaces both runs' startup weights."""
    import tempfile

    import numpy as np

    import paddle_tpu_torch as pt
    from ..data import FileTailSource, StreamingDataset
    from ..observability import journal as _journal
    from ..observability.export import to_prometheus
    from ..observability.metrics import REGISTRY as _OBS
    from ..utils.checkpointer import Checkpointer
    from ..utils.clock import FakeClock
    from . import faults as _faults
    from . import recovery as _recovery

    t0 = time.time()
    base = work_dir or tempfile.mkdtemp(prefix="paddle_tpu_torch_stream_")
    os.makedirs(base, exist_ok=True)
    stream_path = os.path.join(base, "stream.txt")
    n_poison = _write_stream_file(stream_path, steps * batch, dim, seed, poison_rate)
    if preempt_step is None:
        preempt_step = steps // 2
    main, startup, loss = _build_workload(dim, seed)
    x_var = main.global_block().vars["x"]

    def make_ds(dead_letter, use_var=None):
        ds = StreamingDataset(clock=FakeClock() if hermetic else None,
                              retry_seed=seed, max_retries=8)
        ds.add_source(FileTailSource(stream_path, name="clickstream"))
        ds.set_use_var([use_var if use_var is not None else x_var])
        ds.set_batch_size(batch)
        ds.set_bad_sample_policy("quarantine", dead_letter_path=dead_letter,
                                 max_poison_rate=0.5)
        ds.set_epoch_bound(steps=steps)
        return ds

    def hexlosses(d):
        return [np.float32(d[i]).tobytes().hex() if i in d else None
                for i in range(steps)]

    summary = {"steps": steps, "batch": batch, "poison_lines": n_poison,
               "preempt_step": preempt_step, "steps_completed": 0,
               "preempted": None, "resumed": False,
               "byte_identical": None, "dead_letters_attributed": None,
               "metrics_live": None, "work_dir": base, "ok": False}

    # -- A: the faulted run, preempted mid-stream and resumed ----------------
    spec = f"preempt:step={preempt_step}"
    if read_fault_prob:   # prob=0 means "no read faults", not an armed 0%
        spec = f"exc@read:prob={read_fault_prob}:seed={seed + 1}:times=0;" + spec
    _faults.install(spec)
    dead_a = os.path.join(base, "dead_interrupted.jsonl")
    losses: dict = {}

    def cb(n_consumed, vals, base_step=0):
        if vals:
            losses[base_step + n_consumed - 1] = float(np.asarray(vals[0]).reshape(-1)[0])

    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(device)
        _start(exe, startup, scope, init)
        ck = Checkpointer(exe, main, os.path.join(base, "ck"),
                          save_interval_steps=save_interval)
        g = _recovery.StepGuardian(exe, main, checkpointer=ck,
                                   retry_backoff=0.01, retry_seed=seed)
        preempted = None
        try:
            g.train_from_dataset(dataset=make_ds(dead_a), fetch_list=[loss], step_cb=cb)
            g.close()
        except _recovery.Preempted as p:
            preempted = p
            summary["preempted"] = {"step": p.step, "saved_step": p.saved_step}
        if preempted is not None and preempted.saved_step is not None:
            _recovery.clear_preemption()
            exe2 = pt.Executor(device)
            ck2 = Checkpointer(exe2, main, os.path.join(base, "ck"))
            start = ck2.restore() + 1
            ts = ck2.train_state or {}
            ds2 = make_ds(dead_a)
            ds2.seek(ts.get("stream"))
            ds2.set_epoch_bound(steps=steps - start)
            g2 = _recovery.StepGuardian(exe2, main, checkpointer=ck2,
                                        retry_backoff=0.01, retry_seed=seed,
                                        start_step=start)
            g2.train_from_dataset(dataset=ds2, fetch_list=[loss],
                                  step_cb=lambda n, v: cb(n, v, base_step=start))
            g2.close()
            summary["resumed"] = True
            summary["resume_start_step"] = start
    _faults.clear()
    _recovery.clear_preemption()
    summary["steps_completed"] = len(losses)

    # -- B: a clean uninterrupted reference over the same prefix -------------
    # fresh programs, as in the JAX package (whose startup run advances the
    # program's random-run counter)
    main_b, startup_b, loss_b = _build_workload(dim, seed)
    dead_b = os.path.join(base, "dead_reference.jsonl")
    ref_losses: dict = {}
    scope_b = pt.Scope()
    with pt.scope_guard(scope_b):
        exe_b = pt.Executor(device)
        _start(exe_b, startup_b, scope_b, init)
        g_b = _recovery.StepGuardian(exe_b, main_b, retry_backoff=0.01, retry_seed=seed)
        g_b.train_from_dataset(
            dataset=make_ds(dead_b, use_var=main_b.global_block().vars["x"]),
            fetch_list=[loss_b],
            step_cb=lambda n, v: (ref_losses.__setitem__(
                n - 1, float(np.asarray(v[0]).reshape(-1)[0])) if v else None))
        g_b.close()

    summary["losses_hex"] = hexlosses(losses)
    summary["reference_hex"] = hexlosses(ref_losses)
    summary["byte_identical"] = (
        len(losses) == steps == len(ref_losses) and
        summary["losses_hex"] == summary["reference_hex"])

    # -- verdicts ------------------------------------------------------------
    def read_dead(p):
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return [json.loads(ln) for ln in f if ln.strip()]

    da, db = read_dead(dead_a), read_dead(dead_b)
    # the window between the last committed batch and the preemption may
    # quarantine a poison line again on resume, so the interrupted file is
    # judged on its unique positions
    uniq_a = {r["where"] for r in da}
    summary["dead_letters_attributed"] = (
        len(uniq_a) == n_poison == len(db) and
        all(r["where"].startswith("clickstream:") and r["reason"] for r in da + db))
    prom = to_prometheus(_OBS)
    summary["metrics_live"] = all(
        s in prom for s in ("samples_quarantined_total",
                            "source_retries_total" if read_fault_prob
                            else "stream_records_total",
                            "sample_age_seconds", "stream_buffer_depth",
                            "stream_records_total"))
    evs = [e for e in _journal.recent() if e.get("ts", 0) >= t0]
    summary["events"] = {k: sum(1 for e in evs if e.get("event") == k)
                         for k in ("fault", "source_retry", "source_lost",
                                   "sample_quarantined", "stream_seek",
                                   "preempt", "stream_epoch")}
    summary["ok"] = bool(
        summary["byte_identical"] and summary["dead_letters_attributed"]
        and summary["metrics_live"] and summary["preempted"] is not None
        and summary["resumed"])
    return summary


def _fmt_stream(summary: dict, out=None):
    out = out or sys.stdout
    print(f"stream chaos: {summary['steps_completed']}/{summary['steps']} "
          f"steps -> {'OK' if summary['ok'] else 'FAILED'}", file=out)
    p = summary["preempted"]
    if p:
        print(f"  preempted at step {p['step']} (emergency checkpoint "
              f"step {p['saved_step']}); resumed at "
              f"{summary.get('resume_start_step')}", file=out)
    ev = summary["events"]
    print(f"  source retries: {ev['source_retry']}; quarantined "
          f"{ev['sample_quarantined']} of {summary['poison_lines']} "
          f"poison line(s); seeks: {ev['stream_seek']}", file=out)
    print(f"  byte-identical resume: {summary['byte_identical']}; "
          f"dead letters attributed: {summary['dead_letters_attributed']}; "
          f"metrics live: {summary['metrics_live']}", file=out)


def _fmt_text(summary: dict, out=None):
    out = out or sys.stdout
    print(f"chaos run: {summary['steps_completed']}/{summary['steps']} "
          f"steps completed (policy={summary['policy']})", file=out)
    for f in summary["faults_armed"]:
        where = f"@{f['site']}" if f["kind"] != "nan" else f":var={f['var']}"
        step = f" step={f['step']}" if f["step"] is not None else ""
        print(f"  armed: {f['kind']}{where}{step} "
              f"(fired {f['fired']}/{f['times'] or 'inf'})", file=out)
    ev = summary["events"]
    print(f"  events: {ev['fault']} fault(s), {ev['retry']} retr(ies), "
          f"{ev['skip']} skip(s), {ev['rollback']} rollback(s), "
          f"{ev['preempt']} preemption(s)", file=out)
    if summary["preempted"]:
        p = summary["preempted"]
        print(f"  preempted at step {p['step']} (emergency checkpoint "
              f"step {p['saved_step']}); resumed={summary['resumed']}", file=out)
    if summary["final_loss"] is not None:
        print(f"  final loss: {summary['final_loss']:.6g}", file=out)


def selftest(device=None) -> int:
    """Hermetic end-to-end self-check of the fault injector, the guardian,
    preemption-safe checkpointing and the streaming data plane, on
    ``device`` (None: the card)."""
    import math
    import tempfile

    from . import faults as _faults
    from . import recovery as _recovery

    # 1. the spec grammar round-trips
    fs = _faults.parse_spec(
        "nan:step=2:var=loss; exc@dispatch:step=4:times=2 ;"
        "hang@fetch:seconds=0.2;preempt:step=6;nan:step=9:value=inf")
    assert [f.kind for f in fs] == ["nan", "exc", "hang", "preempt", "nan"]
    assert fs[0].site == "fetch" and fs[0].var == "loss" and fs[0].times == 1
    assert fs[1].times == 2 and fs[1].site == "dispatch"
    assert fs[4].value == float("inf")
    for bogus in ("segv:step=1", "exc@nowhere", "nan:step=x", "nan:wat=1", "exc:prob=2.0"):
        try:
            _faults.parse_spec(bogus)
        except _faults.FaultSpecError:
            pass
        else:
            raise AssertionError(f"spec {bogus!r} should have failed")

    # 2. a chaos run: nonfinite skip + transient retry + preempt/resume
    _faults.clear()
    _recovery.clear_preemption()
    with tempfile.TemporaryDirectory() as td:
        try:
            summary = run_chaos(
                steps=8, policy="skip", seed=7, dim=4, batch=2,
                ckpt_dir=os.path.join(td, "ck"), device=device,
                faults_spec="nan:step=2:var=LOSS;exc@dispatch:step=4;preempt:step=6")
            assert summary["steps_completed"] == 8, summary
            ev = summary["events"]
            assert ev["fault"] >= 3, summary
            assert ev["retry"] >= 1, summary
            assert ev["skip"] == 1, summary
            assert ev["preempt"] == 1, summary
            assert summary["preempted"]["saved_step"] is not None, summary
            assert summary["resumed"], summary
            assert summary["final_loss"] is not None and \
                math.isfinite(summary["final_loss"]), summary
        finally:
            _faults.clear()
            _recovery.clear_preemption()
    assert not _faults.armed()

    # 3. the streaming data plane: flaky source + poison burst + mid-stream
    # preempt/resume, hermetic (FakeClock, seeded faults, no sleeps)
    _selftest_stream(device)
    print("chaos selftest: OK")
    return 0


def _selftest_stream(device=None):
    """Hermetic streaming-ingestion chaos: a seeded stream, exc@read(p=0.25),
    interleaved poison lines and a preemption mid-stream; asserts a
    byte-identical resume, attributed dead letters and live quarantine /
    retry / freshness series."""
    import shutil
    import tempfile

    from . import faults as _faults
    from . import recovery as _recovery

    fs = _faults.parse_spec("exc@read:prob=0.1:seed=3:times=0;corrupt@read:step=4;hang@read")
    assert [f.site for f in fs] == ["read", "read", "read"]
    assert _faults.corrupt_record("x", "read") == "x"   # disarmed = no-op
    for inert in ("nan@read", "truncate@parse"):    # no hook consumes them
        try:
            _faults.parse_spec(inert)
        except _faults.FaultSpecError:
            pass
        else:
            raise AssertionError(f"{inert!r} should be rejected")

    td = tempfile.mkdtemp(prefix="paddle_tpu_torch_streamself_")
    _faults.clear()
    _recovery.clear_preemption()
    try:
        summary = run_stream_chaos(
            steps=10, batch=3, dim=4, seed=7, poison_rate=0.12,
            read_fault_prob=0.25, preempt_step=4, work_dir=td,
            save_interval=3, hermetic=True, device=device)
        assert summary["ok"], summary
        assert summary["steps_completed"] == 10, summary
        assert summary["preempted"] is not None and summary["resumed"], summary
        assert summary["byte_identical"], summary
        assert summary["poison_lines"] > 0 and summary["dead_letters_attributed"], summary
        assert summary["metrics_live"], summary
        assert summary["events"]["source_retry"] >= 1, summary
        assert summary["events"]["stream_seek"] >= 1, summary
    finally:
        _faults.clear()
        _recovery.clear_preemption()
        shutil.rmtree(td, ignore_errors=True)
    assert not _faults.armed()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.resilience",
        description="chaos harness: train a small MLP under injected faults and "
                    "report the recovery layer's behavior")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--faults", default=None,
                    help="fault spec (see resilience.faults; LOSS is replaced by the "
                         "workload's loss tensor name); default: $PADDLE_TPU_FAULTS "
                         "already armed")
    ap.add_argument("--policy", choices=("skip", "rollback", "raise"), default="skip")
    ap.add_argument("--retries", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="per-step deadline in seconds (0 = no watchdog)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (enables preemption-safe saves and resume)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--no-resume", action="store_true",
                    help="do not resume after a (simulated) preemption")
    ap.add_argument("--device", default=None,
                    help="the device: the card by default, or 'cpu'")
    ap.add_argument("--ranks", type=int, default=0,
                    help="multi-rank elastic mode: not ported (ROADMAP item 13 (c)), "
                         "exits 2")
    ap.add_argument("--stream", action="store_true",
                    help="streaming data-plane chaos: flaky source + poison burst + "
                         "mid-stream preempt against a StreamingDataset, "
                         "byte-identical-resume verdict")
    ap.add_argument("--poison-rate", type=float, default=0.05,
                    help="stream mode: malformed-line rate interleaved into the "
                         "synthetic stream")
    ap.add_argument("--read-fault-prob", type=float, default=0.1,
                    help="stream mode: per-record exc@read probability")
    ap.add_argument("--preempt-step", type=int, default=None,
                    help="stream mode: preemption step (default: mid)")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    if args.ranks:
        print(f"error: --ranks: {ITEM_13}", file=sys.stderr)
        return 2
    if args.selftest:
        return selftest(args.device)
    if args.stream:
        try:
            summary = run_stream_chaos(
                steps=args.steps, batch=args.batch, dim=args.dim,
                seed=args.seed, poison_rate=args.poison_rate,
                read_fault_prob=args.read_fault_prob,
                preempt_step=args.preempt_step, work_dir=args.ckpt,
                hermetic=False, device=args.device)
        except Exception as e:  # noqa: BLE001 -- CLI boundary
            print(f"stream chaos run failed: {type(e).__name__}: {e}", file=sys.stderr)
            return 1
        if args.format == "json":
            print(json.dumps(summary, indent=2, sort_keys=True, default=str))
        else:
            _fmt_stream(summary)
        return 0 if summary["ok"] else 1
    try:
        summary = run_chaos(
            steps=args.steps, faults_spec=args.faults, policy=args.policy,
            retries=args.retries, timeout=args.timeout, ckpt_dir=args.ckpt,
            seed=args.seed, dim=args.dim, batch=args.batch,
            resume=not args.no_resume, device=args.device)
    except Exception as e:  # noqa: BLE001 -- CLI boundary
        print(f"chaos run failed: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    if args.format == "json":
        print(json.dumps(summary, indent=2, sort_keys=True, default=str))
    else:
        _fmt_text(summary)
    return 0 if summary["steps_completed"] >= args.steps else 1


if __name__ == "__main__":
    sys.exit(main())
