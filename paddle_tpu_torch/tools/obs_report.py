"""obs_report: render the run journal, a metrics dump and a trace as a
report an operator reads (the port's copy of the JAX package's
``tools/obs_report.py``).

The reading end of ``paddle_tpu_torch/observability/``:

    python -m paddle_tpu_torch.tools.obs_report --journal paddle_tpu_obs.jsonl \
        --metrics metrics.json --trace timeline.json [--goodput] [--fleet]
    python -m paddle_tpu_torch.tools.obs_report --selftest

``--metrics`` takes the JSON of ``observability.export.dump_json`` or a
Prometheus text dump (told apart by parsing); ``--trace`` a Chrome trace of
``observability.timeline.export_chrome_trace`` or
``profiler.export_chrome_tracing``, which ``validate_trace`` checks.
``--live`` renders this process's registry. Every section renders the JAX
report's text from the same inputs, save the hints that name a module to
run; the sections read the event and metric names the JAX package writes,
so one that the port does not feed (fleet, online learning, the HLO byte
attribution) says it is empty.

The JAX CLI's ``--bench`` (a ``tools/bench_compare.py`` trajectory) waits
for the port's benchmark and exits 2; ``render_report`` still takes a
``bench_summary`` (lines) from a caller.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import List, Optional


#: the alerts section's pointer to the bundle triage tool (the JAX report
#: names tools/postmortem.py)
TRIAGE = "python -m paddle_tpu_torch.tools.postmortem <bundle dir>"


def _stats(vals: List[float]) -> str:
    if not vals:
        return "n=0"
    vs = sorted(vals)
    p = lambda q: vs[min(len(vs) - 1, int(q * len(vs)))]
    return (f"n={len(vs)} mean={sum(vs) / len(vs):.3f} p50={p(0.5):.3f} "
            f"p95={p(0.95):.3f} max={vs[-1]:.3f}")


def _hist_quantile(buckets, q: float) -> Optional[float]:
    """Upper-bound estimate of quantile q from cumulative [le, count] pairs."""
    if not buckets or buckets[-1][1] == 0:
        return None
    target = q * buckets[-1][1]
    for le, n in buckets:
        if n >= target:
            le = float(le) if not isinstance(le, str) else (
                math.inf if le == "+Inf" else float(le))
            return le
    return None


# ---------------------------------------------------------------- journal --

def render_journal(events: List[dict]) -> str:
    lines = ["== Run journal =="]
    if not events:
        lines.append("(no events)")
        return "\n".join(lines)
    runs = [e for e in events if e.get("event") == "run"]
    recompiles = [e for e in events if e.get("event") == "recompile"]
    predicts = [e for e in events if e.get("event") == "predict"]
    lines.append(f"{len(events)} events: {len(runs)} executor runs, "
                 f"{len(recompiles)} recompiles, "
                 f"{len(predicts)} predictor requests")
    if runs:
        hits = sum(1 for e in runs if e.get("cache") == "hit")
        lines.append(f"compile cache: {hits} hits / {len(runs) - hits} "
                     f"misses ({hits / len(runs):.1%} hit rate)")
        lines.append("run_ms: " + _stats(
            [e["run_ms"] for e in runs if e.get("run_ms") is not None]))
        compiles = [e["compile_ms"] for e in runs
                    if e.get("compile_ms") is not None]
        if compiles:
            lines.append("compile_ms: " + _stats(compiles))
        by_prog = {}
        for e in runs:
            k = f'{e.get("program")}:v{e.get("version")}'
            by_prog.setdefault(k, []).append(e)
        lines.append("per program:")
        for k, es in sorted(by_prog.items(), key=lambda kv: -len(kv[1])):
            feeds = {json.dumps(e.get("feed", {}), sort_keys=True)
                     for e in es}
            lines.append(f"  {k}: {len(es)} runs, {len(feeds)} feed "
                         f"signature(s), " +
                         _stats([e["run_ms"] for e in es
                                 if e.get("run_ms") is not None]))
    for e in recompiles:
        lines.append(f"RECOMPILE program {e.get('program')} "
                     f"v{e.get('version')}: changed {e.get('changed')}")
    if predicts:
        lines.append("predict run_ms: " + _stats(
            [e["run_ms"] for e in predicts if e.get("run_ms") is not None]))
    return "\n".join(lines)


# ----------------------------------------------------------------- health --

def render_health(events: List[dict]) -> str:
    """Tensor-health watchdog + step-time anomaly verdicts in the journal."""
    lines = ["== Health =="]
    nonf = [e for e in events if e.get("event") == "tensor_nonfinite"]
    anom = [e for e in events if e.get("event") == "step_time_anomaly"]
    if not nonf and not anom:
        lines.append("healthy: no tensor_nonfinite or step_time_anomaly "
                     "events")
        return "\n".join(lines)
    if len(nonf) > 10:
        # a loss that goes NaN journals one event per remaining step; the
        # report must stay readable, same last-10 cap as the anomaly list
        lines.append(f"{len(nonf)} tensor_nonfinite events (last 10):")
    for e in nonf[-10:]:
        lines.append(f"NONFINITE {e.get('where', '?')} program "
                     f"{e.get('program')}: first offender "
                     f"{e.get('var')!r} (all: {e.get('vars')})")
    if anom:
        lines.append(f"{len(anom)} step-time anomalies"
                     + (" (last 10):" if len(anom) > 10 else ":"))
        for e in anom[-10:]:
            lines.append(
                f"  program {e.get('program')}: step "
                f"{e.get('step_ms')}ms vs median {e.get('median_ms')}ms "
                f"(MAD {e.get('mad_ms')}ms, limit {e.get('limit_ms')}ms)")
    return "\n".join(lines)


# ------------------------------------------------------------- resilience --

_RESILIENCE_EVENTS = ("fault", "retry", "skip", "rollback", "preempt",
                      "step_timeout", "elastic_restart",
                      "elastic_decision", "reshard_plan")


def render_resilience(events: List[dict]) -> str:
    """Recovery-layer activity in the journal: injected faults, step
    retries, skipped/rolled-back nonfinite steps, preemption saves and
    elastic restarts (paddle_tpu_torch/resilience/)."""
    lines = ["== Resilience =="]
    by = {k: [e for e in events if e.get("event") == k]
          for k in _RESILIENCE_EVENTS}
    if not any(by.values()):
        lines.append("quiet: no fault/retry/skip/rollback/preempt events")
        return "\n".join(lines)
    if by["fault"]:
        counts = {}
        for e in by["fault"]:
            k = f"{e.get('kind', '?')}@{e.get('site', '?')}"
            counts[k] = counts.get(k, 0) + 1
        lines.append(f"{len(by['fault'])} injected fault(s): " + ", ".join(
            f"{k} x{n}" for k, n in sorted(counts.items())))
    if by["retry"]:
        sites = {}
        for e in by["retry"]:
            sites[e.get("site", "?")] = sites.get(e.get("site", "?"), 0) + 1
        lines.append(f"{len(by['retry'])} step retr(ies): " + ", ".join(
            f"{s} x{n}" for s, n in sorted(sites.items())))
        for e in by["retry"][-10:]:
            lines.append(f"  retry step {e.get('step')} @{e.get('site')} "
                         f"attempt {e.get('attempt')} "
                         f"(backoff {e.get('backoff_ms')}ms): "
                         f"{str(e.get('error', ''))[:80]}")
    if by["skip"]:
        steps = [e.get("step") for e in by["skip"]]
        lines.append(f"{len(steps)} skipped nonfinite step(s): "
                     f"{steps[-10:]}")
    if by["rollback"]:
        for e in by["rollback"][-10:]:
            lines.append(f"ROLLBACK at step {e.get('step')} -> step "
                         f"{e.get('to_step')} (source {e.get('source')}; "
                         f"vars {e.get('vars')})")
    if by["step_timeout"]:
        lines.append(f"{len(by['step_timeout'])} hung step(s) deadlined: "
                     f"steps {[e.get('step') for e in by['step_timeout']][-10:]}")
    for e in by["preempt"]:
        lines.append(f"PREEMPT at step {e.get('step')}: emergency "
                     f"checkpoint step {e.get('saved_step')} "
                     f"({e.get('reason')})")
    if by["elastic_restart"]:
        lines.append(f"{len(by['elastic_restart'])} elastic restart(s):")
        for e in by["elastic_restart"][-10:]:
            lines.append(f"  attempt {e.get('attempt')}/"
                         f"{e.get('max_restarts')}: rank "
                         f"{e.get('failed_rank')} failed, backoff "
                         f"{e.get('backoff_s')}s")
    for e in by["elastic_decision"][-10:]:
        lines.append(f"  elastic decision: {e.get('action')} -> "
                     f"{e.get('target_nproc')} rank(s) "
                     f"({str(e.get('reason'))[:80]})")
    for e in by["reshard_plan"][-5:]:
        lines.append(f"  reshard plan {e.get('src_world')} -> "
                     f"{e.get('dst_world')}: {e.get('actions')} "
                     f"({e.get('bytes_read')} B read)")
    return "\n".join(lines)


# ------------------------------------------------------------- checkpoint --

_CKPT_EVENTS = ("ckpt_save", "ckpt_corrupt", "ckpt_quarantine",
                "ckpt_save_error", "ckpt_fault")


def render_checkpoint(events: List[dict],
                      snapshot: Optional[dict] = None) -> str:
    """Durable-checkpoint activity: saves (blocked vs write time, sync vs
    async), bytes written, detected corruption and quarantines
    (utils/checkpointer.py + io.py integrity layer)."""
    lines = ["== Checkpoint =="]
    by = {k: [e for e in events if e.get("event") == k]
          for k in _CKPT_EVENTS}
    if not any(by.values()):
        lines.append("quiet: no checkpoint save/corruption events")
        return "\n".join(lines)
    saves = by["ckpt_save"]
    for label, pick in (("sync", [e for e in saves if not e.get("async")]),
                        ("async", [e for e in saves if e.get("async")])):
        if not pick:
            continue
        blocked = [e["blocked_ms"] for e in pick
                   if e.get("blocked_ms") is not None]
        write = [e["write_ms"] for e in pick
                 if e.get("write_ms") is not None]
        nbytes = sum(int(e.get("bytes") or 0) for e in pick)
        lines.append(f"{len(pick)} {label} save(s), {_gb(float(nbytes))} "
                     f"written")
        if blocked:
            lines.append(f"  blocked ms/save: {_stats(blocked)}")
        if write and label == "async":
            lines.append(f"  write ms/save (background): {_stats(write)}")
    total = _counter_total(snapshot, "checkpoint_bytes_total")
    if total is not None:
        lines.append(f"checkpoint_bytes_total: {_gb(total)}")
    for e in by["ckpt_corrupt"][-10:]:
        lines.append(f"CORRUPT chunk detected ({e.get('kind')}): "
                     f"{e.get('file')} var {e.get('var')!r} -- "
                     f"{str(e.get('detail', ''))[:80]}")
    for e in by["ckpt_quarantine"][-10:]:
        lines.append(f"QUARANTINE step {e.get('step')} ({e.get('kind')}) "
                     f"-> {e.get('to')}")
    for e in by["ckpt_save_error"][-10:]:
        lines.append(f"SAVE ERROR at step {e.get('step')}: "
                     f"{str(e.get('error', ''))[:100]}")
    for e in by["ckpt_fault"][-10:]:
        lines.append(f"injected {e.get('kind')} on {e.get('file')} "
                     f"({e.get('detail')})")
    return "\n".join(lines)


# ---------------------------------------------------------------- serving --

def render_serving(events: Optional[List[dict]],
                   snapshot: Optional[dict] = None) -> str:
    """Serving-tier activity (paddle_tpu_torch/serving/): batch formation stats
    and shed rate from ``serve_batch``/``serve_shed`` journal events,
    queue depth and per-tenant request latency p50/p99 from the metrics
    snapshot."""
    lines = ["== Serving =="]
    events = events or []
    batches = [e for e in events if e.get("event") == "serve_batch"]
    sheds = [e for e in events if e.get("event") == "serve_shed"]
    fams = {f.get("name"): f for f in (snapshot or {}).get("families", [])}
    if not batches and not sheds and "serving_requests_total" not in fams:
        lines.append("idle: no serving activity (run a "
                     "paddle_tpu_torch.serving.PredictorPool)")
        return "\n".join(lines)
    if batches:
        reqs = sum(int(e.get("requests") or 0) for e in batches)
        rows = sum(int(e.get("rows") or 0) for e in batches)
        padded = sum(int(e.get("padded_rows") or 0) for e in batches)
        fill = f"{rows / padded:.1%}" if padded else "?"
        lines.append(f"{len(batches)} batches serving {reqs} requests "
                     f"({rows} rows, bucket fill {fill})")
        lines.append("batch rows: " + _stats(
            [float(e["rows"]) for e in batches
             if e.get("rows") is not None]))
        lines.append("batch exec_ms: " + _stats(
            [e["exec_ms"] for e in batches
             if e.get("exec_ms") is not None]))
        dtypes = sorted({str(e.get("dtype")) for e in batches})
        if dtypes not in (["native"], ["?"]):
            lines.append(f"serving dtypes: {dtypes}")
    accepted = shed_n = 0.0
    for s in fams.get("serving_requests_total", {}).get("samples", []):
        if s.get("labels", {}).get("outcome") == "accepted":
            accepted += s.get("value", 0.0)
        elif s.get("labels", {}).get("outcome") == "shed":
            shed_n += s.get("value", 0.0)
    if accepted or shed_n or sheds:
        offered = accepted + shed_n
        rate = f"{shed_n / offered:.1%}" if offered else "?"
        lines.append(f"shed rate: {rate} ({shed_n:g} of {offered:g} "
                     f"offered)")
        by = {}
        for e in sheds:
            k = f"{e.get('tenant', '?')}/{e.get('reason', '?')}"
            by[k] = by.get(k, 0) + 1
        for k, n in sorted(by.items()):
            lines.append(f"  shed {k}: x{n}")
    # reliability rows: deadlines, breaker, swap, crash, drain
    n_timeout = _counter_total(snapshot, "serving_timeout_total")
    t_events = [e for e in events if e.get("event") == "serve_timeout"]
    if n_timeout or t_events:
        by_t = {}
        for e in t_events:
            by_t[e.get("tenant", "?")] = by_t.get(e.get("tenant", "?"), 0) + 1
        detail = " ".join(f"{t}: x{n}" for t, n in sorted(by_t.items()))
        lines.append(f"deadline timeouts: {n_timeout if n_timeout else len(t_events):g}"
                     + (f" ({detail})" if detail else ""))
    trans = [e for e in events if e.get("event") == "serve_breaker"]
    state_names = {0.0: "closed", 1.0: "half_open", 2.0: "open"}
    open_now = []
    for s in fams.get("serving_breaker_state", {}).get("samples", []):
        if s.get("value"):
            lbl = s.get("labels", {})
            open_now.append(f"{lbl.get('tenant', '?')}/{lbl.get('sig', '?')}"
                            f"={state_names.get(s.get('value'), '?')}")
    if trans or open_now:
        opens = sum(1 for e in trans if e.get("to") == "open")
        closes = sum(1 for e in trans if e.get("to") == "closed")
        lines.append(f"breaker: {len(trans)} transition(s) "
                     f"({opens} open, {closes} re-closed)"
                     + (f"; now not-closed: {', '.join(sorted(open_now))}"
                        if open_now else ""))
        for e in trans[-5:]:
            lines.append(f"  BREAKER {e.get('tenant')}/{e.get('sig')} "
                         f"{e.get('from')} -> {e.get('to')} "
                         f"(failures {e.get('failures')})")
    swaps = [e for e in events if e.get("event") == "serve_swap"]
    if swaps:
        ok = [e for e in swaps if e.get("outcome") == "ok"]
        rej = [e for e in swaps if e.get("outcome") == "rejected"]
        lines.append(f"hot swaps: {len(ok)} ok, {len(rej)} rejected")
        for e in ok[-3:]:
            ms = e.get("swap_ms")
            lines.append(f"  SWAP -> model_version {e.get('model_version')}"
                         + (f" in {ms}ms" if ms is not None else ""))
        for e in rej[-3:]:
            lines.append(f"  SWAP REJECTED: {str(e.get('error', ''))[:90]}")
    for s in fams.get("serving_model_version", {}).get("samples", []):
        if s.get("value", 0) > 1:
            lines.append(f"model version now: {s.get('value'):g}")
    n_crash = _counter_total(snapshot, "serving_worker_crash_total")
    crash_events = [e for e in events if e.get("event") ==
                    "serve_worker_crash"]
    if n_crash or crash_events:
        lines.append(f"worker crashes (respawned): "
                     f"{n_crash if n_crash else len(crash_events):g}")
        for e in crash_events[-3:]:
            lines.append(f"  CRASH worker {e.get('worker')}: "
                         f"{str(e.get('error', ''))[:90]}")
    for e in [e for e in events
              if e.get("event") == "serve_drain_timeout"][-3:]:
        lines.append(f"DRAIN TIMEOUT after {e.get('waited_s')}s: "
                     f"{e.get('failed_queued')} queued + "
                     f"{e.get('failed_in_flight')} in-flight failed typed")
    for s in fams.get("serving_queue_depth", {}).get("samples", []):
        lines.append(f"queue depth now: {s.get('value', 0.0):g}")
    for s in fams.get("serving_in_flight", {}).get("samples", []):
        if s.get("value"):
            lines.append(f"in flight now: {s.get('value'):g}")
    lat = fams.get("serving_request_seconds", {})
    for s in lat.get("samples", []):
        tenant = s.get("labels", {}).get("tenant", "?")
        n = s.get("count", 0)
        if not n:
            continue
        p50 = _hist_quantile(s.get("buckets", []), 0.5)
        p99 = _hist_quantile(s.get("buckets", []), 0.99)
        fmt = lambda v: ("?" if v is None else "inf" if math.isinf(v)
                         else f"{v * 1e3:.4g}ms")
        mean = s.get("sum", 0.0) / n
        lines.append(f"  tenant {tenant}: n={n} mean={mean * 1e3:.4g}ms "
                     f"p50<={fmt(p50)} p99<={fmt(p99)}")
    return "\n".join(lines)


# -------------------------------------------------------------- ingestion --

_INGEST_EVENTS = ("source_retry", "source_lost", "sample_quarantined",
                  "stream_seek", "stream_seek_gap", "source_skipped",
                  "stream_epoch", "stream_torn_tail")


def render_ingestion(events: Optional[List[dict]],
                     snapshot: Optional[dict] = None) -> str:
    """Streaming data-plane activity (paddle_tpu_torch/data/ + the shared
    dataset quarantine policy): source retries/losses, poison-record
    quarantine rate, stream seeks, sample freshness p50/p99 and buffer
    depth."""
    lines = ["== Ingestion =="]
    events = events or []
    by = {k: [e for e in events if e.get("event") == k]
          for k in _INGEST_EVENTS}
    fams = {f.get("name"): f for f in (snapshot or {}).get("families", [])}
    if not any(by.values()) and "stream_records_total" not in fams \
            and "samples_quarantined_total" not in fams:
        lines.append("quiet: no streaming-ingestion activity (run a "
                     "paddle_tpu_torch.data.StreamingDataset or "
                     "python -m paddle_tpu_torch.resilience --stream)")
        return "\n".join(lines)
    ep = by["stream_epoch"][-1] if by["stream_epoch"] else None
    if ep is not None:
        lines.append(f"last stream epoch: {ep.get('batches')} batch(es), "
                     f"{ep.get('records')} record(s) consumed, "
                     f"{ep.get('dead_letters')} dead-letter(s); "
                     f"watermarks {ep.get('sources')}")
    n_rec = _counter_total(snapshot, "stream_records_total")
    if n_rec:
        lines.append(f"records ingested: {n_rec:g}")
    if by["source_retry"]:
        srcs = {}
        for e in by["source_retry"]:
            k = str(e.get("source", "?"))
            srcs[k] = srcs.get(k, 0) + 1
        lines.append(f"{len(by['source_retry'])} source retr(ies): " +
                     ", ".join(f"{s} x{n}" for s, n in sorted(srcs.items())))
        for e in by["source_retry"][-5:]:
            lines.append(f"  retry {e.get('source')} attempt "
                         f"{e.get('attempt')} (backoff "
                         f"{e.get('backoff_ms')}ms): "
                         f"{str(e.get('error', ''))[:80]}")
    for e in by["source_lost"][-5:]:
        lines.append(f"SOURCE LOST {e.get('source')} after "
                     f"{e.get('attempts')} attempt(s): "
                     f"{str(e.get('error', ''))[:80]}")
    n_quar = _counter_total(snapshot, "samples_quarantined_total")
    if n_quar or by["sample_quarantined"]:
        n_q = n_quar if n_quar else float(len(by["sample_quarantined"]))
        rate = f" ({n_q / n_rec:.2%} of ingested)" if n_rec else ""
        reasons = {}
        for s in fams.get("samples_quarantined_total",
                          {}).get("samples", []):
            reasons[s.get("labels", {}).get("reason", "?")] = \
                s.get("value", 0.0)
        det = (" by reason: " + ", ".join(
            f"{r} x{int(n)}" for r, n in sorted(reasons.items()))
            if reasons else "")
        lines.append(f"quarantine rate: {n_q:g} sample(s){rate}{det}")
        for e in by["sample_quarantined"][-5:]:
            lines.append(f"  QUARANTINED {e.get('where')} "
                         f"({e.get('reason')}): "
                         f"{str(e.get('error', ''))[:80]} -> "
                         f"{e.get('dead_letter')}")
    for e in by["stream_seek"][-3:]:
        lines.append(f"stream seek -> {e.get('sources')} "
                     f"(records {e.get('records')}, dead letters "
                     f"{e.get('dead_letters')})")
    for e in by["stream_seek_gap"][-3:]:
        lines.append(f"SEEK GAP {e.get('source')}: "
                     f"{str(e.get('detail', ''))[:90]}")
    for e in by["stream_torn_tail"][-3:]:
        lines.append(f"TORN TAIL {e.get('source')} at byte "
                     f"{e.get('pos')}: {str(e.get('detail', ''))[:80]}")
    if by["source_skipped"]:
        lines.append(f"{len(by['source_skipped'])} missing file(s) "
                     f"skipped (on_missing_file=skip): "
                     f"{[e.get('file') for e in by['source_skipped']][-5:]}")
    for s in fams.get("sample_age_seconds", {}).get("samples", []):
        n = s.get("count", 0)
        if not n:
            continue
        p50 = _hist_quantile(s.get("buckets", []), 0.5)
        p99 = _hist_quantile(s.get("buckets", []), 0.99)
        fmt = lambda v: ("?" if v is None else "inf" if math.isinf(v)
                         else f"{v * 1e3:.4g}ms")
        mean = s.get("sum", 0.0) / n
        lines.append(f"sample freshness: n={n} mean={mean * 1e3:.4g}ms "
                     f"p50<={fmt(p50)} p99<={fmt(p99)}")
    for s in fams.get("stream_buffer_depth", {}).get("samples", []):
        lines.append(f"buffer depth now: {s.get('value', 0.0):g}")
    return "\n".join(lines)


# ----------------------------------------------------------------- online --

def render_online(events: Optional[List[dict]],
                  snapshot: Optional[dict] = None) -> str:
    """Online-learning activity (the JAX package's paddle_tpu/online/): delta publishes from
    the trainer-side ``OnlinePublisher`` (``online_publish`` events +
    ``delta_rows_total``/``delta_bytes_total``), serving-side partial
    applies (``online_apply``), publish wall time and model staleness."""
    lines = ["== Online learning =="]
    events = events or []
    pubs = [e for e in events if e.get("event") == "online_publish"]
    apps = [e for e in events if e.get("event") == "online_apply"]
    fams = {f.get("name"): f for f in (snapshot or {}).get("families", [])}
    if not pubs and not apps and "online_publish_total" not in fams \
            and "delta_bytes_total" not in fams:
        lines.append("idle: no online-learning activity (the online publisher "
                     "is not ported: ROADMAP item 10)")
        return "\n".join(lines)
    ok = [e for e in pubs if e.get("outcome") == "ok"]
    err = [e for e in pubs if e.get("outcome") == "error"]
    empty = [e for e in pubs if e.get("outcome") == "empty"]
    c_ok = c_err = 0.0
    for s in fams.get("online_publish_total", {}).get("samples", []):
        if s.get("labels", {}).get("outcome") == "ok":
            c_ok += s.get("value", 0.0)
        elif s.get("labels", {}).get("outcome") == "error":
            c_err += s.get("value", 0.0)
    lines.append(f"publishes: {c_ok if c_ok else len(ok):g} ok, "
                 f"{c_err if c_err else len(err):g} failed"
                 + (f", {len(empty)} empty" if empty else ""))
    rows_t = _counter_total(snapshot, "delta_rows_total")
    bytes_t = _counter_total(snapshot, "delta_bytes_total")
    if rows_t is None and ok:
        rows_t = float(sum(int(e.get("rows") or 0) for e in ok))
        bytes_t = float(sum(int(e.get("bytes") or 0) for e in ok))
    if rows_t is not None:
        lines.append(f"delta rows shipped: {rows_t:g} "
                     f"({(bytes_t or 0.0):g} bytes on wire)")
    for e in ok[-3:]:
        full = ", full" if e.get("full") else ""
        lines.append(f"  PUBLISH {e.get('table')} -> table version "
                     f"{e.get('version')} ({e.get('rows')} rows, "
                     f"{e.get('bytes')} bytes, {e.get('encoding')}{full}) "
                     f"in {e.get('publish_ms')}ms")
    for e in err[-3:]:
        lines.append(f"  PUBLISH FAILED seq {e.get('seq')}: "
                     f"{str(e.get('error', ''))[:90]}")
    a_ok = [e for e in apps if e.get("outcome") == "ok"]
    a_rej = [e for e in apps if e.get("outcome") == "rejected"]
    c_aok = c_arej = 0.0
    for s in fams.get("online_apply_total", {}).get("samples", []):
        if s.get("labels", {}).get("outcome") == "ok":
            c_aok += s.get("value", 0.0)
        elif s.get("labels", {}).get("outcome") == "rejected":
            c_arej += s.get("value", 0.0)
    if apps or "online_apply_total" in fams:
        lines.append(f"serving applies: {c_aok if c_aok else len(a_ok):g} "
                     f"ok, {c_arej if c_arej else len(a_rej):g} rejected")
        for e in a_ok[-3:]:
            lines.append(f"  APPLY {e.get('table')} -> model_version "
                         f"{e.get('model_version')} (table version "
                         f"{e.get('table_version')}) in "
                         f"{e.get('apply_ms')}ms")
        for e in a_rej[-3:]:
            lines.append(f"  APPLY REJECTED (old version keeps serving): "
                         f"{str(e.get('error', ''))[:90]}")
    for s in fams.get("online_publish_seconds", {}).get("samples", []):
        n = s.get("count", 0)
        if not n:
            continue
        p50 = _hist_quantile(s.get("buckets", []), 0.5)
        p99 = _hist_quantile(s.get("buckets", []), 0.99)
        fmt = lambda v: ("?" if v is None else "inf" if math.isinf(v)
                         else f"{v * 1e3:.4g}ms")
        mean = s.get("sum", 0.0) / n
        lines.append(f"publish wall: n={n} mean={mean * 1e3:.4g}ms "
                     f"p50<={fmt(p50)} p99<={fmt(p99)}")
    for s in fams.get("model_staleness_seconds", {}).get("samples", []):
        lines.append(f"model staleness now: {s.get('value', 0.0):g}s")
    return "\n".join(lines)


# -------------------------------------------------------------- warmstore --

def render_warmstore(events: Optional[List[dict]],
                     snapshot: Optional[dict] = None) -> str:
    """Warm-start store activity (paddle_tpu_torch/warmstore/): restore hits by
    tier, miss/quarantine causes, the tier-A probe verdict, bytes on
    disk, and restore wall time (the seconds that would otherwise be in
    ``executor_compile_seconds``)."""
    lines = ["== Warm starts =="]
    events = events or []
    ws = [e for e in events
          if str(e.get("event", "")).startswith("warmstore_")]
    fams = {f.get("name"): f for f in (snapshot or {}).get("families", [])}
    hits_t = _counter_total(snapshot, "warmstore_hits_total")
    miss_t = _counter_total(snapshot, "warmstore_misses_total")
    if not ws and hits_t is None and miss_t is None:
        lines.append("idle: warm store disarmed (point PADDLE_TPU_WARMSTORE "
                     "at a shared directory to reuse compiles across "
                     "restarts, resizes and serving cold starts)")
        return "\n".join(lines)
    by_tier = {}
    for s in fams.get("warmstore_hits_total", {}).get("samples", []):
        t = s.get("labels", {}).get("tier", "?")
        by_tier[t] = by_tier.get(t, 0.0) + s.get("value", 0.0)
    by_reason = {}
    for s in fams.get("warmstore_misses_total", {}).get("samples", []):
        r = s.get("labels", {}).get("reason", "?")
        by_reason[r] = by_reason.get(r, 0.0) + s.get("value", 0.0)
    tier_part = ", ".join(f"tier {t}: {v:g}"
                          for t, v in sorted(by_tier.items()))
    reason_part = ", ".join(f"{r}: {v:g}"
                            for r, v in sorted(by_reason.items()))
    lines.append(f"restores: {hits_t or 0.0:g} "
                 f"({tier_part or 'no tier breakdown'}); "
                 f"misses: {miss_t or 0.0:g}"
                 + (f" ({reason_part})" if reason_part else ""))
    quar_t = _counter_total(snapshot, "warmstore_quarantined_total")
    if quar_t:
        lines.append(f"quarantined entries (.corrupt, checksum/parse "
                     f"failures): {quar_t:g}")
    for f in fams.get("warmstore_bytes_total", {}).get("samples", []):
        lines.append(f"store size now: {f.get('value', 0.0):g} bytes")
    for s in fams.get("warmstore_restore_seconds", {}).get("samples", []):
        n = s.get("count", 0)
        if not n:
            continue
        p50 = _hist_quantile(s.get("buckets", []), 0.5)
        p99 = _hist_quantile(s.get("buckets", []), 0.99)
        fmt = lambda v: ("?" if v is None else "inf" if math.isinf(v)
                         else f"{v * 1e3:.4g}ms")
        mean = s.get("sum", 0.0) / n
        lines.append(f"restore wall (would have been compile): n={n} "
                     f"mean={mean * 1e3:.4g}ms p50<={fmt(p50)} "
                     f"p99<={fmt(p99)}")
    for e in ws:
        if e.get("event") == "warmstore_probe":
            state = "enabled" if e.get("tier_a") else "DISABLED"
            lines.append(f"tier A (serialized executables) {state} "
                         f"[{e.get('source')}]: "
                         f"{str(e.get('reason', ''))[:90]}")
            break
    for e in [x for x in ws if x.get("event") == "warmstore_write"][-3:]:
        lines.append(f"  WRITE {e.get('digest')} kind={e.get('kind')} "
                     f"{e.get('files')} ({e.get('bytes')} bytes)")
    for e in [x for x in ws if x.get("event") == "warmstore_quarantine"][-3:]:
        lines.append(f"  QUARANTINE {e.get('digest')} -> .corrupt "
                     f"({str(e.get('reason', ''))[:60]}) -- fell through "
                     f"to a fresh compile")
    for e in [x for x in ws if x.get("event") == "warmstore_gc"][-1:]:
        lines.append(f"  GC evicted {len(e.get('removed') or [])} "
                     f"entries")
    return "\n".join(lines)


# --------------------------------------------------------------- megastep --

def _counter_total(snapshot: Optional[dict], name: str) -> Optional[float]:
    """Sum a counter family's samples from a metrics snapshot (None when
    the family is absent or no snapshot was given)."""
    if not snapshot:
        return None
    total, seen = 0.0, False
    for f in snapshot.get("families", []):
        if f.get("name") == name:
            for s in f.get("samples", []):
                total += s.get("value", 0.0)
                seen = True
    return total if seen else None


def render_megastep(events: List[dict],
                    snapshot: Optional[dict] = None) -> str:
    """Fused multi-step execution activity: ``megastep`` journal events
    (Executor.run_fused) + the lazy-fetch materialization counter."""
    lines = ["== Megastep =="]
    megas = [e for e in events if e.get("event") == "megastep"]
    mats = _counter_total(snapshot, "fused_fetch_materializations_total")
    if not megas and not mats:
        lines.append("unfused: no megastep events (run "
                     "train_from_dataset(fuse_steps=K) or bench "
                     "--fuse-steps)")
        return "\n".join(lines)
    substeps = sum(int(e.get("k") or 0) for e in megas)
    ks = sorted({int(e.get("k") or 0) for e in megas})
    lines.append(f"{len(megas)} megasteps covering {substeps} substeps "
                 f"(K values: {ks})")
    amort = [e["amortized_ms"] for e in megas
             if e.get("amortized_ms") is not None]
    if amort:
        lines.append("amortized dispatch ms/substep: " + _stats(amort))
    compiles = [e["compile_ms"] for e in megas
                if e.get("compile_ms") is not None]
    if compiles:
        lines.append("megastep compile_ms: " + _stats(compiles))
    hits = sum(1 for e in megas if e.get("cache") == "hit")
    if megas:
        lines.append(f"compile cache: {hits} hits / {len(megas) - hits} "
                     f"misses")
    if mats is not None:
        lines.append(f"fetch materializations (lazy-fetch d2h syncs): "
                     f"{mats:g}")
    return "\n".join(lines)


# ----------------------------------------------------------------- memory --

_MEMORY_FAMILIES = ("device_memory_bytes_in_use", "device_memory_peak_bytes",
                    "program_peak_bytes", "program_temp_bytes",
                    "program_argument_bytes", "program_output_bytes",
                    "program_static_peak_bytes", "program_static_peak_ratio")


def _gb(v: float) -> str:
    return (f"{v / 1e9:.3f} GB" if v >= 1e9 else
            f"{v / 1e6:.3f} MB" if v >= 1e6 else f"{v:.0f} B")


def render_memory(snapshot: dict) -> str:
    """Device occupancy gauges + per-program XLA footprint, human units."""
    lines = ["== Device memory =="]
    # accumulate samples across same-named families: a Prometheus text dump
    # parses to one single-sample family PER series, so a last-wins dict
    # would silently drop all but one device/program
    fams = {}
    for f in snapshot.get("families", []):
        if f["name"] in _MEMORY_FAMILIES:
            fams.setdefault(f["name"], {"samples": []})["samples"].extend(
                f.get("samples", []))
    if not fams:
        lines.append("(no memory samples; run with PADDLE_TPU_OBS=1 or "
                     "compile at least one program)")
        return "\n".join(lines)
    for name in ("device_memory_bytes_in_use", "device_memory_peak_bytes"):
        for s in fams.get(name, {}).get("samples", []):
            dev = s.get("labels", {}).get("device", "?")
            what = "in use" if name.endswith("in_use") else "peak"
            lines.append(f"  {dev}: {_gb(s.get('value', 0.0))} {what}")
    progs = {}
    for name in ("program_peak_bytes", "program_temp_bytes",
                 "program_argument_bytes", "program_output_bytes",
                 "program_static_peak_bytes", "program_static_peak_ratio"):
        for s in fams.get(name, {}).get("samples", []):
            label = s.get("labels", {}).get("program", "?")
            progs.setdefault(label, {})[name] = s.get("value", 0.0)
    for label, parts in sorted(progs.items()):
        peak = parts.get("program_peak_bytes", 0.0)
        line = (
            f"  program {label}: peak {_gb(peak)} "
            f"(args {_gb(parts.get('program_argument_bytes', 0.0))}, "
            f"temp {_gb(parts.get('program_temp_bytes', 0.0))}, "
            f"out {_gb(parts.get('program_output_bytes', 0.0))})")
        static = parts.get("program_static_peak_bytes")
        if static is not None:
            # the analysis/memplan.py planner's estimate vs XLA's exact
            # memory_analysis(): the ratio is the planner's accuracy
            ratio = parts.get("program_static_peak_ratio")
            line += f"; static plan {_gb(static)}"
            if ratio:
                line += f" ({ratio:.2f}x of XLA)"
        lines.append(line)
    return "\n".join(lines)


# ------------------------------------------------------------ attribution --

def render_attribution(events: Optional[List[dict]],
                       snapshot: Optional[dict],
                       bench_summary: Optional[List[str]] = None) -> str:
    """Inside the step: the JAX package's per-category hlo_op_bytes gauges
    and its attribution events with copy-pair blame; the port's
    op_device_seconds gauges and attribution events
    (paddle_tpu_torch/observability/attribution.py, at a capture miss when
    PADDLE_TPU_OBS_ATTRIB is armed); and, when the caller passes them, the
    bench trajectory's lines."""
    lines = ["== Attribution & trajectory =="]
    progs = {}
    fams = {}
    for f in (snapshot or {}).get("families", []):
        if f["name"] in ("hlo_op_bytes", "hlo_attributed_bytes_fraction"):
            fams.setdefault(f["name"], []).extend(f.get("samples", []))
    for s in fams.get("hlo_op_bytes", []):
        lab = s.get("labels", {})
        progs.setdefault(lab.get("program", "?"), {})[
            lab.get("category", "?")] = s.get("value", 0.0)
    cover = {s.get("labels", {}).get("program", "?"): s.get("value")
             for s in fams.get("hlo_attributed_bytes_fraction", [])}
    for label, cats in sorted(progs.items()):
        total = sum(cats.values())
        split = ", ".join(f"{c} {_gb(v)}" for c, v in
                          sorted(cats.items(), key=lambda kv: -kv[1])
                          if v)
        line = f"  program {label}: {_gb(total)} modeled/step ({split})"
        if cover.get(label) is not None:
            line += f"; {cover[label]:.0%} IR-attributed"
        lines.append(line)
    # the port's own attribution: device seconds of each IR op's kernels in
    # a profiled eager run (op_device_seconds{program,op,category})
    dev = {}
    for f in (snapshot or {}).get("families", []):
        if f["name"] == "op_device_seconds":
            for s in f.get("samples", []):
                lab = s.get("labels", {})
                cats = dev.setdefault(lab.get("program", "?"), {})
                cat = lab.get("category", "?")
                cats[cat] = cats.get(cat, 0.0) + s.get("value", 0.0)
    for label, cats in sorted(dev.items()):
        split = ", ".join(f"{c} {v * 1e3:.3f} ms" for c, v in
                          sorted(cats.items(), key=lambda kv: -kv[1]) if v)
        lines.append(f"  program {label}: {sum(cats.values()) * 1e3:.3f} ms "
                     f"device/step attributed ({split})")
    attrib_events = [e for e in (events or [])
                     if e.get("event") == "attribution"]
    for e in attrib_events[-4:]:
        if "device_seconds" in e:      # the port's event
            tops = ", ".join(f"{t['ir']} {t['device_seconds'] * 1e3:.3f} ms"
                             for t in e.get("top_ops", [])[:3])
            frac = e.get("attributed_device_fraction")
            lines.append(f"  {e.get('program', '?')} [{e.get('device', '?')}]: "
                         f"{e['device_seconds'] * 1e3:.3f} ms device"
                         + (f", {frac:.0%} attributed" if frac is not None else "")
                         + (f"; top ops: {tops}" if tops else ""))
            continue
        tops = ", ".join(f"{t['ir']} {_gb(t['bytes'])}"
                         for t in e.get("top_ops", [])[:3])
        if tops:
            lines.append(f"  {e.get('program', '?')} top ops: {tops}")
        for p in e.get("copy_pairs", [])[:3]:
            lines.append(f"    layout round-trip {p['producer']} -> "
                         f"{p['consumer']}: {_gb(p['bytes'])} in "
                         f"{p['n']} copy/transpose(s)  [PT060]")
    if not progs and not dev and not attrib_events:
        lines.append("(no attribution samples; arm PADDLE_TPU_OBS_ATTRIB=1)")
    if bench_summary:
        lines.append("  -- bench trajectory (tools/bench_compare.py) --")
        lines.extend("  " + ln for ln in bench_summary)
    return "\n".join(lines)


# ---------------------------------------------------------------- goodput --

def render_goodput(events: Optional[List[dict]],
                   snapshot: Optional[dict]) -> str:
    """Wall-clock ledger: productive step time vs named loss causes
    (paddle_tpu_torch/observability/goodput.py), computed from whatever the
    caller loaded -- journal alone degrades to run/compile attribution,
    a metrics snapshot adds the per-phase split."""
    from ..observability import goodput as _goodput
    lines = ["== Goodput =="]
    rep = _goodput.compute(events=events, snapshot=snapshot)
    lines.append(rep.summary())
    return "\n".join(lines)


# ------------------------------------------------------------------ fleet --

def render_fleet(events: Optional[List[dict]]) -> str:
    """Cross-rank view: the last fleet collection's per-rank step-time
    table, straggler verdicts, and elastic-restart downtime
    (paddle_tpu/observability/fleet.py + parallel/launch.py)."""
    lines = ["== Fleet =="]
    events = events or []
    fleets = [e for e in events if e.get("event") == "fleet"]
    stragglers = [e for e in events if e.get("event") == "straggler"]
    restarts = [e for e in events if e.get("event") == "elastic_restart"]
    downtimes = [e for e in events
                 if e.get("event") == "elastic_restart_downtime"]
    if not fleets and not stragglers and not restarts:
        lines.append("single-rank: no fleet/straggler events (arm "
                     "PADDLE_TPU_FLEET=gather|scrape under "
                     "parallel.launch)")
        return "\n".join(lines)
    if fleets:
        last = fleets[-1]
        lines.append(f"{len(fleets)} collection(s) "
                     f"[{last.get('transport', '?')}]; last: "
                     f"{last.get('n_ranks')} rank(s), median "
                     f"{last.get('median_ms')}ms, skew "
                     f"{last.get('skew')}x")
        for r in last.get("ranks", []):
            mark = " STRAGGLER" if r.get("rank") in \
                (last.get("stragglers") or []) else ""
            lines.append(
                f"  rank {r.get('rank')} ({r.get('host')}): step "
                f"{r.get('step_ms')}ms (MAD {r.get('mad_ms')}ms, "
                f"n={r.get('n')}), {r.get('steps')} steps, "
                f"{r.get('restarts')} restart(s){mark}")
    if stragglers:
        lines.append(f"{len(stragglers)} straggler verdict(s) (last 10):")
        for e in stragglers[-10:]:
            lines.append(
                f"  STRAGGLER rank {e.get('rank')}: {e.get('step_ms')}ms "
                f"vs fleet median {e.get('median_ms')}ms "
                f"(limit {e.get('limit_ms')}ms)")
    if restarts or downtimes:
        lost = sum(float(e.get("downtime_s") or 0.0) for e in downtimes)
        lines.append(f"{len(restarts)} elastic restart(s), "
                     f"{lost:.1f}s measured downtime")
        by_rank = {}
        for e in restarts:
            r = e.get("failed_rank")
            by_rank[r] = by_rank.get(r, 0) + 1
        for r, n in sorted(by_rank.items(), key=lambda kv: str(kv[0])):
            lines.append(f"  rank {r}: {n} failure(s)")
    return "\n".join(lines)


# ----------------------------------------------------- alerts/postmortem --

def render_alerts(events: Optional[List[dict]],
                  snapshot: Optional[dict] = None) -> str:
    """SLO alert firings/resolutions (observability/slo.py + alerts.py)
    and post-mortem black-box bundles (observability/blackbox.py)."""
    lines = ["== Alerts & post-mortems =="]
    events = events or []
    armed = [e for e in events if e.get("event") == "slo_armed"]
    alerts = [e for e in events if e.get("event") == "alert"]
    bundles = [e for e in events if e.get("event") == "postmortem"]
    if not armed and not alerts and not bundles:
        lines.append("no alert/postmortem events (arm PADDLE_TPU_OBS_SLO="
                     "rules.json and PADDLE_TPU_OBS_BLACKBOX=1)")
        return "\n".join(lines)
    if armed:
        last = armed[-1]
        rules = [str(r) for r in (last.get("rules") or [])]
        shown = ", ".join(rules[:6]) + (", ..." if len(rules) > 6 else "")
        lines.append(f"SLO engine armed: {len(rules)} rule(s) [{shown}], "
                     f"interval {last.get('interval_s')}s, poller "
                     f"{'on' if last.get('poller') else 'off'}")

    def _key(e):
        return (e.get("rule"), e.get("window"),
                tuple(sorted((e.get("labels") or {}).items())))

    if alerts:
        fired = [e for e in alerts if e.get("state") == "firing"]
        resolved = [e for e in alerts if e.get("state") == "resolved"]
        still = {}
        for e in alerts:
            if e.get("state") == "firing":
                still[_key(e)] = e
            elif e.get("state") == "resolved":
                still.pop(_key(e), None)
        lines.append(f"{len(fired)} firing(s), {len(resolved)} "
                     f"resolution(s); {len(still)} still firing")
        for e in list(still.values())[:10]:
            lab = ",".join(f"{k}={v}" for k, v
                           in sorted((e.get("labels") or {}).items()))
            name = f"{e.get('rule')}{{{lab}}}" if lab else str(e.get("rule"))
            lines.append(f"  FIRING [{e.get('severity')}] {name} "
                         f"[{e.get('window')}]: observed "
                         f"{e.get('observed')} vs {e.get('objective')} "
                         f"(burn {e.get('burn')})")
        for e in resolved[-5:]:
            lines.append(f"  resolved {e.get('rule')} [{e.get('window')}]")
    n_total = _counter_total(snapshot, "alerts_total")
    if n_total is not None:
        n_active = _counter_total(snapshot, "alerts_active") or 0.0
        lines.append(f"alert firings counted: {int(n_total)}; "
                     f"active now: {int(n_active)}")
    if bundles:
        lines.append(f"{len(bundles)} post-mortem bundle(s):")
        for e in bundles[-5:]:
            lines.append(f"  BUNDLE [{e.get('reason')}] -> "
                         f"{e.get('path')}")
        lines.append(f"triage with: {TRIAGE}")
    return "\n".join(lines)


# --------------------------------------------------------------- timeline --

def render_timeline(trace_events: List[dict]) -> str:
    """Chrome-trace event list -> per-phase span summary + counter tracks."""
    lines = ["== Timeline =="]
    spans = [e for e in trace_events if e.get("ph") == "X"]
    counts = [e for e in trace_events if e.get("ph") == "C"]
    if not spans and not counts:
        lines.append("(no trace events)")
        return "\n".join(lines)
    by_name = {}
    for e in spans:
        # group by (name, category): executor and Predictor both record
        # dispatch/feed_prep/fetch_sync spans and merging them would
        # describe neither workload
        key = (e.get("name", "?"), e.get("cat", ""))
        by_name.setdefault(key, []).append(
            float(e.get("dur", 0.0)) / 1e3)   # us -> ms
    lines.append(f"{len(spans)} spans over {len(by_name)} phases:")
    for (name, cat), durs in sorted(by_name.items(),
                                    key=lambda kv: -sum(kv[1])):
        shown = name if cat in ("", "executor") else f"{name} [{cat}]"
        lines.append(f"  {shown}: " + _stats(durs))
    tracks = {}
    for e in counts:
        tracks.setdefault(e.get("name", "?"), 0)
        tracks[e.get("name", "?")] += 1
    for t, n in sorted(tracks.items()):
        lines.append(f"  counter track {t!r}: {n} samples")
    return "\n".join(lines)


def load_trace(path: str) -> List[dict]:
    from ..observability.timeline import validate_trace
    return validate_trace(path)


# ---------------------------------------------------------------- metrics --

def render_metrics(snapshot: dict) -> str:
    lines = ["== Metrics registry =="]
    fams = snapshot.get("families", [])
    if not fams:
        lines.append("(empty)")
        return "\n".join(lines)
    for fam in sorted(fams, key=lambda f: (f["type"], f["name"])):
        for s in fam["samples"]:
            label = ",".join(f"{k}={v}" for k, v in
                             sorted(s.get("labels", {}).items()))
            name = fam["name"] + (f"{{{label}}}" if label else "")
            if fam["type"] == "histogram":
                n, tot = s.get("count", 0), s.get("sum", 0.0)
                mean = tot / n if n else 0.0
                p50 = _hist_quantile(s.get("buckets", []), 0.5)
                p99 = _hist_quantile(s.get("buckets", []), 0.99)
                fmt = lambda v: ("inf" if v is not None and math.isinf(v)
                                 else f"{v:.4g}" if v is not None else "?")
                lines.append(f"  [hist]    {name}: n={n} mean={mean:.4g} "
                             f"p50<={fmt(p50)} p99<={fmt(p99)}")
            else:
                lines.append(f"  [{fam['type']:<7}] {name} = "
                             f"{s.get('value'):g}")
    return "\n".join(lines)


def _prom_to_snapshot(samples: dict) -> dict:
    """Prometheus parse -> the families/samples shape render_metrics eats.
    Histogram component samples stay as individual gauges -- good enough
    for a readable report of a text-format dump."""
    fams = []
    for (name, labels), value in sorted(samples.items()):
        fams.append({"name": name, "type": "gauge", "help": "",
                     "samples": [{"labels": dict(labels), "value": value}]})
    return {"families": fams}


def load_metrics(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    try:
        return json.loads(text)
    except ValueError:
        from ..observability.export import parse_prometheus
        return _prom_to_snapshot(parse_prometheus(text))


def render_report(events: Optional[List[dict]],
                  snapshot: Optional[dict],
                  trace_events: Optional[List[dict]] = None,
                  goodput: bool = False, fleet: bool = False,
                  bench_summary: Optional[List[str]] = None) -> str:
    parts = ["# paddle_tpu observability report"]
    if events is not None:
        parts.append(render_journal(events))
        parts.append(render_megastep(events, snapshot))
        parts.append(render_health(events))
        parts.append(render_resilience(events))
        parts.append(render_checkpoint(events, snapshot))
        parts.append(render_serving(events, snapshot))
        parts.append(render_ingestion(events, snapshot))
        parts.append(render_online(events, snapshot))
        parts.append(render_warmstore(events, snapshot))
        parts.append(render_alerts(events, snapshot))
    if bench_summary is not None or snapshot is not None or events:
        parts.append(render_attribution(events, snapshot, bench_summary))
    if goodput:
        parts.append(render_goodput(events, snapshot))
    if fleet:
        parts.append(render_fleet(events))
    if trace_events is not None:
        parts.append(render_timeline(trace_events))
    if snapshot is not None:
        parts.append(render_metrics(snapshot))
        parts.append(render_memory(snapshot))
    if events:
        tail = events[-10:]
        parts.append("== Journal tail ==")
        parts.extend(json.dumps(e, sort_keys=True, default=str)
                     for e in tail)
    return "\n\n".join(parts)


# --------------------------------------------------------------- selftest --

def selftest() -> int:
    """Build a synthetic registry + journal, render them through the same
    code path the CLI uses, and assert the report carries the signal. Run
    from the test suite so this CLI cannot rot."""
    import tempfile

    from ..observability import export as obs_export
    from ..observability.metrics import MetricsRegistry

    reg = MetricsRegistry()
    reg.counter("executor_cache_hits_total", cache="compile").inc(3)
    reg.counter("executor_cache_misses_total", cache="compile").inc()
    reg.counter("executor_recompiles_total", component="shape").inc()
    reg.gauge("program_mfu", program="1:v0").set(0.42)
    h = reg.histogram("executor_run_seconds")
    for v in (0.002, 0.004, 0.008, 0.5):
        h.observe(v)
    reg.gauge("device_memory_bytes_in_use", device="cpu:0").set(512e6)
    reg.gauge("device_memory_peak_bytes", device="cpu:0").set(2e9)
    reg.gauge("program_peak_bytes", program="1:v0").set(1.5e9)
    reg.gauge("program_temp_bytes", program="1:v0").set(3e8)
    reg.gauge("program_static_peak_bytes", program="1:v0").set(1.8e9)
    reg.gauge("program_static_peak_ratio", program="1:v0").set(1.2)
    # attribution section sources (observability/attribution.py)
    reg.gauge("hlo_op_bytes", program="1:v0", category="fusion").set(3e8)
    reg.gauge("hlo_op_bytes", program="1:v0", category="layout").set(6.4e7)
    reg.gauge("hlo_op_bytes", program="1:v0", category="compute").set(1e8)
    reg.gauge("hlo_attributed_bytes_fraction", program="1:v0").set(0.978)
    reg.counter("fused_fetch_materializations_total").inc(3)
    reg.counter("tensor_nonfinite_total", where="executor").inc()
    reg.counter("anomaly_total", kind="step_time").inc()
    reg.counter("fault_injected_total", kind="nan", site="fetch").inc()
    reg.counter("step_retries_total", site="dispatch").inc()
    reg.counter("steps_skipped_total").inc()
    reg.counter("rollback_total").inc()
    reg.counter("preemption_saves_total").inc()
    # goodput section sources: per-phase second sums (10s wall below:
    # 6s dispatch+sync productive, 0.8s compile, 0.5s prefetch stalls ...)
    for phase, cat, secs in (("dispatch", "executor", 4.0),
                             ("fetch_sync", "executor", 2.0),
                             ("feed_prep", "executor", 0.3),
                             ("journal", "executor", 0.1),
                             ("compile", "executor", 0.8),
                             ("verify", "executor", 0.05),
                             ("feed_wait", "dataset", 0.5)):
        reg.histogram("phase_seconds", phase=phase, cat=cat).observe(secs)
    reg.counter("straggler_total", rank="1").inc()
    # serving section sources (paddle_tpu_torch/serving/)
    reg.gauge("serving_queue_depth").set(2)
    reg.counter("serving_requests_total", tenant="a",
                outcome="accepted").inc(9)
    reg.counter("serving_requests_total", tenant="a", outcome="shed").inc()
    for v in (0.004, 0.006, 0.009):
        reg.histogram("serving_request_seconds", tenant="a").observe(v)
    # serving reliability sources
    reg.counter("serving_timeout_total", tenant="a").inc(2)
    reg.gauge("serving_breaker_state", tenant="evil", sig="00c0ffee").set(2)
    reg.gauge("serving_model_version").set(2)
    reg.counter("serving_worker_crash_total").inc()
    # ingestion section sources (paddle_tpu_torch/data/ streaming)
    reg.counter("stream_records_total").inc(120)
    reg.counter("samples_quarantined_total", reason="slot_count").inc(3)
    reg.counter("source_retries_total", source="clicks").inc(2)
    reg.gauge("stream_buffer_depth").set(7)
    for v in (0.003, 0.005, 0.011):
        reg.histogram("sample_age_seconds").observe(v)
    # online-learning section sources (the JAX package's paddle_tpu/online/)
    reg.counter("delta_rows_total", table="emb").inc(128)
    reg.counter("delta_bytes_total", table="emb").inc(4096)
    reg.counter("online_publish_total", outcome="ok").inc(3)
    reg.counter("online_publish_total", outcome="error").inc()
    reg.counter("online_apply_total", outcome="ok").inc(3)
    reg.counter("online_apply_total", outcome="rejected").inc()
    for v in (0.004, 0.006, 0.011):
        reg.histogram("online_publish_seconds").observe(v)
    reg.gauge("model_staleness_seconds").set(2.5)
    # warm-start store sources (paddle_tpu_torch/warmstore/)
    reg.counter("warmstore_hits_total", tier="b").inc(2)
    reg.counter("warmstore_misses_total", reason="absent").inc(3)
    reg.counter("warmstore_misses_total", reason="corrupt").inc()
    reg.counter("warmstore_quarantined_total").inc()
    reg.gauge("warmstore_bytes_total").set(12781)
    for v in (0.02, 0.03):
        reg.histogram("warmstore_restore_seconds").observe(v)
    # alerts & post-mortem sources (observability/slo.py + blackbox.py)
    reg.counter("alerts_total", rule="training-goodput",
                severity="page").inc(2)
    reg.gauge("alerts_active").set(1)
    reg.counter("postmortem_bundles_total", reason="retries_exhausted").inc()

    events = [
        {"event": "run", "program": 1, "version": 0, "cache": "miss",
         "compile_ms": 812.0, "run_ms": 9.1,
         "feed": {"x": [[8, 3], "float32"]}, "fetch": ["loss"], "ts": 0.0},
        {"event": "run", "program": 1, "version": 0, "cache": "hit",
         "compile_ms": None, "run_ms": 4.2,
         "feed": {"x": [[8, 3], "float32"]}, "fetch": ["loss"], "ts": 1.0},
        {"event": "recompile", "program": 1, "version": 0,
         "changed": ["shape"], "ts": 2.0},
        # attribution section (IR->HLO cost attribution at compile miss)
        {"event": "attribution", "program": "1:v0", "instructions": 740,
         "model_bytes": 4.64e8, "cost_bytes": 4.6e8, "coverage": 0.978,
         "categories": {"fusion": 3e8, "layout": 6.4e7, "compute": 1e8},
         "top_ops": [{"ir": "conv2d#12", "bytes": 9e7},
                     {"ir": "momentum#163", "bytes": 4e7}],
         "copy_pairs": [{"producer": "input", "consumer": "momentum#163",
                         "bytes": 1.9e7, "n": 1}], "ts": 2.1},
        # megastep section (fused multi-step execution)
        {"event": "megastep", "program": 1, "version": 0, "cache": "miss",
         "k": 8, "step0": 0, "compile_ms": 950.0, "run_ms": 24.0,
         "amortized_ms": 3.0, "feed": {"x": [[8, 3], "float32"]},
         "fetch": ["loss"], "ts": 2.2},
        {"event": "megastep", "program": 1, "version": 0, "cache": "hit",
         "k": 8, "step0": 8, "compile_ms": None, "run_ms": 20.0,
         "amortized_ms": 2.5, "feed": {"x": [[8, 3], "float32"]},
         "fetch": ["loss"], "ts": 2.4},
        {"event": "tensor_nonfinite", "program": "1:v0",
         "where": "executor", "var": "loss", "vars": ["loss"], "ts": 3.0},
        {"event": "step_time_anomaly", "program": "1:v0", "step_ms": 99.0,
         "median_ms": 4.0, "mad_ms": 0.2, "limit_ms": 5.6, "n_window": 32,
         "ts": 4.0},
        # resilience section (paddle_tpu_torch/resilience/)
        {"event": "fault", "kind": "nan", "site": "fetch", "step": 3,
         "var": "loss", "program": "1:v0", "ts": 5.0},
        {"event": "skip", "step": 3, "vars": ["loss"], "restored_step": 3,
         "source": "ring", "ts": 5.5},
        {"event": "retry", "site": "dispatch", "step": 5, "attempt": 1,
         "backoff_ms": 42.0, "error": "UNAVAILABLE: injected transient",
         "ts": 6.0},
        {"event": "rollback", "step": 9, "to_step": 8, "source": "ring",
         "vars": ["loss"], "ts": 7.0},
        {"event": "preempt", "step": 7, "saved_step": 6,
         "reason": "signal 15", "ts": 8.0},
        {"event": "elastic_restart", "attempt": 1, "max_restarts": 2,
         "failed_rank": 1, "exit_codes": [None, 3], "backoff_s": 1.4,
         "ts": 9.0},
        {"event": "elastic_restart_downtime", "attempt": 1,
         "downtime_s": 1.2, "ts": 9.1},
        # fleet section (cross-rank aggregation + straggler detection)
        {"event": "fleet", "transport": "gather", "n_ranks": 2,
         "median_ms": 4.2, "skew": 3.1, "stragglers": [1],
         "ranks": [{"rank": 0, "host": "h0", "step_ms": 4.2, "mad_ms": 0.2,
                    "n": 16, "steps": 64, "restarts": 0},
                   {"rank": 1, "host": "h1", "step_ms": 13.0, "mad_ms": 0.3,
                    "n": 16, "steps": 64, "restarts": 1}], "ts": 9.2},
        {"event": "straggler", "rank": 1, "host": "h1", "step_ms": 13.0,
         "median_ms": 4.2, "mad_ms": 0.2, "limit_ms": 5.9, "n_ranks": 2,
         "ts": 9.3},
        # checkpoint section (durable checkpointing)
        {"event": "ckpt_save", "step": 6, "async": False, "bytes": 4096,
         "blocked_ms": 12.0, "write_ms": 12.0, "ts": 9.5},
        {"event": "ckpt_save", "step": 8, "async": True, "bytes": 4096,
         "blocked_ms": 0.8, "write_ms": 11.0, "ts": 9.6},
        {"event": "ckpt_corrupt", "kind": "crc", "file": "ck/ckpt-8/w.npy",
         "var": "w", "detail": "crc32 1, manifest says 2", "ts": 9.7},
        {"event": "ckpt_quarantine", "step": 8, "kind": "crc",
         "to": "ck/ckpt-8.corrupt", "reason": "crc mismatch", "ts": 9.8},
        # serving section (continuous batching + Predictor pool)
        {"event": "serve_batch", "requests": 3, "rows": 6, "padded_rows": 8,
         "exec_ms": 4.5, "dtype": "float32", "ok": 3,
         "tenants": {"a": 4, "b": 2}, "ts": 9.85},
        {"event": "serve_shed", "tenant": "a", "reason": "tenant_quota",
         "ts": 9.9},
        # serving reliability (deadlines / breaker / swap / crash / drain)
        {"event": "serve_timeout", "tenant": "a", "waited_ms": 52.0,
         "deadline_ms": 50.0, "ts": 9.91},
        {"event": "serve_timeout", "tenant": "a", "waited_ms": 61.0,
         "deadline_ms": 50.0, "ts": 9.92},
        {"event": "serve_breaker", "tenant": "evil", "sig": "00c0ffee",
         "from": "closed", "to": "open", "failures": 3, "backoff_s": 0.5,
         "ts": 9.93},
        {"event": "serve_swap", "outcome": "ok", "model_version": 2,
         "swap_ms": 41.2, "ts": 9.94},
        {"event": "serve_worker_crash", "worker": 1,
         "error": "TransientFault: UNAVAILABLE: injected", "ts": 9.95},
        {"event": "serve_drain_timeout", "failed_queued": 2,
         "failed_in_flight": 1, "waited_s": 0.4, "ts": 9.96},
        # ingestion section (streaming data plane)
        {"event": "source_retry", "source": "clicks", "attempt": 1,
         "backoff_ms": 40.0, "error": "UNAVAILABLE: injected transient "
         "fault at read", "ts": 9.961},
        {"event": "sample_quarantined", "where": "clicks:418",
         "reason": "slot_count", "error": "line at clicks:418 has 3 "
         "slots but set_use_var lists 1 vars",
         "dead_letter": "dead.jsonl", "ts": 9.962},
        {"event": "source_lost", "source": "flaky", "attempts": 5,
         "error": "ConnectionResetError: peer reset", "ts": 9.963},
        {"event": "stream_seek", "sources": {"clicks": 1024},
         "records": 36, "dead_letters": 3, "ts": 9.964},
        {"event": "source_skipped", "file": "part-00007.txt",
         "ts": 9.965},
        {"event": "stream_epoch", "batches": 12, "records": 36,
         "dead_letters": 3, "sources": {"clicks": 2048}, "ts": 9.966},
        # online-learning section (the JAX package's paddle_tpu/online/)
        {"event": "online_publish", "outcome": "ok", "table": "emb",
         "seq": 3, "version": 42, "rows": 64, "bytes": 2048,
         "full": False, "encoding": "int8", "publish_ms": 5.2,
         "ts": 9.967},
        {"event": "online_publish", "outcome": "error", "table": "emb",
         "seq": 4, "since": 42,
         "error": "delta apply rejected: chunk 0: crc32 mismatch",
         "ts": 9.968},
        {"event": "online_apply", "outcome": "ok", "table": "emb",
         "model_version": 5, "table_version": 42, "rows": 64,
         "apply_ms": 1.3, "ts": 9.969},
        {"event": "online_apply", "outcome": "rejected", "table": "emb",
         "error": "chunk 0: crc32 mismatch (torn or bit-flipped payload)",
         "ts": 9.9695},
        # alerts & post-mortem section
        {"event": "slo_armed", "rules": ["training-goodput",
                                        "serving-latency-p99"],
         "interval_s": 5.0, "poller": True, "ts": 9.97},
        {"event": "alert", "state": "firing", "rule": "training-goodput",
         "severity": "page", "window": "300s/60s", "labels": {},
         "observed": 0.61, "objective": "goodput_fraction >= 0.85",
         "burn": 39.0, "ts": 9.971},
        {"event": "alert", "state": "firing", "rule": "serving-latency-p99",
         "severity": "page", "window": "300s/60s",
         "labels": {"tenant": "a"}, "observed": 0.052,
         "objective": "serving_request_seconds{tenant=a} p99 <= 0.025",
         "burn": 18.0, "ts": 9.972},
        {"event": "alert", "state": "resolved",
         "rule": "serving-latency-p99", "severity": "page",
         "window": "300s/60s", "labels": {"tenant": "a"},
         "observed": 0.009,
         "objective": "serving_request_seconds{tenant=a} p99 <= 0.025",
         "burn": 0.0, "ts": 9.973},
        {"event": "postmortem", "reason": "retries_exhausted",
         "path": "postmortems/postmortem-20260806T000000Z-p1/bundle.json",
         "ts": 9.974},
        # warm-start store section (paddle_tpu_torch/warmstore/)
        {"event": "warmstore_probe", "tier_a": False,
         "reason": "jaxlib<=0.4.36 CPU executable (de)serialization "
                   "corrupts the glibc heap",
         "source": "denylist", "ts": 9.975},
        {"event": "warmstore_write", "digest": "3a30af139ce5d56a",
         "kind": "train_step", "files": ["tier_b.bin"], "bytes": 5437,
         "ts": 9.976},
        {"event": "warmstore_hit", "tier": "b",
         "digest": "3a30af139ce5d56a", "kind": "train_step", "ts": 9.977},
        {"event": "warmstore_quarantine", "digest": "89f712229c015fed",
         "reason": "tier_b.bin checksum", "ts": 9.978},
    ]

    # a synthetic flight-recorder trace through the real exporter
    from ..observability import timeline as obs_timeline

    with tempfile.TemporaryDirectory() as td:
        jpath = os.path.join(td, "journal.jsonl")
        with open(jpath, "w") as f:
            for e in events:
                f.write(json.dumps(e) + "\n")
        mpath = os.path.join(td, "metrics.json")
        obs_export.dump_json(mpath, reg)
        ppath = os.path.join(td, "metrics.prom")
        with open(ppath, "w") as f:
            f.write(obs_export.to_prometheus(reg))
        # synthetic spans through the real exporter, hermetically: snapshot
        # and restore the process-global ring (raw appends, not
        # record_span, so the global phase_seconds histogram isn't
        # polluted either), and keep the host's real RecordEvent spans out
        saved = (obs_timeline.spans(), obs_timeline.counters())
        obs_timeline.clear()
        try:
            with obs_timeline._lock:
                obs_timeline._spans.append(
                    ("feed_prep", "executor", 1.0, 0.002, {"step": 0}))
                obs_timeline._spans.append(
                    ("dispatch", "executor", 1.002, 0.009, {"step": 0}))
                obs_timeline._counters.append(
                    ("device_memory_bytes", 1.011, {"cpu:0": 512e6}))
            tpath = obs_timeline.export_chrome_trace(
                os.path.join(td, "trace.json"), include_profiler=False)
        finally:
            with obs_timeline._lock:
                obs_timeline._spans.clear()
                obs_timeline._spans.extend(saved[0])
                obs_timeline._counters.clear()
                obs_timeline._counters.extend(saved[1])

        # the bench trajectory's lines as a caller passes them (the port
        # has no bench_compare yet)
        bench_summary = ["bench trajectory: 1 metric series over 2 round(s)"]

        from ..observability.journal import read_journal
        report = render_report(read_journal(jpath), load_metrics(mpath),
                               load_trace(tpath), goodput=True, fleet=True,
                               bench_summary=bench_summary)
        for must in ("2 executor runs", "1 recompiles", "hit rate",
                     "changed ['shape']", "program_mfu", "0.42",
                     "executor_run_seconds", "n=4",
                     # megastep section
                     "2 megasteps covering 16 substeps",
                     "amortized dispatch ms/substep",
                     "fetch materializations (lazy-fetch d2h syncs): 3",
                     # health section
                     "NONFINITE executor", "'loss'", "step-time anomalies",
                     "99.0ms",
                     # resilience section
                     "1 injected fault(s): nan@fetch x1",
                     "retry step 5 @dispatch attempt 1",
                     "1 skipped nonfinite step(s): [3]",
                     "ROLLBACK at step 9 -> step 8",
                     "PREEMPT at step 7: emergency checkpoint step 6",
                     "1 elastic restart(s)", "rank 1 failed",
                     "fault_injected_total", "steps_skipped_total",
                     # checkpoint section
                     "1 sync save(s)", "1 async save(s)",
                     "write ms/save (background)",
                     "CORRUPT chunk detected (crc)",
                     "QUARANTINE step 8 (crc) -> ck/ckpt-8.corrupt",
                     # serving section
                     "== Serving ==",
                     "1 batches serving 3 requests (6 rows, bucket fill "
                     "75.0%)",
                     "shed rate: 10.0% (1 of 10 offered)",
                     "shed a/tenant_quota: x1", "queue depth now: 2",
                     "tenant a: n=3", "p99<=",
                     # serving reliability rows
                     "deadline timeouts: 2 (a: x2)",
                     "breaker: 1 transition(s) (1 open, 0 re-closed)",
                     "now not-closed: evil/00c0ffee=open",
                     "BREAKER evil/00c0ffee closed -> open (failures 3)",
                     "hot swaps: 1 ok, 0 rejected",
                     "SWAP -> model_version 2 in 41.2ms",
                     "model version now: 2",
                     "worker crashes (respawned): 1",
                     "CRASH worker 1: TransientFault",
                     "DRAIN TIMEOUT after 0.4s: 2 queued + 1 in-flight "
                     "failed typed",
                     # ingestion section
                     "== Ingestion ==",
                     "last stream epoch: 12 batch(es), 36 record(s) "
                     "consumed, 3 dead-letter(s)",
                     "records ingested: 120",
                     "1 source retr(ies): clicks x1",
                     "retry clicks attempt 1 (backoff 40.0ms)",
                     "SOURCE LOST flaky after 5 attempt(s)",
                     "quarantine rate: 3 sample(s) (2.50% of ingested) "
                     "by reason: slot_count x3",
                     "QUARANTINED clicks:418 (slot_count)",
                     "stream seek -> {'clicks': 1024} (records 36, "
                     "dead letters 3)",
                     "1 missing file(s) skipped (on_missing_file=skip): "
                     "['part-00007.txt']",
                     "sample freshness: n=3",
                     "buffer depth now: 7",
                     # online-learning section
                     "== Online learning ==",
                     "publishes: 3 ok, 1 failed",
                     "delta rows shipped: 128 (4096 bytes on wire)",
                     "PUBLISH emb -> table version 42 (64 rows, 2048 "
                     "bytes, int8) in 5.2ms",
                     "PUBLISH FAILED seq 4: delta apply rejected: "
                     "chunk 0: crc32 mismatch",
                     "serving applies: 3 ok, 1 rejected",
                     "APPLY emb -> model_version 5 (table version 42) "
                     "in 1.3ms",
                     "APPLY REJECTED (old version keeps serving): "
                     "chunk 0: crc32 mismatch",
                     "publish wall: n=3",
                     "model staleness now: 2.5s",
                     # warm-start store section
                     "== Warm starts ==",
                     "restores: 2 (tier b: 2); misses: 4 (absent: 3, "
                     "corrupt: 1)",
                     "quarantined entries (.corrupt, checksum/parse "
                     "failures): 1",
                     "store size now: 12781 bytes",
                     "restore wall (would have been compile): n=2",
                     "tier A (serialized executables) DISABLED "
                     "[denylist]",
                     "WRITE 3a30af139ce5d56a kind=train_step "
                     "['tier_b.bin'] (5437 bytes)",
                     "QUARANTINE 89f712229c015fed -> .corrupt "
                     "(tier_b.bin checksum) -- fell through to a fresh "
                     "compile",
                     # alerts & post-mortem section
                     "== Alerts & post-mortems ==",
                     "SLO engine armed: 2 rule(s) [training-goodput, "
                     "serving-latency-p99], interval 5.0s, poller on",
                     "2 firing(s), 1 resolution(s); 1 still firing",
                     "FIRING [page] training-goodput [300s/60s]: observed "
                     "0.61 vs goodput_fraction >= 0.85 (burn 39.0)",
                     "resolved serving-latency-p99 [300s/60s]",
                     "alert firings counted: 2; active now: 1",
                     "1 post-mortem bundle(s):",
                     "BUNDLE [retries_exhausted] -> postmortems/"
                     "postmortem-20260806T000000Z-p1/bundle.json",
                     "triage with: python -m paddle_tpu_torch.tools.postmortem",
                     # goodput section (wall-clock ledger)
                     "== Goodput ==", "-> goodput",
                     "dispatch + fetch_sync", "lost compile",
                     "lost feed_wait", "lost elastic_restart",
                     # fleet section (cross-rank view)
                     "== Fleet ==", "1 collection(s) [gather]",
                     "rank 1 (h1): step 13.0ms", "STRAGGLER rank 1",
                     "1 elastic restart(s), 1.2s measured downtime",
                     # attribution & trajectory section
                     "== Attribution & trajectory ==",
                     "program 1:v0: 464.000 MB modeled/step",
                     "fusion 300.000 MB", "layout 64.000 MB",
                     "98% IR-attributed",
                     "1:v0 top ops: conv2d#12 90.000 MB",
                     "layout round-trip input -> momentum#163: "
                     "19.000 MB in 1 copy/transpose(s)  [PT060]",
                     "bench trajectory: 1 metric series over 2 round(s)",
                     # memory section (incl. the static-planner comparison)
                     "cpu:0", "512.000 MB", "peak 1.500 GB",
                     "static plan 1.800 GB", "(1.20x of XLA)",
                     # timeline section
                     "feed_prep", "dispatch",
                     "counter track 'device_memory_bytes'"):
            assert must in report, f"selftest: {must!r} missing from:\n{report}"
        # prometheus dump must also load + render
        prom_report = render_report(None, load_metrics(ppath))
        assert "executor_cache_hits_total" in prom_report
        # empty journal/trace render degrades, never raises
        assert "healthy" in render_health([])
        assert "quiet" in render_resilience([])
        assert "quiet" in render_checkpoint([])
        assert "idle" in render_serving([])
        assert "quiet" in render_ingestion([])
        assert "idle" in render_online([])
        assert "unfused" in render_megastep([])
        assert "(no trace events)" in render_timeline([])
        assert "no memory samples" in render_memory({"families": []})
        assert "no attribution samples" in \
            render_attribution([], {"families": []})
        assert "no goodput window" in render_goodput([], None)
        assert "single-rank" in render_fleet([])
        assert "no alert/postmortem events" in render_alerts([])
    print("obs_report selftest: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.obs_report",
        description="render paddle_tpu_torch run journal + metrics as a report")
    ap.add_argument("--journal", default=None,
                    help="JSONL journal path (default: $PADDLE_TPU_OBS_"
                         "JOURNAL / paddle_tpu_obs.jsonl when present)")
    ap.add_argument("--metrics", default=None,
                    help="metrics dump: bench --emit-metrics JSON or "
                         "Prometheus text (auto-detected)")
    ap.add_argument("--trace", default=None,
                    help="Chrome-trace JSON (bench --emit-trace / "
                         "observability.export_chrome_trace) to summarize "
                         "as a per-phase timeline section")
    ap.add_argument("--live", action="store_true",
                    help="render this process's in-memory registry")
    ap.add_argument("--goodput", action="store_true",
                    help="add the Goodput section: classify the run's "
                         "wall-clock into productive step time vs named "
                         "loss causes (compile, prefetch stalls, "
                         "checkpoint, retries, elastic restarts, ...)")
    ap.add_argument("--fleet", action="store_true",
                    help="add the Fleet section: per-rank step times, "
                         "skew, straggler verdicts and elastic-restart "
                         "downtime from a merged multi-rank journal")
    ap.add_argument("--bench", nargs="+", default=None, metavar="GLOB",
                    help="BENCH*_r*.json round files: the trajectory summary "
                         "waits for the port's benchmark (exits 2)")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if args.bench:
        print("error: --bench: the bench trajectory (tools/bench_compare.py) waits "
              "for the port's benchmark", file=sys.stderr)
        return 2

    from ..observability.journal import journal_path, read_journal
    events = snapshot = trace_events = None
    jpath = args.journal
    if jpath is None:
        jpath = journal_path() if os.path.exists(journal_path()) else None
    if jpath is not None:
        events = read_journal(jpath)
    if args.metrics:
        snapshot = load_metrics(args.metrics)
    elif args.live:
        from ..observability.export import to_dict
        snapshot = to_dict()
    if args.trace:
        trace_events = load_trace(args.trace)
    if events is None and snapshot is None and trace_events is None:
        ap.error("nothing to report: pass --journal, --metrics and/or "
                 "--trace (or --live), or run with PADDLE_TPU_OBS=1 first")
    print(render_report(events, snapshot, trace_events,
                        goodput=args.goodput, fleet=args.fleet))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
