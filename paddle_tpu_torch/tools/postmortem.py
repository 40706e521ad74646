"""Post-mortem bundle triage: turn a black-box bundle into a diagnosis (the
port's copy of the JAX package's ``tools/postmortem.py``).

    python -m paddle_tpu_torch.tools.postmortem postmortems/postmortem-<ts>/
    python -m paddle_tpu_torch.tools.postmortem bundle.json --format json
    python -m paddle_tpu_torch.tools.postmortem BUNDLE --last 30   # window (s)
    python -m paddle_tpu_torch.tools.postmortem --selftest

Reads one ``bundle.json`` in the ``paddle_tpu_postmortem_v1`` format, which
:mod:`paddle_tpu_torch.observability.blackbox` writes as the JAX package's
black box does, and reports, from the bundle alone (no live process
needed):

- **probable causes**, ranked: each typed journal event class the
  resilience/serving/health layers emit (``tensor_nonfinite``, ``retry``,
  ``step_timeout``, ``fault``, ``serve_worker_crash``,
  ``serve_drain_timeout``, ``preempt``, ...) scores evidence toward a
  named cause, seeded by the bundle's trigger ``reason``;
- **rule violations**: the SLO alerts active at the time of death;
- **timeline**: the journal tail inside the last N seconds before the
  bundle, plus the newest recorded flight-recorder spans.

Exit 0 = triaged, 2 = unreadable bundle.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

#: the bundle format both packages write
FORMAT = "paddle_tpu_postmortem_v1"
DEFAULT_LAST_S = 30.0


# ------------------------------------------------------------------ loading --

def load_bundle(path: str) -> dict:
    """A bundle dict from a bundle.json path or its directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "bundle.json")
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != FORMAT:
        raise ValueError(f"{path!r} is not a {FORMAT} bundle "
                         f"(format={doc.get('format')!r})")
    return doc


# ------------------------------------------------------------------- causes --

def _events(bundle: dict, kind: str) -> List[dict]:
    return [e for e in bundle.get("journal") or []
            if e.get("event") == kind]


def probable_causes(bundle: dict) -> List[dict]:
    """Ranked ``{"cause", "score", "evidence": [...]}`` -- the trigger
    reason seeds its matching cause, typed journal events corroborate."""
    reason = bundle.get("reason", "")
    err = bundle.get("error") or {}
    causes: List[dict] = []

    def add(cause: str, score: float, evidence: List[str]):
        causes.append({"cause": cause, "score": round(score, 2),
                       "evidence": evidence[:6]})

    # injected faults are the strongest signal there is: the harness SAID
    # it was going to break this exact thing
    faults = _events(bundle, "fault")
    if faults:
        kinds = sorted({f"{e.get('kind')}@{e.get('site')}" for e in faults})
        add("injected fault(s) " + ", ".join(kinds),
            4.0 + 0.1 * len(faults),
            [f"{len(faults)} fault event(s): {kinds}"])

    nonfinite = _events(bundle, "tensor_nonfinite")
    if nonfinite or reason == "nonfinite":
        names = sorted({str(v) for e in nonfinite
                        for v in (e.get("vars") or [])})[:8]
        add("nonfinite tensors (NaN/Inf) in the training step",
            (3.0 if reason == "nonfinite" else 1.5) + 0.2 * len(nonfinite),
            [f"{len(nonfinite)} tensor_nonfinite event(s)"]
            + ([f"offending vars: {names}"] if names else [])
            + ([f"terminal error: {err.get('message', '')[:120]}"]
               if reason == "nonfinite" else []))

    retries = _events(bundle, "retry")
    if retries or reason == "retries_exhausted":
        sites: dict = {}
        for e in retries:
            sites[e.get("site", "?")] = sites.get(e.get("site", "?"), 0) + 1
        top = sorted(sites.items(), key=lambda kv: -kv[1])
        where = top[0][0] if top else "unknown site"
        add(f"transient {where} errors exhausted the retry budget",
            (3.0 if reason == "retries_exhausted" else 1.0)
            + 0.2 * len(retries),
            [f"{len(retries)} retry event(s) by site: {dict(top)}"]
            + ([f"last error: {retries[-1].get('error', '')[:120]}"]
               if retries else []))

    timeouts = _events(bundle, "step_timeout")
    if timeouts or reason == "step_timeout":
        dl = (timeouts[-1].get("deadline_s")
              if timeouts else (bundle.get("extra") or {}).get("deadline_s"))
        add("hung step: dispatch/d2h sync exceeded the deadline "
            "(wedged device or deadlocked collective)",
            3.0 if reason == "step_timeout" else 1.5,
            [f"step_timeout event(s): {len(timeouts)}, "
             f"deadline {dl}s"])

    preempts = _events(bundle, "preempt")
    if preempts or reason == "preemption":
        saved = (preempts[-1].get("saved_step") if preempts
                 else (bundle.get("extra") or {}).get("saved_step"))
        add("external preemption (SIGTERM/SIGINT) -- not a code failure",
            3.0 if reason == "preemption" else 1.0,
            [f"emergency checkpoint at step {saved}"])

    crashes = _events(bundle, "serve_worker_crash")
    storm = _events(bundle, "serve_respawn_storm")
    if storm or (crashes and (len(crashes) >= 3
                              or reason == "respawn_storm")):
        errs = sorted({e.get("error", "")[:80] for e in crashes})[:3]
        add("serving worker respawn storm (workers crash faster than "
            "they recover)",
            (3.0 if reason == "respawn_storm" else 1.2)
            + 0.2 * len(crashes),
            [f"{len(crashes)} serve_worker_crash event(s)"]
            + [f"crash error(s): {errs}"])

    drains = _events(bundle, "serve_drain_timeout")
    if drains or reason == "serve_drain_timeout":
        ev = drains[-1] if drains else (bundle.get("extra") or {})
        add("wedged serving worker: close() drain deadline expired with "
            "requests still held",
            3.0 if reason == "serve_drain_timeout" else 1.5,
            [f"failed in-flight: {ev.get('failed_in_flight')}, "
             f"queued: {ev.get('failed_queued')}, "
             f"waited {ev.get('waited_s')}s"]
            + ([f"{len(crashes)} worker crash(es) preceding"]
               if crashes else []))

    if reason == "terminal_error" and err:
        add(f"non-transient {err.get('type', 'error')}: "
            f"{err.get('message', '')[:120]}", 3.0,
            ["the guardian classified this error as not retryable"])

    alerts = (bundle.get("alerts") or {}).get("active") or []
    if alerts:
        rules = sorted({a.get("rule", "?") for a in alerts})
        add("SLO violation(s) active at time of death: "
            + ", ".join(rules), 0.8 + 0.2 * len(alerts),
            [f"{a.get('rule')}[{a.get('window')}]: observed "
             f"{a.get('observed')} vs {a.get('objective')}"
             for a in alerts])

    if not causes:
        add("no typed evidence in the bundle "
            "(journal ring empty or failure predates the ring)", 0.1,
            [f"trigger reason: {reason!r}"])
    return sorted(causes, key=lambda c: -c["score"])


# ------------------------------------------------------------------- report --

def triage(bundle: dict, last_s: float = DEFAULT_LAST_S) -> dict:
    ts = float(bundle.get("ts") or 0.0)
    tail = [e for e in bundle.get("journal") or []
            if float(e.get("ts") or 0.0) >= ts - last_s]
    spans = (bundle.get("timeline") or {}).get("spans") or []
    alerts_doc = bundle.get("alerts") or {}
    return {
        "reason": bundle.get("reason"),
        "error": bundle.get("error"),
        "ts": ts,
        "pid": bundle.get("pid"),
        "rank": bundle.get("rank"),
        "probable_causes": probable_causes(bundle),
        "active_alerts": alerts_doc.get("active") or [],
        "recent_resolved_alerts": alerts_doc.get("recent_resolved") or [],
        "journal_tail": tail,
        "span_tail": spans[-20:],
        "executors": bundle.get("executors") or [],
    }


def render(report: dict, last_s: float = DEFAULT_LAST_S) -> str:
    L: List[str] = []
    L.append("== post-mortem triage ==")
    L.append(f"trigger : {report['reason']}")
    if report.get("error"):
        e = report["error"]
        L.append(f"error   : {e.get('type')}: {e.get('message')}")
    if report.get("rank") is not None:
        L.append(f"rank    : {report['rank']}")
    L.append("")
    L.append("-- probable causes (ranked) --")
    for i, c in enumerate(report["probable_causes"], 1):
        L.append(f"{i}. [{c['score']:>5.2f}] {c['cause']}")
        for ev in c["evidence"]:
            L.append(f"     - {ev}")
    L.append("")
    L.append("-- rule violations at time of death --")
    if report["active_alerts"]:
        for a in report["active_alerts"]:
            lbl = ",".join(f"{k}={v}"
                           for k, v in sorted((a.get("labels")
                                               or {}).items()))
            L.append(f"  FIRING {a.get('rule')}"
                     + (f"{{{lbl}}}" if lbl else "")
                     + f" [{a.get('window')}] observed "
                       f"{a.get('observed')} vs {a.get('objective')}"
                     + (f" (burn {a.get('burn')})"
                        if a.get("burn") is not None else ""))
    else:
        L.append("  (none)")
    L.append("")
    L.append(f"-- journal: last {last_s:g}s before the bundle "
             f"({len(report['journal_tail'])} events) --")
    for e in report["journal_tail"][-40:]:
        dt = float(e.get("ts") or 0.0) - report["ts"]
        rest = {k: v for k, v in e.items()
                if k not in ("event", "ts", "pid")}
        L.append(f"  {dt:+8.2f}s {e.get('event', '?'):<22} "
                 + json.dumps(rest, sort_keys=True, default=str)[:120])
    if not report["journal_tail"]:
        L.append("  (empty)")
    if report["span_tail"]:
        L.append("")
        L.append("-- newest flight-recorder spans --")
        for s in report["span_tail"][-12:]:
            L.append(f"  {s.get('name', '?'):<16} "
                     f"{float(s.get('dur') or 0) * 1e3:9.3f} ms  "
                     f"{json.dumps(s.get('args') or {}, default=str)[:80]}")
    return "\n".join(L) + "\n"


# ----------------------------------------------------------------- selftest --

def _synthetic_bundle() -> dict:
    """A hand-built bundle whose true root cause is an injected dispatch
    fault exhausting the retry budget while a goodput alert fired."""
    t = 1000.0
    return {
        "format": FORMAT, "reason": "retries_exhausted", "ts": t + 10,
        "pid": 1,
        "error": {"type": "TransientFault",
                  "message": "injected exc@dispatch"},
        "extra": {"step": 12, "attempt": 2},
        "journal": [
            {"event": "run", "ts": t + 1, "step": 10},
            {"event": "fault", "kind": "exc", "site": "dispatch",
             "ts": t + 4},
            {"event": "retry", "site": "dispatch", "step": 12,
             "attempt": 1, "error": "injected exc@dispatch", "ts": t + 5},
            {"event": "fault", "kind": "exc", "site": "dispatch",
             "ts": t + 6},
            {"event": "retry", "site": "dispatch", "step": 12,
             "attempt": 2, "error": "injected exc@dispatch", "ts": t + 7},
            {"event": "alert", "state": "firing", "rule": "goodput",
             "window": "300s/60s", "ts": t + 8},
        ],
        "timeline": {"spans": [
            {"name": "dispatch", "cat": "step", "t0": 5.0, "dur": 0.01,
             "args": {"step": 12}, "tid": 1}], "counters": {}},
        "metrics": {"format": "paddle_tpu_obs_metrics_v1", "families": []},
        "alerts": {"armed": True, "active": [
            {"rule": "goodput", "severity": "page", "window": "300s/60s",
             "labels": {}, "observed": 0.4, "objective": ">= 0.85",
             "burn": 60.0, "state": "firing", "t_fired": 9.0}],
            "recent_resolved": []},
        "executors": [{"cached_steps": 1, "programs": []}],
        "attribution": [],
    }


def selftest() -> int:
    b = _synthetic_bundle()
    causes = probable_causes(b)
    assert causes, "no causes ranked"
    # the injected fault outranks everything; the retry exhaustion is next
    assert causes[0]["cause"].startswith("injected fault"), causes[0]
    assert "exc@dispatch" in causes[0]["cause"], causes[0]
    assert any("dispatch" in c["cause"] and "retry" in c["cause"]
               for c in causes[1:]), causes
    rep = triage(b, last_s=30.0)
    assert len(rep["journal_tail"]) == 6
    assert rep["active_alerts"][0]["rule"] == "goodput"
    txt = render(rep)
    assert "probable causes" in txt and "exc@dispatch" in txt
    assert "FIRING goodput" in txt and "300s/60s" in txt
    # narrower window trims the tail
    rep5 = triage(b, last_s=4.0)
    assert len(rep5["journal_tail"]) == 3, rep5["journal_tail"]
    # empty bundle degrades to the no-evidence cause
    empty = {"format": FORMAT, "reason": "terminal_error", "ts": 0.0,
             "journal": [], "alerts": {}}
    ec = probable_causes(empty)
    assert ec and ec[0]["score"] <= 0.2, ec
    assert render(triage(empty)).strip()
    # json round-trip: the whole report is JSON-able
    json.dumps(triage(b), default=str)
    print("postmortem selftest: OK")
    return 0


# --------------------------------------------------------------------- main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.tools.postmortem",
        description="triage a paddle_tpu_torch post-mortem bundle")
    ap.add_argument("bundle", nargs="?",
                    help="bundle.json or its postmortem-<ts>/ directory")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--last", type=float, default=DEFAULT_LAST_S,
                    metavar="S", help="timeline window in seconds "
                                      f"(default {DEFAULT_LAST_S:g})")
    ap.add_argument("--selftest", action="store_true")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.bundle:
        ap.print_usage(sys.stderr)
        return 2
    try:
        bundle = load_bundle(args.bundle)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = triage(bundle, last_s=args.last)
    if args.format == "json":
        print(json.dumps(report, indent=2, sort_keys=True, default=str))
    else:
        sys.stdout.write(render(report, last_s=args.last))
    return 0


if __name__ == "__main__":
    sys.exit(main())
