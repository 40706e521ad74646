"""Declarative SLOs with multi-window multi-burn-rate alerting (the port's
copy of ``paddle_tpu/observability/slo.py``).

Rules are JSON (or dicts) stating an objective over an EXISTING metric
family in the process registry::

    {"format": "paddle_tpu_slo_rules_v1",
     "rules": [
       {"id": "goodput", "metric": "goodput_fraction",
        "objective": ">= 0.85", "severity": "page",
        "error_budget": 0.01,
        "windows": [{"long_s": 300, "short_s": 60, "burn": 14.4},
                    {"long_s": 3600, "short_s": 300, "burn": 6.0,
                     "severity": "ticket"}]},
       {"id": "serve-p99", "metric": "serving_request_seconds{tenant}",
        "objective": "p99 <= 25ms", "severity": "page",
        "windows": [{"long_s": 60, "short_s": 15, "burn": 2.0}]},
       {"id": "no-nonfinite", "metric": "tensor_nonfinite_total",
        "objective": "== 0", "severity": "page"}]}

- ``metric`` names a family; ``{label}`` fans the rule out per label
  value (one alert per tenant), ``{label="v"}`` filters to one series.
- ``objective`` is ``[agg] op threshold``: the aggregation defaults to
  the summed value for counters/gauges and is ``pNN``/``mean``/``count``
  for histograms (quantiles interpolated from the cumulative buckets);
  ``rate`` turns a counter into a per-second delta.  Thresholds accept
  duration suffixes (``25ms``, ``60s``, ``5m``).
- rules WITH ``windows`` alert multi-window multi-burn-rate style: the
  engine samples the objective each poll, computes the violating
  fraction of the error budget over each (long, short) window pair, and
  fires only when the burn rate exceeds the pair's factor in BOTH
  windows (fast windows catch cliffs, slow windows catch slow leaks;
  the short window also resolves quickly once the burn stops).  Rules
  WITHOUT windows are *instant*: any violating sample fires, the first
  clean sample resolves.

Arming: ``PADDLE_TPU_OBS_SLO=rules.json`` starts a daemon poller
(period ``PADDLE_TPU_OBS_SLO_INTERVAL``, default 5s) the first time an
Executor or PredictorPool is constructed; with the env unset
:func:`maybe_arm` is ONE ``os.environ`` read -- no thread, no file,
no registry walk (guard-tested).  ``arm(rules)`` is the API spelling.
A typo'd rule file raises :class:`SLOConfigError` (a ``ValueError``:
never silently degrade the enforcement the user asked for).

Firing goes through :class:`alerts.AlertManager`: journal ``alert``
events, ``alerts_total{rule,severity}``, the ``alerts_active`` gauge,
and the ``/alerts`` endpoint (:func:`alerts_doc`).
"""
from __future__ import annotations

import collections
import functools
import json
import os
import re
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from . import alerts as _alerts
from . import journal as _journal
from .metrics import REGISTRY, MetricsRegistry

SLO_ENV = "PADDLE_TPU_OBS_SLO"
INTERVAL_ENV = "PADDLE_TPU_OBS_SLO_INTERVAL"
DEFAULT_INTERVAL = 5.0
DEFAULT_BUDGET = 0.01          # 1% of samples may violate before burn=1
DEFAULT_SEVERITY = "page"
#: per-(rule, group) sample retention (also time-trimmed to the longest
#: window, so memory stays bounded however long the run)
SERIES_CAP = 4096

OPS = ("<=", ">=", "==", "!=", "<", ">")
_OP_FNS = {"<=": lambda a, b: a <= b, "<": lambda a, b: a < b,
           ">=": lambda a, b: a >= b, ">": lambda a, b: a > b,
           "==": lambda a, b: a == b, "!=": lambda a, b: a != b}

_DUR = {"us": 1e-6, "ms": 1e-3, "s": 1.0, "m": 60.0, "h": 3600.0}

_METRIC_RE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)(?:\{(.*)\})?$")
_AGG_RE = re.compile(r"^(value|sum|mean|count|rate|p(\d{1,2}(?:\.\d+)?))$")


class SLOConfigError(ValueError):
    """A rule file/dict that does not match the schema."""


# ------------------------------------------------------------- rule model --

class Window:
    """One burn-rate window pair (long catches leaks, short gates+resolves)."""

    def __init__(self, long_s: float, short_s: float, burn: float,
                 severity: Optional[str] = None, name: Optional[str] = None):
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.burn = float(burn)
        self.severity = severity
        self.name = name or f"{int(self.long_s)}s/{int(self.short_s)}s"

    def to_dict(self) -> dict:
        return {"name": self.name, "long_s": self.long_s,
                "short_s": self.short_s, "burn": self.burn,
                "severity": self.severity}


class Rule:
    """One parsed SLO rule."""

    def __init__(self, id: str, metric: str, op: str, threshold: float,
                 agg: str = "value", group_by: Sequence[str] = (),
                 filters: Optional[Dict[str, str]] = None,
                 severity: str = DEFAULT_SEVERITY,
                 error_budget: float = DEFAULT_BUDGET,
                 windows: Sequence[Window] = ()):
        self.id = id
        self.metric = metric
        self.op = op
        self.threshold = float(threshold)
        self.agg = agg
        self.group_by = tuple(group_by)
        self.filters = dict(filters or {})
        self.severity = severity
        self.error_budget = float(error_budget)
        self.windows = list(windows)

    @property
    def objective(self) -> str:
        agg = "" if self.agg in ("value", "sum") else self.agg + " "
        return f"{agg}{self.op} {self.threshold:g}"

    def satisfied(self, value: float) -> bool:
        return bool(_OP_FNS[self.op](value, self.threshold))

    def to_dict(self) -> dict:
        return {"id": self.id, "metric": self.metric, "agg": self.agg,
                "op": self.op, "threshold": self.threshold,
                "group_by": list(self.group_by), "filters": dict(self.filters),
                "severity": self.severity, "error_budget": self.error_budget,
                "windows": [w.to_dict() for w in self.windows]}


def parse_threshold(raw) -> float:
    """A number, or a string with an optional duration suffix (25ms)."""
    if isinstance(raw, (int, float)) and not isinstance(raw, bool):
        return float(raw)
    if isinstance(raw, str):
        s = raw.strip().lower()
        for suf in sorted(_DUR, key=len, reverse=True):
            if s.endswith(suf):
                try:
                    return float(s[:-len(suf)]) * _DUR[suf]
                except ValueError:
                    break
        try:
            return float(s)
        except ValueError:
            pass
    raise SLOConfigError(f"threshold {raw!r} is not a number or duration")


def parse_metric_spec(spec: str) -> Tuple[str, List[str], Dict[str, str]]:
    """``name`` / ``name{tenant}`` / ``name{tenant="a",site}`` ->
    (family, group-by labels, filter labels)."""
    m = _METRIC_RE.match(spec.strip())
    if not m:
        raise SLOConfigError(f"metric spec {spec!r} is not "
                             f"name or name{{label,...}}")
    name, inner = m.group(1), m.group(2)
    group_by, filters = [], {}
    if inner:
        for part in inner.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                k, v = part.split("=", 1)
                filters[k.strip()] = v.strip().strip('"').strip("'")
            else:
                group_by.append(part)
    return name, group_by, filters


def parse_objective(spec: str) -> Tuple[Optional[str], str, float]:
    """``[agg] op threshold`` -> (agg or None, op, threshold)."""
    s = spec.strip()
    agg = None
    head = s.split(None, 1)
    if head and _AGG_RE.match(head[0]):
        agg = head[0]
        s = head[1] if len(head) > 1 else ""
    for op in OPS:                     # "<=" before "<": ordered by length
        if s.startswith(op):
            return agg, op, parse_threshold(s[len(op):])
    raise SLOConfigError(f"objective {spec!r} must be '[agg] op threshold' "
                         f"with op in {OPS}")


def _rule_problems(doc: dict, idx: int,
                   known: Optional[Sequence[str]] = None) -> List[str]:
    """Schema problems for one rule dict (empty list = clean)."""
    where = f"rules[{idx}]"
    probs: List[str] = []
    if not isinstance(doc, dict):
        return [f"{where}: not an object"]
    rid = doc.get("id")
    if not rid or not isinstance(rid, str):
        probs.append(f"{where}: missing string 'id'")
    else:
        where = f"rule {rid!r}"
    unknown = set(doc) - {"id", "metric", "objective", "agg", "severity",
                          "error_budget", "windows", "labels"}
    if unknown:
        probs.append(f"{where}: unknown keys {sorted(unknown)}")
    try:
        name, _g, _f = parse_metric_spec(str(doc.get("metric", "")))
        if known is not None and name not in known:
            probs.append(f"{where}: metric family {name!r} is not "
                         f"registered anywhere in paddle_tpu_torch "
                         f"(typo? see slo.known_metric_families())")
    except SLOConfigError as e:
        probs.append(f"{where}: {e}")
    try:
        if "objective" in doc:
            parse_objective(str(doc["objective"]))
        else:
            probs.append(f"{where}: missing 'objective'")
    except SLOConfigError as e:
        probs.append(f"{where}: {e}")
    budget = doc.get("error_budget", DEFAULT_BUDGET)
    if not isinstance(budget, (int, float)) or isinstance(budget, bool) \
            or not 0.0 < float(budget) <= 1.0:
        probs.append(f"{where}: error_budget must be in (0, 1]")
    wins = doc.get("windows", [])
    if not isinstance(wins, list):
        probs.append(f"{where}: windows must be a list")
        wins = []
    for j, w in enumerate(wins):
        pre = f"{where}.windows[{j}]"
        if not isinstance(w, dict):
            probs.append(f"{pre}: not an object")
            continue
        bad = set(w) - {"long_s", "short_s", "burn", "severity", "name"}
        if bad:
            probs.append(f"{pre}: unknown keys {sorted(bad)}")
        for k in ("long_s", "short_s", "burn"):
            v = w.get(k)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or float(v) <= 0:
                probs.append(f"{pre}: {k} must be a positive number")
        if all(isinstance(w.get(k), (int, float)) and
               not isinstance(w.get(k), bool)
               for k in ("long_s", "short_s")) \
                and float(w.get("short_s", 0)) >= float(w.get("long_s", 1)):
            probs.append(f"{pre}: short_s must be < long_s")
    return probs


def validate_rules(doc, known: Optional[Sequence[str]] = None) -> List[str]:
    """Every schema problem in a rules document (empty list = valid).
    ``known``, when given, also cross-checks metric family names."""
    if not isinstance(doc, dict):
        return ["rules document is not a JSON object"]
    probs: List[str] = []
    fmt = doc.get("format")
    if fmt not in (None, "paddle_tpu_slo_rules_v1"):
        probs.append(f"unknown format {fmt!r} "
                     f"(expected paddle_tpu_slo_rules_v1)")
    rules = doc.get("rules")
    if not isinstance(rules, list) or not rules:
        return probs + ["'rules' must be a non-empty list"]
    seen = set()
    for i, r in enumerate(rules):
        probs.extend(_rule_problems(r, i, known=known))
        rid = isinstance(r, dict) and r.get("id")
        if rid in seen:
            probs.append(f"duplicate rule id {rid!r}")
        seen.add(rid)
    return probs


def parse_rules(doc) -> List[Rule]:
    """Parse a rules document (dict, or a list of rule dicts) into
    :class:`Rule` objects; raises :class:`SLOConfigError` listing every
    schema problem at once."""
    if isinstance(doc, list):
        doc = {"rules": doc}
    probs = validate_rules(doc)
    if probs:
        raise SLOConfigError("invalid SLO rules: " + "; ".join(probs))
    out = []
    for r in doc["rules"]:
        name, group_by, filters = parse_metric_spec(r["metric"])
        labels = r.get("labels") or {}
        for k, v in labels.items():   # dict spelling of {label}/{label="v"}
            if v in ("*", None):
                group_by.append(k)
            else:
                filters[k] = str(v)
        agg, op, threshold = parse_objective(str(r["objective"]))
        agg = r.get("agg", agg) or "value"
        sev = r.get("severity", DEFAULT_SEVERITY)
        wins = [Window(w["long_s"], w["short_s"], w["burn"],
                       severity=w.get("severity"), name=w.get("name"))
                for w in r.get("windows", [])]
        out.append(Rule(id=r["id"], metric=name, op=op, threshold=threshold,
                        agg=agg, group_by=group_by, filters=filters,
                        severity=sev,
                        error_budget=r.get("error_budget", DEFAULT_BUDGET),
                        windows=wins))
    return out


def load_rules(path: str) -> List[Rule]:
    """Parse a rules JSON file; bad path or schema raises SLOConfigError."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise SLOConfigError(f"cannot read SLO rules {path!r}: {e}")
    except ValueError as e:
        raise SLOConfigError(f"SLO rules {path!r} is not JSON: {e}")
    return parse_rules(doc)


@functools.lru_cache(maxsize=1)
def known_metric_families() -> Tuple[str, ...]:
    """Every metric family name registered anywhere in the package, found by
    scanning its source for ``.counter("name"`` / ``.gauge(`` /
    ``.histogram(`` registrations. For rule validation only -- never on a
    hot path."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pat = re.compile(
        r"\.(?:counter|gauge|histogram)\(\s*\n?\s*['\"]([a-z0-9_]+)['\"]")
    names = set()
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            try:
                with open(os.path.join(dirpath, fn)) as f:
                    names.update(pat.findall(f.read()))
            except OSError:
                continue
    return tuple(sorted(names))


# -------------------------------------------------- derived-metric refresh --

def register_refresher(fn) -> None:
    """Register a zero-arg callable refreshed before every evaluation and
    ``/metrics`` scrape (the server's list: one list for both)."""
    from . import server as _server
    _server.register_refresher(fn)


def run_refreshers() -> None:
    from . import server as _server
    _server.run_refreshers()


_warned = set()


def _warn_once(key, msg: str):
    if key in _warned:
        return
    _warned.add(key)
    warnings.warn(f"paddle_tpu_torch slo: {msg}")


# ------------------------------------------------------------------ engine --

def _hist_quantile(q: float, cum_pairs) -> Optional[float]:
    """Linear interpolation over cumulative ``[(le, count), ...]`` bucket
    pairs (the Prometheus ``histogram_quantile`` estimate); None when
    the histogram is empty."""
    total = cum_pairs[-1][1] if cum_pairs else 0
    if total <= 0:
        return None
    rank = q * total
    prev_edge, prev_cum = 0.0, 0
    for edge, cum in cum_pairs:
        if cum >= rank:
            if edge == float("inf"):
                return prev_edge if prev_edge > 0 else float("inf")
            width = edge - prev_edge
            frac = ((rank - prev_cum) / (cum - prev_cum)
                    if cum > prev_cum else 1.0)
            return prev_edge + width * frac
        prev_edge, prev_cum = edge, cum
    return prev_edge


class SLOEngine:
    """Evaluate parsed rules against registry snapshots; fire alerts.

    ``now_fn`` is the clock seam: the poller uses ``time.monotonic``,
    tests drive :meth:`evaluate` with explicit fake times.
    """

    def __init__(self, rules: Sequence[Rule],
                 registry: Optional[MetricsRegistry] = None,
                 now_fn=None,
                 manager: Optional[_alerts.AlertManager] = None):
        self.rules = list(rules)
        self.registry = registry or REGISTRY
        self._now = now_fn or time.monotonic
        self.alerts = manager or _alerts.AlertManager(registry=self.registry)
        # (rule id, labels key) -> deque[(t, violating, observed)]
        self._series: Dict[Tuple, "collections.deque"] = {}
        # (rule id, labels key) -> (t, raw) for agg == "rate"
        self._last_raw: Dict[Tuple, Tuple[float, float]] = {}
        # rule id -> last evaluation summary (for /alerts)
        self._state: Dict[str, dict] = {}
        self._lock = threading.Lock()

    # ---- value extraction ------------------------------------------------

    def _group_values(self, rule: Rule, now: float) -> Dict[Tuple, float]:
        """labels-key -> aggregated objective value (missing groups and
        empty histograms simply don't appear: no data never false-fires)."""
        fam = self.registry.get(rule.metric)
        if fam is None:
            return {}
        groups: Dict[Tuple, list] = {}
        for key, child in fam.items():
            kd = dict(key)
            if any(kd.get(k) != v for k, v in rule.filters.items()):
                continue
            gk = tuple((g, kd.get(g, "")) for g in rule.group_by)
            groups.setdefault(gk, []).append(child)
        out: Dict[Tuple, float] = {}
        for gk, children in groups.items():
            if fam.kind == "histogram":
                count = csum = 0.0
                cum = None   # merged [(le, cumulative count), ...]
                for c in children:
                    n, s, cb = c.snapshot()
                    count += n
                    csum += s
                    cum = (list(cb) if cum is None
                           else [(e, a + b) for (e, a), (_e, b)
                                 in zip(cum, cb)])
                if count <= 0:
                    continue
                if rule.agg == "count":
                    out[gk] = count
                elif rule.agg == "mean":
                    out[gk] = csum / count
                else:
                    m = re.match(r"^p(\d{1,2}(?:\.\d+)?)$", rule.agg)
                    q = float(m.group(1)) / 100.0 if m else 0.99
                    v = _hist_quantile(q, cum)
                    if v is None:
                        continue
                    out[gk] = v
            else:
                raw = float(sum(c.value for c in children))
                if rule.agg == "rate":
                    prev = self._last_raw.get((rule.id, gk))
                    self._last_raw[(rule.id, gk)] = (now, raw)
                    if prev is None or now <= prev[0]:
                        continue        # first sample: no rate yet
                    out[gk] = (raw - prev[1]) / (now - prev[0])
                else:
                    out[gk] = raw
        return out

    # ---- burn-rate machinery --------------------------------------------

    def _burn(self, series, now: float, window_s: float) -> Optional[float]:
        """Burn rate (violating fraction / budget placeholder of 1.0) over
        the trailing window; None when the window holds no samples."""
        pts = [(t, bad) for (t, bad, _v) in series if t >= now - window_s]
        if not pts:
            return None
        return sum(1.0 for _t, bad in pts if bad) / len(pts)

    def _eval_rule(self, rule: Rule, now: float) -> dict:
        values = self._group_values(rule, now)
        state = {"rule": rule.id, "metric": rule.metric,
                 "objective": rule.objective, "groups": {}}
        for gk, value in values.items():
            labels = dict(gk)
            violating = not rule.satisfied(value)
            key = (rule.id, gk)
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = collections.deque(
                    maxlen=SERIES_CAP)
            series.append((now, violating, value))
            horizon = max([w.long_s for w in rule.windows] or [0.0])
            while series and series[0][0] < now - horizon - 1e-9:
                series.popleft()
            gstate = {"observed": value, "violating": violating,
                      "windows": {}}
            if not rule.windows:                       # instant rule
                if violating:
                    self.alerts.fire(rule.id, rule.severity, _alerts.INSTANT,
                                     labels, value, rule.objective, now)
                else:
                    self.alerts.resolve(rule.id, _alerts.INSTANT, labels,
                                        value, now)
            else:
                span = now - series[0][0]
                for w in rule.windows:
                    frac_long = self._burn(series, now, w.long_s)
                    frac_short = self._burn(series, now, w.short_s)
                    burn_long = (None if frac_long is None
                                 else frac_long / rule.error_budget)
                    burn_short = (None if frac_short is None
                                  else frac_short / rule.error_budget)
                    gstate["windows"][w.name] = {
                        "burn_long": burn_long, "burn_short": burn_short,
                        "threshold": w.burn}
                    # fire only once the series actually covers the short
                    # window -- a single violating sample must not page
                    if (span >= w.short_s
                            and burn_long is not None
                            and burn_short is not None
                            and burn_long >= w.burn
                            and burn_short >= w.burn):
                        self.alerts.fire(
                            rule.id, w.severity or rule.severity, w.name,
                            labels, value, rule.objective, now,
                            burn=round(min(burn_long, burn_short), 3))
                    elif burn_short is not None and burn_short < w.burn:
                        # the short window going quiet resolves quickly
                        self.alerts.resolve(rule.id, w.name, labels,
                                            value, now)
            state["groups"][json.dumps(labels, sort_keys=True)] = gstate
        state["no_data"] = not values
        return state

    def evaluate(self, now: Optional[float] = None) -> List[_alerts.Alert]:
        """One evaluation pass: refresh derived gauges, walk every rule,
        fire/resolve, return the active alerts."""
        now = self._now() if now is None else now
        run_refreshers()
        with self._lock:
            for rule in self.rules:
                try:
                    self._state[rule.id] = self._eval_rule(rule, now)
                except Exception as e:   # one bad rule must not stop the rest
                    _warn_once(("rule", rule.id),
                               f"rule {rule.id!r} evaluation failed: {e}")
        self.alerts.export_gauge()
        return self.alerts.active()

    def to_doc(self) -> dict:
        with self._lock:
            state = {k: dict(v) for k, v in self._state.items()}
        doc = {"rules": [r.to_dict() for r in self.rules],
               "evaluations": state}
        doc.update(self.alerts.to_doc())
        return doc


class SLOPoller:
    """Daemon thread calling ``engine.evaluate()`` every ``interval_s``."""

    def __init__(self, engine: SLOEngine, interval_s: float = DEFAULT_INTERVAL):
        self.engine = engine
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="paddle-tpu-torch-slo", daemon=True)

    def start(self):
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.engine.evaluate()
            except Exception as e:   # poller must outlive a bad snapshot
                _warn_once("poller", f"SLO evaluation failed: {e}")

    def stop(self, timeout: float = 5.0):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)


# ------------------------------------------------------------------ arming --

#: the armed engine, or None.  Hot paths read exactly this attribute.
ENGINE: Optional[SLOEngine] = None
POLLER: Optional[SLOPoller] = None

_arm_lock = threading.Lock()


def _interval_from_env() -> float:
    raw = os.environ.get(INTERVAL_ENV)
    if raw is None or not raw.strip():
        return DEFAULT_INTERVAL
    try:
        v = float(raw)
    except ValueError:
        raise SLOConfigError(f"{INTERVAL_ENV}={raw!r} is not a number")
    if v <= 0:
        raise SLOConfigError(f"{INTERVAL_ENV}={raw!r} must be > 0")
    return v


def arm(rules, interval_s: Optional[float] = None,
        start_poller: bool = True) -> SLOEngine:
    """Arm the process-wide engine (idempotent: an armed engine wins).
    ``rules``: a path, a rules document, or a list of :class:`Rule`."""
    global ENGINE, POLLER
    with _arm_lock:
        if ENGINE is not None:
            return ENGINE
        if isinstance(rules, str):
            parsed = load_rules(rules)
        elif rules and isinstance(rules, (list, tuple)) \
                and isinstance(rules[0], Rule):
            parsed = list(rules)
        else:
            parsed = parse_rules(rules)
        interval = (_interval_from_env() if interval_s is None
                    else float(interval_s))
        engine = SLOEngine(parsed)
        ENGINE = engine
        if start_poller:
            POLLER = SLOPoller(engine, interval)
            POLLER.start()
    _journal.emit({"event": "slo_armed",
                   "rules": [r.id for r in parsed],
                   "interval_s": interval,
                   "poller": bool(start_poller)})
    return engine


def maybe_arm() -> Optional[SLOEngine]:
    """Construction hook (Executor / PredictorPool): with
    ``PADDLE_TPU_OBS_SLO`` unset this is ONE env read and returns None --
    no thread, no file, no registry walk."""
    raw = os.environ.get(SLO_ENV)
    if raw is None:
        return None
    if ENGINE is not None:
        return ENGINE
    raw = raw.strip()
    if raw.lower() in _journal.FALSY:
        return None
    return arm(raw)


def disarm():
    """Tear the engine/poller down (tests)."""
    global ENGINE, POLLER
    with _arm_lock:
        engine, ENGINE = ENGINE, None
        poller, POLLER = POLLER, None
    if poller is not None:
        poller.stop()
    if engine is not None:
        engine.alerts.clear()


def alerts_doc() -> dict:
    """The ``/alerts`` document; degrades to a disarmed stub."""
    engine = ENGINE
    if engine is None:
        return {"armed": False, "rules": [], "evaluations": {},
                "active": [], "recent_resolved": []}
    doc = {"armed": True}
    doc.update(engine.to_doc())
    return doc
