"""Registry export: JSON dump + Prometheus text exposition (and a parser)
(the port's copy of ``paddle_tpu/observability/export.py``).

The JSON form is a snapshot of every metric family; the Prometheus text
form is the standard scrape surface (text exposition format 0.0.4), which
``server.py`` serves at ``/metrics``. ``parse_prometheus`` inverts the
sample lines so tests can prove the round-trip. The JSON format tag is the
JAX package's, so either package's dumps read the same.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry


def to_dict(registry: Optional[MetricsRegistry] = None) -> dict:
    """Structured snapshot of every family/child in ``registry``."""
    registry = registry or REGISTRY
    fams = []
    for fam in registry.collect():
        samples = []
        for key, child in fam.items():
            labels = dict(key)
            if fam.kind == "histogram":
                n, total, buckets = child.snapshot()
                samples.append({
                    "labels": labels,
                    "count": n,
                    "sum": total,
                    "buckets": [[le, c] for le, c in buckets],
                })
            else:
                samples.append({"labels": labels, "value": child.value})
        fams.append({"name": fam.name, "type": fam.kind, "help": fam.help,
                     "samples": samples})
    return {"format": "paddle_tpu_obs_metrics_v1", "families": fams}


def to_json(registry: Optional[MetricsRegistry] = None, indent: int = 2) -> str:
    def _num(x):  # inf is not valid JSON; spell it as a string
        return "+Inf" if x == math.inf else x

    d = to_dict(registry)
    for fam in d["families"]:
        for s in fam["samples"]:
            if "buckets" in s:
                s["buckets"] = [[_num(le), n] for le, n in s["buckets"]]
    return json.dumps(d, indent=indent, sort_keys=True)


def dump_json(path: str, registry: Optional[MetricsRegistry] = None):
    with open(path, "w") as f:
        f.write(to_json(registry))
        f.write("\n")
    return path


def _esc(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_le(le: float) -> str:
    return "+Inf" if le == math.inf else repr(float(le))


def to_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition format 0.0.4."""
    registry = registry or REGISTRY
    lines = []
    for fam in registry.collect():
        if fam.help:
            lines.append(f"# HELP {fam.name} {_esc(fam.help)}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, child in fam.items():
            labels = dict(key)
            if fam.kind == "histogram":
                n, total, buckets = child.snapshot()
                for le, c in buckets:
                    bl = dict(labels)
                    bl["le"] = _fmt_le(le)
                    lines.append(f"{fam.name}_bucket{_fmt_labels(bl)} {c}")
                lines.append(
                    f"{fam.name}_sum{_fmt_labels(labels)} {total!r}")
                lines.append(
                    f"{fam.name}_count{_fmt_labels(labels)} {n}")
            else:
                lines.append(
                    f"{fam.name}{_fmt_labels(labels)} {child.value!r}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?\s+(?P<value>\S+)\s*$')
_LABEL_RE = re.compile(r'(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:\\.|[^"\\])*)"')


_UNESC_RE = re.compile(r"\\(.)")


def _unesc(v: str) -> str:
    # left-to-right, one pass: sequential str.replace would mis-decode a
    # literal backslash followed by 'n' (r'\\n' is backslash + 'n', not LF)
    return _UNESC_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                        float]:
    """Sample lines -> {(name, sorted-label-items): value}.

    Inverts ``to_prometheus`` (comments/TYPE lines skipped); histogram
    component samples come back under their _bucket/_sum/_count names.
    """
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        labels = tuple(sorted(
            (lm.group("k"), _unesc(lm.group("v")))
            for lm in _LABEL_RE.finditer(m.group("labels") or "")))
        raw = m.group("value")
        val = math.inf if raw == "+Inf" else \
            -math.inf if raw == "-Inf" else float(raw)
        out[(m.group("name"), labels)] = val
    return out
