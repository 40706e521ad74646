"""Per-op device-time attribution of a step: which IR op its kernels ran for.

The port's counterpart of ``paddle_tpu/observability/attribution.py``,
redesigned for the card. The JAX module walks XLA's optimized HLO text,
whose instructions carry each IR op's ``named_scope``; the port has no HLO.
What it has is the eager run that precedes every capture (the warm-up,
``core/graphs.py::warm_up``), which launches the same kernels the graph
will replay. So, at a capture miss and only when armed, that run goes under
``torch.profiler`` with one ``record_function`` range per IR op
(``trace_block``), named ``<op_type>#<op_idx>`` (``<op_type>#<block>:<op_idx>``
inside a sub-block), and this module reads the profile back:

- a kernel (or a device copy or memset) belongs to the innermost IR range
  that was open on the CPU when it was launched. Ranges are matched by
  time, not by thread, because a grad op's kernels are launched from
  autograd's device thread while the grad op's range is open on the
  executor's thread (its ``torch.autograd.grad`` waits for them). A grouped
  optimizer update (one multi-tensor launch for a run of update ops) is one
  range, named after the run's first op;
- a kernel's time is bucketed by its name into a category: ``attention``
  (the flash-attention kernels), ``matmul`` (cuBLAS GEMMs, ``nvjet_*`` on
  Hopper, the int8 matmul), ``conv`` (cuDNN, the fused 1x1 conv + BN statistics),
  ``reduction`` (reductions, softmax, the norms), ``copy`` (copies, casts,
  concatenations) and ``elementwise`` (the rest);
- each op's input and output tensor bytes are counted as it runs.

On the CPU the same ranges hold the PyTorch ops' self times (the CPU is the
device there), bucketed by each op's name.

Gauges (per program label): ``op_device_seconds{program,op,category}``,
``op_tensor_bytes{program,op}`` and ``attributed_device_fraction{program}``
(the attributed share of the device time in the profiled run). A late
profiler session can drop its first device records (ROADMAP fault 3.2), so
the fraction is stated beside every attribution.

Only one kineto session runs at a time: when one is already active (a
``fluid.profiler`` window, a tool's trace), attribution skips, journals
why, and runs the step unprofiled; it never raises into the step. Inside a
replayed CUDA graph there are no CPU ranges, which is why only the eager
warm-up is profiled.

Armed by ``PADDLE_TPU_OBS=1``, ``PADDLE_TPU_OBS_ATTRIB=1`` or
:func:`arm_capture` (which also writes each attribution as a JSON artifact);
disarmed, the executor's path pays one environment read at a miss.
``python -m paddle_tpu_torch.observability.attribution A B`` diffs two
artifacts (as ``tools/hlo_diff.py`` does for HLO).
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from .metrics import REGISTRY, MetricsRegistry

#: env toggle: arm attribution without the full obs toggle
ATTRIB_ENV = "PADDLE_TPU_OBS_ATTRIB"

#: metric families owned by this module (per program)
GAUGE_FAMILIES = ("op_device_seconds", "op_tensor_bytes", "attributed_device_fraction")

CATEGORIES = ("attention", "matmul", "conv", "reduction", "copy", "elementwise")

#: the key of a device activity no IR range held
UNATTRIBUTED = "<unattributed>"

_IR_RANGE = re.compile(r"^[A-Za-z0-9_.]+#\d+(?::\d+)?$")

#: kernel-name fragments -> category, tried in order (lower-cased names)
_KERNEL_RULES = (
    # the port's K1 kernels (csrc/flash_attn_{fwd,bwd}.cu) and SDPA's
    ("attention", ("flash_", "bwd_dkdv", "bwd_dq", "delta_f32_kernel", "fmha",
                   "attention")),
    ("conv", ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm", "winograd")),
    # cuBLAS's Hopper kernels are named nvjet_*
    ("matmul", ("nvjet", "gemm", "gemv", "matmul", "cutlass", "xmma", "sm90_", "addmm",
                "bmm", "aten::mm", "linear")),
    ("reduction", ("reduce", "softmax", "norm", "sum", "mean", "argmax", "max_", "min_",
                   "cross_entropy", "logsumexp", "cumsum", "scan")),
    ("copy", ("memcpy", "memset", "copy", "cat", "clone", "contiguous", "to_copy",
              "aten::to", "transpose", "permute", "gather", "index")),
)

_tls = threading.local()
_capture_dir: Optional[str] = None
# (id(program), version) -> (weakref to the program, its attribution)
_IR_STORE: "collections.OrderedDict" = collections.OrderedDict()
_IR_STORE_CAP = 64


def kernel_category(name: str) -> str:
    """The category a kernel (or, on the CPU, a PyTorch op) name falls in."""
    n = name.lower()
    for cat, frags in _KERNEL_RULES:
        if any(f in n for f in frags):
            return cat
    return "elementwise"


def ir_key(op_type: str, block_idx: int, op_idx: int) -> str:
    """The range name of an IR op: ``type#i`` in block 0, ``type#b:i`` else."""
    return f"{op_type}#{op_idx}" if block_idx == 0 else f"{op_type}#{block_idx}:{op_idx}"


# ------------------------------------------------------------- annotation --

def annotation():
    """The op-bytes table of the run being attributed on this thread, or
    None (the executor's ``trace_block`` reads this once a block)."""
    return getattr(_tls, "op_bytes", None)


@contextlib.contextmanager
def annotating(op_bytes: Dict[str, float]):
    """Within the body, ``trace_block`` on this thread opens a
    ``record_function`` range per op and adds each op's tensor bytes to
    ``op_bytes``."""
    prev = getattr(_tls, "op_bytes", None)
    _tls.op_bytes = op_bytes
    try:
        yield op_bytes
    finally:
        _tls.op_bytes = prev


# --------------------------------------------------------------- results --

class ProgramAttribution:
    """Attribution of one profiled step."""

    def __init__(self, label: str, device: str = "cuda"):
        self.label = label
        self.device = device
        #: ir key (or UNATTRIBUTED) -> {"device_seconds", "kernels",
        #: "tensor_bytes", "categories": {cat: seconds}, "names": {kernel: seconds}}
        self.per_ir: Dict[str, dict] = {}
        #: category -> {"device_seconds", "kernels"}
        self.per_category: Dict[str, dict] = {}
        self.total_device_seconds = 0.0
        self.attributed_device_seconds = 0.0

    @property
    def coverage(self) -> float:
        """Fraction of the run's device time attributed to a named IR op."""
        return (self.attributed_device_seconds / self.total_device_seconds
                if self.total_device_seconds else 0.0)

    def top_ops(self, k: int = 10) -> List[Tuple[str, dict]]:
        return sorted(((ir, v) for ir, v in self.per_ir.items() if ir != UNATTRIBUTED),
                      key=lambda kv: -kv[1]["device_seconds"])[:k]

    def add(self, ir: str, name: str, seconds: float, category: str) -> None:
        row = self.per_ir.setdefault(ir, {"device_seconds": 0.0, "kernels": 0,
                                          "tensor_bytes": 0.0, "categories": {},
                                          "names": {}})
        row["device_seconds"] += seconds
        row["kernels"] += 1
        row["categories"][category] = row["categories"].get(category, 0.0) + seconds
        row["names"][name] = row["names"].get(name, 0.0) + seconds
        self.total_device_seconds += seconds
        if ir == UNATTRIBUTED:
            return
        self.attributed_device_seconds += seconds
        cat = self.per_category.setdefault(category, {"device_seconds": 0.0, "kernels": 0})
        cat["device_seconds"] += seconds
        cat["kernels"] += 1

    def to_dict(self) -> dict:
        return {"label": self.label, "device": self.device,
                "total_device_seconds": self.total_device_seconds,
                "attributed_device_seconds": self.attributed_device_seconds,
                "coverage": self.coverage, "per_category": self.per_category,
                "per_ir": self.per_ir}

    @staticmethod
    def from_dict(d: dict) -> "ProgramAttribution":
        a = ProgramAttribution(d.get("label", "?"), d.get("device", "cuda"))
        a.total_device_seconds = float(d.get("total_device_seconds", 0.0))
        a.attributed_device_seconds = float(d.get("attributed_device_seconds", 0.0))
        a.per_category = dict(d.get("per_category", {}))
        a.per_ir = dict(d.get("per_ir", {}))
        return a

    def summary_lines(self, top: int = 8) -> List[str]:
        lines = [f"program {self.label}: {_fmt_s(self.total_device_seconds)} of "
                 f"{self.device} time, {self.coverage:.1%} attributed to IR ops"]
        for cat, v in sorted(self.per_category.items(),
                             key=lambda kv: -kv[1]["device_seconds"]):
            lines.append(f"  {cat}: {_fmt_s(v['device_seconds'])} over "
                         f"{v['kernels']} kernel(s)")
        for ir, v in self.top_ops(top):
            cats = ",".join(sorted(v["categories"]))
            lines.append(f"  op {ir}: {_fmt_s(v['device_seconds'])} [{cats}]")
        return lines


def _fmt_s(v: Optional[float]) -> str:
    return "?" if v is None else f"{v * 1e3:.3f} ms"


# ------------------------------------------------------------ attribution --

def _cpu_self_times(events: List[dict]) -> List[Tuple[float, float, str]]:
    """(start us, self seconds, name) of every ``cpu_op`` event: its time
    less its direct ``cpu_op`` children's on its thread, so the selves sum
    to the outermost ops' time and each lands under its own name."""
    by_tid: Dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            by_tid.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = []
    for evs in by_tid.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: List[list] = []      # [end, self us, start, name]
        for e in evs:
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            while stack and stack[-1][0] <= ts:
                end, self_us, start, name = stack.pop()
                out.append((start, max(self_us, 0.0) / 1e6, name))
            if stack:
                stack[-1][1] -= dur
            stack.append([ts + dur, dur, ts, e["name"]])
        out += [(start, max(self_us, 0.0) / 1e6, name) for _, self_us, start, name in stack]
    return out


def attribute_trace(events: List[dict], op_bytes: Optional[Dict[str, float]] = None,
                    label: str = "program", device: str = "cuda") -> ProgramAttribution:
    """Attribute the device activities of a Chrome trace (a
    ``torch.profiler`` export's ``traceEvents``) to the IR ranges in it.

    On ``device="cuda"`` the activities are the ``kernel``, ``gpu_memcpy``
    and ``gpu_memset`` events, each placed at its launch (the CUDA runtime
    or driver event of the same ``correlation``); on ``"cpu"`` the
    ``cpu_op`` events' self times (each op's time less its children's), at
    their start."""
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                     for e in events
                     if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                     and _IR_RANGE.match(str(e.get("name", "")))),
                    key=lambda r: (r[0], -r[1]))
    acts = []   # (time it was issued, seconds, name)
    if device == "cpu":
        acts = _cpu_self_times(events)
    else:
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch[c] = float(e["ts"])
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
                c = (e.get("args") or {}).get("correlation")
                acts.append((launch.get(c), float(e.get("dur", 0.0)) / 1e6, e["name"]))
    attrib = ProgramAttribution(label, device)
    # sweep the launches in time order against the open ranges
    order = sorted((a for a in acts if a[0] is not None), key=lambda a: a[0])
    open_ranges: List[Tuple[float, float, str]] = []
    ri = 0
    for t, secs, name in order:
        while ri < len(ranges) and ranges[ri][0] <= t:
            open_ranges.append(ranges[ri])
            ri += 1
        open_ranges = [r for r in open_ranges if r[1] >= t]
        inner = max(open_ranges, key=lambda r: r[0])[2] if open_ranges else UNATTRIBUTED
        attrib.add(inner, name, secs, kernel_category(name))
    for t, secs, name in acts:
        if t is None:
            attrib.add(UNATTRIBUTED, name, secs, kernel_category(name))
    for ir, nbytes in (op_bytes or {}).items():
        row = attrib.per_ir.setdefault(ir, {"device_seconds": 0.0, "kernels": 0,
                                            "tensor_bytes": 0.0, "categories": {},
                                            "names": {}})
        row["tensor_bytes"] = float(nbytes)
    return attrib


# ----------------------------------------------------------------- arming --

def attribution_enabled() -> bool:
    """Armed under ``PADDLE_TPU_OBS``, ``PADDLE_TPU_OBS_ATTRIB`` or an armed
    capture directory."""
    from . import journal as _journal
    if _capture_dir is not None or _journal.env_truthy(ATTRIB_ENV):
        return True
    return _journal.enabled()


def arm_capture(directory: Optional[str]) -> None:
    """Arm (or disarm with None) artifact capture: every later attribution
    also writes ``attrib_<label>.json`` into ``directory``."""
    global _capture_dir
    if directory is not None:
        os.makedirs(directory, exist_ok=True)
    _capture_dir = directory


def capture_dir() -> Optional[str]:
    return _capture_dir


def _safe_label(label: str) -> str:
    return re.sub(r"[^\w.\-]+", "_", label)


def signature_digest(sig) -> str:
    """Stable 8-hex digest of a feed signature: gauge labels must be
    reproducible across processes (``hash()`` is salted per run)."""
    import hashlib
    return hashlib.md5(repr(sig).encode()).hexdigest()[:8]


def profiling_active() -> bool:
    """Whether a profiler session is already running in this process."""
    import torch
    return bool(torch._C._autograd._profiler_enabled())


@contextlib.contextmanager
def profiled(program, label: str, device, registry: Optional[MetricsRegistry] = None):
    """Around a step's eager run: when attribution is armed, profile the
    body with one range per IR op and, after it, attribute and publish the
    run (:func:`publish`); the caller's work ends inside the body, the
    profiler's processing after it. When another profiler session is active
    the body runs unprofiled and an ``attribution_skipped`` event says why.
    A failure of the attribution itself warns; the body's errors propagate."""
    if not attribution_enabled():
        yield
        return
    from . import journal as _journal
    if profiling_active():
        _journal.emit({"event": "attribution_skipped", "program": label,
                       "reason": "another profiler session is active (one kineto "
                                 "session runs at a time)"})
        yield
        return
    import tempfile
    import torch
    dev = getattr(device, "type", str(device))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    op_bytes: Dict[str, float] = {}
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        with annotating(op_bytes):
            yield
        if dev == "cuda":
            torch.cuda.synchronize(device)
    finally:
        prof.stop()
    try:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="paddle_tpu_attrib_")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        publish(attribute_trace(events, op_bytes, label, "cuda" if dev == "cuda" else "cpu"),
                program, registry)
    except (OSError, ValueError, KeyError, TypeError) as e:
        import warnings
        warnings.warn(f"attribution of {label} failed: {e!r}")


def publish(attrib: ProgramAttribution, program=None,
            registry: Optional[MetricsRegistry] = None) -> None:
    """Export an attribution: gauges, the IR store (for the black box), an
    ``attribution`` journal event and, when armed, the capture artifact."""
    update_attribution_gauges(attrib, registry)
    record_program(program, attrib)
    from . import journal as _journal
    _journal.emit({
        "event": "attribution", "program": attrib.label, "device": attrib.device,
        "device_seconds": attrib.total_device_seconds,
        "attributed_device_fraction": round(attrib.coverage, 4),
        "categories": {c: v["device_seconds"] for c, v in attrib.per_category.items()},
        "top_ops": [{"ir": k, "device_seconds": v["device_seconds"]}
                    for k, v in attrib.top_ops(5)]})
    if _capture_dir is not None:
        path = os.path.join(_capture_dir, f"attrib_{_safe_label(attrib.label)}.json")
        with open(path, "w") as f:
            json.dump({"label": attrib.label, "attribution": attrib.to_dict()}, f)


def record_program(program_ir, attrib: ProgramAttribution) -> None:
    if program_ir is None:
        return
    key = (id(program_ir), getattr(program_ir, "_version", 0))
    _IR_STORE[key] = (weakref.ref(program_ir), attrib)
    while len(_IR_STORE) > _IR_STORE_CAP:
        _IR_STORE.popitem(last=False)


def lookup_program(program_ir) -> Optional[ProgramAttribution]:
    """The attribution recorded for this exact Program object (identity and
    version checked), or None."""
    ent = _IR_STORE.get((id(program_ir), getattr(program_ir, "_version", 0)))
    if ent is None:
        return None
    ref, attrib = ent
    return attrib if ref() is program_ir else None


def update_attribution_gauges(attrib: ProgramAttribution,
                              registry: Optional[MetricsRegistry] = None) -> None:
    registry = registry or REGISTRY
    for ir, row in attrib.per_ir.items():
        if ir == UNATTRIBUTED:
            continue
        for cat, secs in row["categories"].items():
            registry.gauge("op_device_seconds", "device seconds of an IR op's kernels "
                           "in its step's profiled eager run, by kernel category",
                           program=attrib.label, op=ir, category=cat).set(secs)
        registry.gauge("op_tensor_bytes", "bytes of an IR op's input and output "
                       "tensors in its step", program=attrib.label, op=ir
                       ).set(row["tensor_bytes"])
    registry.gauge("attributed_device_fraction", "share of a profiled step's device "
                   "time whose kernels an IR op's range launched",
                   program=attrib.label).set(attrib.coverage)


def retire_program(label: str, registry: Optional[MetricsRegistry] = None) -> None:
    """Drop every attribution series of one program label."""
    registry = registry or REGISTRY
    for fname in GAUGE_FAMILIES:
        fam = registry.get(fname)
        if fam is None:
            continue
        with fam._lock:
            for key in [k for k in fam.children if ("program", label) in k]:
                fam.children.pop(key, None)


# ------------------------------------------------------------------- diff --

def diff_attributions(a: ProgramAttribution, b: ProgramAttribution) -> dict:
    """B - A: per-category device-time and kernel-count deltas, and the IR
    ops whose device time changed (new, removed or changed)."""
    cat_rows = []
    for c in sorted(set(a.per_category) | set(b.per_category)):
        va = a.per_category.get(c, {"device_seconds": 0.0, "kernels": 0})
        vb = b.per_category.get(c, {"device_seconds": 0.0, "kernels": 0})
        cat_rows.append({"category": c, "kernels_a": va["kernels"], "kernels_b": vb["kernels"],
                         "kernels_delta": vb["kernels"] - va["kernels"],
                         "seconds_a": va["device_seconds"], "seconds_b": vb["device_seconds"],
                         "seconds_delta": vb["device_seconds"] - va["device_seconds"]})
    ops = []
    for ir in set(a.per_ir) | set(b.per_ir):
        sa = a.per_ir.get(ir, {}).get("device_seconds", 0.0)
        sb = b.per_ir.get(ir, {}).get("device_seconds", 0.0)
        if sa != sb:
            ops.append({"ir": ir, "seconds_a": sa, "seconds_b": sb, "delta": sb - sa,
                        "status": ("new" if ir not in a.per_ir else
                                   "removed" if ir not in b.per_ir else "changed")})
    ops.sort(key=lambda g: (-abs(g["delta"]), g["ir"]))
    return {"a": a.label, "b": b.label,
            "total_seconds_a": a.total_device_seconds, "total_seconds_b": b.total_device_seconds,
            "coverage_a": a.coverage, "coverage_b": b.coverage,
            "categories": cat_rows, "ops": ops}


def format_diff(d: dict, top: int = 8) -> str:
    lines = [f"attribution diff: {d['a']} -> {d['b']}",
             f"  device time {_fmt_s(d['total_seconds_a'])} -> {_fmt_s(d['total_seconds_b'])}, "
             f"attributed {d['coverage_a']:.1%} -> {d['coverage_b']:.1%}",
             "  per category (kernels a->b, time a->b):"]
    for r in d["categories"]:
        lines.append(f"    {r['category']:<12} {r['kernels_a']:>6} -> {r['kernels_b']:<6} "
                     f"({r['kernels_delta']:+d})   {_fmt_s(r['seconds_a'])} -> "
                     f"{_fmt_s(r['seconds_b'])}")
    shown = d["ops"][:top]
    if shown:
        lines.append(f"  top {len(shown)} changed IR ops by |time delta|:")
        for g in shown:
            lines.append(f"    {g['ir']:<28} {_fmt_s(g['seconds_a'])} -> "
                         f"{_fmt_s(g['seconds_b'])} [{g['status']}]")
    else:
        lines.append("  no per-op time deltas")
    return "\n".join(lines)


def load_artifact(path: str) -> ProgramAttribution:
    """Load one comparand: an artifact :func:`arm_capture` wrote, or a bare
    ``ProgramAttribution.to_dict()`` JSON."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "attribution" in doc:
        return ProgramAttribution.from_dict(doc["attribution"])
    if isinstance(doc, dict) and "per_ir" in doc:
        return ProgramAttribution.from_dict(doc)
    raise ValueError(f"{path}: not an attribution artifact")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.attribution",
        description="diff two attribution artifacts: per-category device-time and "
                    "kernel-count deltas with the IR ops that moved")
    ap.add_argument("a", help="baseline artifact")
    ap.add_argument("b", help="candidate artifact")
    ap.add_argument("--top", type=int, default=8, help="changed IR ops to show (default 8)")
    ap.add_argument("--json", action="store_true", help="print the raw diff as JSON")
    ap.add_argument("--summary", action="store_true", help="also print each side's summary")
    args = ap.parse_args(argv)
    try:
        a, b = load_artifact(args.a), load_artifact(args.b)
    except (OSError, ValueError) as e:
        print(f"error: {e}")
        return 2
    d = diff_attributions(a, b)
    if args.json:
        print(json.dumps(d, indent=2, sort_keys=True))
        return 0
    if args.summary:
        for side in (a, b):
            print("\n".join(side.summary_lines()))
    print(format_diff(d, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
