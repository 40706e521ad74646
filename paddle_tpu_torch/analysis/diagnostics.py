"""Diagnostics: stable codes, severities, op attribution (the port's copy
of ``paddle_tpu/analysis/diagnostics.py``, with the same codes and texts).

The analyzer's findings are plain data (`Diagnostic`) keyed by stable
``PT0xx`` codes so tooling (CI gates, the executor's PADDLE_TPU_VALIDATE
mode, editors parsing ``--format json``) can match on them without parsing
prose. Severity semantics:

- ``error``: the program will fail (or silently misbehave) when the
  executor runs it -- undefined vars, unregistered ops, dtype clashes.
- ``warn``: legal but almost certainly not what the author meant, or a
  measurable performance hazard (dead ops, recompile-prone feed shapes).
- ``info``: observations worth surfacing in a report, never gating.

The table keeps every code of the JAX package, the distributed PT04x and
the auto-sharding PT07x rows too (their passes are ROADMAP item 13 (c)'s and
not in the port), so a baseline file written by either package reads in
both. A code's text names XLA where the JAX package's does; in the port a
"compile" is a CUDA-graph capture, one per program, version and feed
signature.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class Severity:
    ERROR = "error"
    WARN = "warn"
    INFO = "info"

    ORDER = {ERROR: 0, WARN: 1, INFO: 2}


#: code -> (default severity, one-line summary). The single source of truth
#: rendered by ``python -m paddle_tpu_torch.analysis --codes`` and the README table.
CODES: Dict[str, tuple] = {
    # -- well-formedness (wellformed.py) -----------------------------------
    "PT001": (Severity.ERROR, "op reads a variable that is never defined, "
                              "fed, or produced"),
    "PT002": (Severity.ERROR, "op reads a variable before any op produces "
                              "it (use-before-def)"),
    "PT003": (Severity.WARN, "variable name declared in a sub-block shadows "
                             "an outer declaration"),
    "PT004": (Severity.ERROR, "op type is not registered in the op "
                              "registry"),
    "PT005": (Severity.ERROR, "malformed *_block attr (not a valid block "
                              "index)"),
    "PT006": (Severity.ERROR, "sub-block cycle: a block is reachable from "
                              "itself via *_block attrs"),
    "PT007": (Severity.INFO, "orphan sub-block: no op references it"),
    # -- dataflow (dataflow.py) --------------------------------------------
    "PT010": (Severity.WARN, "dead op: contributes to no fetch target and "
                             "writes no state"),
    "PT011": (Severity.INFO, "unused output: produced but never read, "
                             "fetched, or persisted"),
    "PT012": (Severity.ERROR, "fetch target is never produced by the "
                              "program (and is not a feed or state var)"),
    "PT013": (Severity.WARN, "write-after-write: value overwritten before "
                             "any op reads it"),
    "PT014": (Severity.INFO, "op reads and writes the same non-persistable "
                             "variable (in-place update)"),
    "PT015": (Severity.WARN, "feed variable is never read by the program"),
    # -- type/shape consistency (typecheck.py) -----------------------------
    "PT020": (Severity.ERROR, "declared dtype disagrees with the dtype "
                              "shape-inference derives"),
    "PT021": (Severity.ERROR, "declared shape disagrees with the shape "
                              "shape-inference derives"),
    "PT022": (Severity.WARN, "shape inference failed for this op (would "
                             "surface as a trace-time error)"),
    # -- recompile risk (recompile.py) -------------------------------------
    "PT030": (Severity.WARN, "data var has a dynamic (-1) dim beyond the "
                             "leading batch dim: every distinct feed shape "
                             "recompiles"),
    "PT031": (Severity.INFO, "data var has a dynamic batch dim: each "
                             "distinct batch size compiles a cache entry"),
    "PT032": (Severity.WARN, "ops of one type mix is_test=True and False "
                             "in the same program (partial for_test "
                             "clone?)"),
    "PT033": (Severity.INFO, "program has stochastic ops but no "
                             "random_seed: seed 0 is baked into the "
                             "compiled step"),
    "PT034": (Severity.INFO, "fused multi-step execution with a dynamic "
                             "batch dim: every distinct (K, batch) pair "
                             "compiles its own megastep, plus the K=1 "
                             "remainder entry"),
    # -- distributed consistency (distributed.py) --------------------------
    "PT040": (Severity.ERROR, "collective op communicates over a mesh axis "
                              "the strategy's mesh does not define"),
    "PT041": (Severity.ERROR, "collective op inside divergent control flow "
                              "(cond branch / data-dependent while): ranks "
                              "can disagree and deadlock"),
    "PT042": (Severity.ERROR, "pipeline stages disagree on their collective "
                              "op sequence: stage programs run in lockstep "
                              "and would desynchronize"),
    "PT043": (Severity.ERROR, "sharding rule names a mesh axis that is not "
                              "in the strategy's mesh_shape"),
    "PT044": (Severity.ERROR, "sharding spec has more entries than the "
                              "variable has dims (spec on a missing dim)"),
    "PT045": (Severity.ERROR, "sharded dim size is not divisible by the "
                              "product of its mesh axis sizes"),
    "PT046": (Severity.WARN, "strategy forces a per-step re-gather: "
                             "ZeRO-sharded params are all-gathered at every "
                             "use (priced with the comm.plan_transfer "
                             "collective plan) or stay replicated, losing "
                             "the memory win"),
    "PT047": (Severity.WARN, "strategy pins an assumption that breaks "
                             "under an elastic resize: a data var's batch "
                             "dim is hardcoded to a multiple of the "
                             "current world size; a resized world that "
                             "does not divide it will reject every feed"),
    "PT048": (Severity.WARN, "comm_compression=int8 is set but a gradient "
                             "dtype is outside the quantizer's support; "
                             "that tensor silently falls back to the "
                             "uncompressed allreduce"),
    # -- static memory planning (memplan.py) -------------------------------
    "PT050": (Severity.INFO, "static peak-memory estimate for the program "
                             "(liveness over the IR, sharding divisors and "
                             "donation applied)"),
    "PT051": (Severity.ERROR, "static peak-memory estimate exceeds the "
                              "memory budget"),
    "PT052": (Severity.WARN, "memory estimate resolved dynamic (-1) dims "
                             "with an assumed batch size; pass the real "
                             "batch for a trustworthy number"),
    "PT060": (Severity.WARN, "an op pair forces a layout round-trip "
                             "(copy/transpose churn) of significant bytes "
                             "per step in the compiled program; consider "
                             "the conv2d.layout autotune or reordering "
                             "the producer"),
    # -- static auto-sharding planner (shardplan.py) -----------------------
    "PT070": (Severity.INFO, "auto-shard: the chosen shard plan -- per-"
                             "tensor spec assignment with the priced comm "
                             "and memory breakdown (PT04x-legal by "
                             "construction, PT05x-peak-checked)"),
    "PT071": (Severity.WARN, "auto-shard: no legal shard plan fits the "
                             "memory budget on this mesh; the most memory-"
                             "frugal plan's peak quantifies the gap"),
    "PT072": (Severity.INFO, "auto-shard: the top plans price within the "
                             "near-tie threshold -- the static cost model "
                             "cannot separate them; set auto_shard="
                             "'measure' to decide on the live workload"),
}


class Diagnostic:
    """One finding: code + severity + message + location/attribution.

    ``block_idx``/``op_idx`` locate the op inside the program;
    ``stack`` carries the op's user-code creation frames (the same
    attribution trace_block attaches to lowering errors) so a finding in a
    200-op program names the model line that built the op.
    """

    __slots__ = ("code", "severity", "message", "block_idx", "op_idx",
                 "op_type", "var", "stack")

    def __init__(self, code: str, message: str, block_idx: Optional[int] = None,
                 op_idx: Optional[int] = None, op_type: Optional[str] = None,
                 var: Optional[str] = None, stack: str = "",
                 severity: Optional[str] = None):
        assert code in CODES, f"unknown diagnostic code {code!r}"
        self.code = code
        self.severity = severity or CODES[code][0]
        self.message = message
        self.block_idx = block_idx
        self.op_idx = op_idx
        self.op_type = op_type
        self.var = var
        self.stack = stack

    @staticmethod
    def for_op(code: str, message: str, block, op, var: Optional[str] = None,
               severity: Optional[str] = None) -> "Diagnostic":
        op_idx = None
        for i, o in enumerate(block.ops):
            if o is op:
                op_idx = i
                break
        return Diagnostic(code, message, block_idx=block.idx, op_idx=op_idx,
                          op_type=op.type, var=var,
                          stack=op.creation_stack_str(), severity=severity)

    # -- rendering ---------------------------------------------------------
    def location(self) -> str:
        parts = []
        if self.block_idx is not None:
            parts.append(f"block {self.block_idx}")
        if self.op_idx is not None:
            parts.append(f"op #{self.op_idx}")
        if self.op_type:
            parts.append(self.op_type)
        return " ".join(parts)

    def format(self, with_stack: bool = False) -> str:
        loc = self.location()
        line = f"{self.code} {self.severity}: {self.message}"
        if loc:
            line += f"  [{loc}]"
        if with_stack and self.stack:
            line += "\n  op created at (most recent call last):\n" + \
                "".join(f"  {ln}\n" for ln in self.stack.splitlines())
            line = line.rstrip("\n")
        return line

    def to_dict(self) -> dict:
        return {"code": self.code, "severity": self.severity,
                "message": self.message, "block_idx": self.block_idx,
                "op_idx": self.op_idx, "op_type": self.op_type,
                "var": self.var, "stack": self.stack}

    def key(self) -> tuple:
        """Identity sans stack: two structurally identical programs (e.g. a
        serialize/deserialize round trip) produce equal keys even though
        their ops were created at different source lines."""
        return (self.code, self.severity, self.message, self.block_idx,
                self.op_idx, self.op_type, self.var)

    def _sort_key(self) -> tuple:
        return (Severity.ORDER.get(self.severity, 9), self.code,
                self.block_idx if self.block_idx is not None else -1,
                self.op_idx if self.op_idx is not None else -1)

    def __repr__(self):
        return f"Diagnostic({self.format()!r})"

    def __eq__(self, other):
        if not isinstance(other, Diagnostic):
            return NotImplemented
        return self.key() == other.key()

    def __hash__(self):
        return hash(self.key())


def sort_diagnostics(diags: List[Diagnostic]) -> List[Diagnostic]:
    return sorted(diags, key=Diagnostic._sort_key)


def count_by_severity(diags: List[Diagnostic]) -> Dict[str, int]:
    out = {Severity.ERROR: 0, Severity.WARN: 0, Severity.INFO: 0}
    for d in diags:
        out[d.severity] = out.get(d.severity, 0) + 1
    return out


def format_diagnostics(diags: List[Diagnostic], with_stack: bool = True) -> str:
    """Multi-line human rendering, errors first."""
    if not diags:
        return "no findings"
    lines = [d.format(with_stack=with_stack)
             for d in sort_diagnostics(diags)]
    c = count_by_severity(diags)
    lines.append(f"{c['error']} error(s), {c['warn']} warning(s), "
                 f"{c['info']} info")
    return "\n".join(lines)


def codes_table() -> str:
    """The diagnostic-code reference table (``--codes``)."""
    lines = ["code   severity  summary", "-" * 72]
    for code, (sev, summary) in sorted(CODES.items()):
        lines.append(f"{code}  {sev:<8}  {summary}")
    return "\n".join(lines)


# ------------------------------------------------------------- baselines --
# A baseline is a suppression file of Diagnostic.key()s: CI lints with
# --baseline FILE and gates on *new* findings only, so a legacy program's
# accepted findings don't block unrelated changes. Keys (not raw messages)
# make the file robust to creation-stack differences, and the byte-stable
# ordering (sort_diagnostics, then the key tuple itself) means regenerating
# an unchanged baseline is a no-op diff.

def write_baseline(path: str, diags: List[Diagnostic]) -> int:
    """Write the suppression file for ``diags``; returns the entry count.
    Duplicate keys (one finding per program point) collapse to one line."""
    import json
    seen = []
    for d in sort_diagnostics(diags):
        k = list(d.key())
        if k not in seen:
            seen.append(k)
    with open(path, "w") as f:
        f.write("# paddle_tpu analysis baseline: one Diagnostic.key() per "
                "line; findings matching a key are suppressed\n")
        for k in seen:
            f.write(json.dumps(k) + "\n")
    return len(seen)


def load_baseline(path: str) -> set:
    """Read a suppression file -> set of key tuples. Raises OSError on a
    missing file and ValueError on a malformed line (a typo in the baseline
    must not silently un-suppress everything)."""
    import json
    keys = set()
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                k = json.loads(line)
            except ValueError as e:
                raise ValueError(
                    f"{path}:{ln}: malformed baseline entry: {e}") from None
            if not isinstance(k, list):
                raise ValueError(f"{path}:{ln}: baseline entry must be a "
                                 f"JSON list (got {type(k).__name__})")
            keys.add(tuple(k))
    return keys


def apply_baseline(diags: List[Diagnostic], keys: set):
    """Split ``diags`` into (kept, suppressed) against a baseline key set."""
    kept, suppressed = [], []
    for d in diags:
        (suppressed if d.key() in keys else kept).append(d)
    return kept, suppressed
