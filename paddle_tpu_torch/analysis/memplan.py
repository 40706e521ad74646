"""Static peak-memory planner: liveness over the IR, bytes before the run
(the port's copy of ``paddle_tpu/analysis/memplan.py``).

A program that runs out of memory does so only after its warm-up and its
capture on the card; the shape and dtype of every buffer is right there in
the IR, so "does this step fit" is statically estimable. The planner reuses
the dataflow pass's liveness machinery (interval liveness per var, with
sub-block reads attributed to the referencing op -- ``dataflow.op_reads``),
accounts dtype x shape bytes, and mirrors the executor's in-place state:
persistable state that a step both reads and writes under one name is
updated in place (the JAX package's donated buffer, ``Executor._capture``'s
donated state), so its update costs nothing extra.

The model of a step's footprint:

    peak = arg bytes (state_in + feeds, in-place state counted once)
         + max over program points of the live intermediate/output bytes

It is an *estimate*: the port frees each intermediate after its last
reader (``trace_block``), but autograd keeps forward graphs alive for their
grad ops and the CUDA graph's pool rounds every block up, so the number
lands within small factors, not exactly -- the executor sets it at every
capture as ``program_static_peak_bytes``, and beside the capture's
arguments and graph pool as ``program_static_peak_ratio``
(``observability/memory.py``), so the planner's accuracy is itself
observable.

Codes: PT050 (info) carries the estimate + the top-k live set at the
high-water op; PT051 (error) fires when the estimate exceeds the budget
(``--mem-budget`` / ``verify(mem_budget=...)`` / ``PADDLE_TPU_MEM_BUDGET``);
PT052 (warn) marks estimates that had to assume a batch size for dynamic
dims. Registered opt-in (``default=False``): it reports rather than
checks, so it runs when asked -- a budget is set, or the pass is named
explicitly. A ``strategy`` (sharding divisors, ``comm_compression``'s
residuals) raises, naming ROADMAP item 13 (c).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .dataflow import op_reads
from .diagnostics import Diagnostic
from .pass_base import (AnalysisPass, PassContext, op_output_names,
                        register_pass, split_strategy)

DEFAULT_ASSUMED_BATCH = 1


def dtype_bytes(dtype: str) -> int:
    """Bytes per element of a dtype name (the JAX package's
    ``analysis/distributed.py`` helper; 4 for a name numpy does not know)."""
    import numpy as np
    if dtype == "bfloat16":
        return 2
    try:
        return int(np.dtype(dtype).itemsize)
    except TypeError:
        return 4


def parse_bytes(s: str) -> int:
    """'67108864', '64M', '8G', '1.5G' -> bytes (ValueError on junk).
    Shared by the CLI --mem-budget and the PADDLE_TPU_MEM_BUDGET env."""
    s = str(s).strip()
    mult = {"K": 1e3, "M": 1e6, "G": 1e9, "T": 1e12}.get(s[-1:].upper())
    if mult is not None:
        return int(float(s[:-1]) * mult)
    return int(s)


def format_bytes(n: float) -> str:
    n = float(n)
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if n >= div:
            return f"{n / div:.2f} {unit}"
    return f"{n:.0f} B"


class MemEstimate:
    """Result of ``estimate_program_memory``."""

    __slots__ = ("peak_bytes", "arg_bytes", "temp_bytes", "peak_op_idx",
                 "peak_op_type", "top", "batch", "assumed_batch",
                 "n_dynamic", "n_unknown")

    def __init__(self, peak_bytes, arg_bytes, temp_bytes, peak_op_idx,
                 peak_op_type, top, batch, assumed_batch, n_dynamic,
                 n_unknown):
        self.peak_bytes = peak_bytes        # arg + high-water live bytes
        self.arg_bytes = arg_bytes          # state_in + feeds (donated once)
        self.temp_bytes = temp_bytes        # high-water intermediate bytes
        self.peak_op_idx = peak_op_idx      # global-block op idx at peak
        self.peak_op_type = peak_op_type
        self.top = top                      # [{name, bytes, kind}] at peak
        self.batch = batch                  # batch used for -1 dims
        self.assumed_batch = assumed_batch  # True: batch was defaulted
        self.n_dynamic = n_dynamic          # vars with -1 dims resolved
        self.n_unknown = n_unknown          # names with no declared var

    def summary(self, k: int = 5) -> str:
        where = (f" at op #{self.peak_op_idx} ({self.peak_op_type})"
                 if self.peak_op_idx is not None else "")
        top = "; ".join(f"{t['name']} {format_bytes(t['bytes'])} "
                        f"[{t['kind']}]" for t in self.top[:k])
        return (f"estimated peak {format_bytes(self.peak_bytes)} "
                f"(args {format_bytes(self.arg_bytes)} + high-water temps "
                f"{format_bytes(self.temp_bytes)}){where}; top live: {top}")

    def to_dict(self) -> dict:
        return {s: getattr(self, s) for s in self.__slots__}


def infer_batch(program, feed_shapes: Dict[str, tuple]) -> Optional[int]:
    """The batch extent implied by actual feed shapes: the dim-0 extent fed
    for a data var declared with a dynamic (-1) leading dim."""
    gb = program.global_block()
    for n, shape in feed_shapes.items():
        v = gb.find_var_recursive(n)
        if v is not None and v.ndim and v.shape[0] == -1 and len(shape):
            return int(shape[0])
    return None


def estimate_program_memory(program, feed_names: Optional[Sequence[str]] = None,
                            fetch_names: Optional[Sequence[str]] = None,
                            strategy=None, batch: Optional[int] = None,
                            top_k: int = 8) -> MemEstimate:
    """Liveness-based peak-memory estimate of one executor step of
    ``program`` (global block; sub-block reads pin outer vars live, their
    per-iteration locals are scan-internal and not counted). A ``strategy``
    raises NotImplementedError (ROADMAP item 13 (c))."""
    split_strategy(strategy)
    gb = program.global_block()
    persistable = {n for n, v in gb.vars.items() if v.persistable}

    # -- what the executor feeds/updates in place (Executor._state_names) --
    feeds = list(feed_names) if feed_names else \
        [n for n, v in gb.vars.items() if v.is_data]
    produced = set(feeds)
    state_in, state_out = [], set()
    reads_at: List[List[str]] = []
    for op in gb.ops:
        rd = op_reads(program, op)
        reads_at.append(rd)
        for n in rd:
            if n in persistable and n not in produced and n not in state_in:
                state_in.append(n)
        for n in op_output_names(op):
            if n in persistable:
                state_out.add(n)
            produced.add(n)
    for n in fetch_names or ():
        if n in persistable and n not in produced and n not in state_in:
            state_in.append(n)
    donated = set(state_in) & state_out

    assumed = batch is None
    eff_batch = DEFAULT_ASSUMED_BATCH if batch is None else int(batch)
    stats = {"dyn": set(), "unknown": set()}  # unique var names

    def bytes_of(n: str) -> int:
        v = gb.find_var_recursive(n)
        if v is None:
            stats["unknown"].add(n)
            return 0
        count, dyn = 1, False
        for d in v.shape:
            if d == -1:
                dyn = True
                count *= eff_batch
            else:
                count *= max(0, int(d))
        if dyn:
            stats["dyn"].add(n)
        return count * dtype_bytes(v.dtype)

    args = [n for n in state_in if gb.find_var_recursive(n) is not None]
    args += [n for n in feeds
             if n not in args and gb.find_var_recursive(n) is not None]
    arg_set = set(args)
    arg_bytes = sum(bytes_of(n) for n in args)

    last_read: Dict[str, int] = {}
    for i, rd in enumerate(reads_at):
        for n in rd:
            last_read[n] = i
    never_free = set(fetch_names or ()) | state_out | arg_set

    # invert last_read once: frees_at[i] = names whose last reader is op i
    # (the walk below runs at every executor capture miss -- O(ops + vars),
    # not an O(ops x live) rescan of the live dict per op)
    frees_at: List[List[str]] = [[] for _ in gb.ops]
    for n, i in last_read.items():
        if n not in never_free and 0 <= i < len(frees_at):
            frees_at[i].append(n)

    live: Dict[str, int] = {}
    cur = 0  # running total
    peak_temp, peak_idx, peak_live = 0, None, {}
    for i, op in enumerate(gb.ops):
        produced_now = []
        for n in op_output_names(op):
            if n in arg_set or n in donated or n in live:
                continue  # donated updates alias their input buffer
            live[n] = bytes_of(n)
            cur += live[n]
            produced_now.append(n)
        if cur > peak_temp:
            peak_temp, peak_idx, peak_live = cur, i, dict(live)
        for n in frees_at[i]:
            if n in live:
                cur -= live.pop(n)
        for n in produced_now:
            # an output nothing ever reads (or whose 'last read' precedes
            # its write) dies at its producing op
            if n in live and n not in never_free \
                    and last_read.get(n, -1) <= i:
                cur -= live.pop(n)

    def kind(n):
        if n in persistable:
            return "state"
        if n in set(feeds):
            return "feed"
        if n in (fetch_names or ()):
            return "out"
        return "temp"

    at_peak = [{"name": n, "bytes": b, "kind": kind(n)}
               for n, b in peak_live.items()]
    at_peak += [{"name": n, "bytes": bytes_of(n), "kind": kind(n)}
                for n in args]
    at_peak.sort(key=lambda t: (-t["bytes"], t["name"]))

    peak_op_type = (gb.ops[peak_idx].type if peak_idx is not None and
                    peak_idx < len(gb.ops) else None)
    return MemEstimate(arg_bytes + peak_temp, arg_bytes, peak_temp,
                       peak_idx, peak_op_type, at_peak[:top_k], eff_batch,
                       assumed and bool(stats["dyn"]), len(stats["dyn"]),
                       len(stats["unknown"]))


@register_pass(default=False)
class MemPlanPass(AnalysisPass):
    name = "memplan"

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        est = estimate_program_memory(
            ctx.program, feed_names=ctx.feed_names,
            fetch_names=ctx.fetch_names, batch=ctx.batch)
        diags.append(Diagnostic("PT050", est.summary(), block_idx=0,
                                op_idx=est.peak_op_idx,
                                op_type=est.peak_op_type))
        if est.assumed_batch:
            diags.append(Diagnostic(
                "PT052", f"{est.n_dynamic} var(s) have dynamic (-1) dims "
                         f"resolved with an assumed batch of {est.batch}; "
                         f"pass the real batch (--batch / "
                         f"verify(batch=...)) for a trustworthy estimate",
                block_idx=0))
        if ctx.mem_budget is not None and est.peak_bytes > ctx.mem_budget:
            diags.append(Diagnostic(
                "PT051", f"estimated peak {format_bytes(est.peak_bytes)} "
                         f"exceeds the memory budget "
                         f"{format_bytes(ctx.mem_budget)} "
                         f"(over by {format_bytes(est.peak_bytes - ctx.mem_budget)}); "
                         f"{est.summary(3)}", block_idx=0,
                op_idx=est.peak_op_idx, op_type=est.peak_op_type))
        return diags
