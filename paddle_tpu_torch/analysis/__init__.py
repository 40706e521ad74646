"""Static program analysis: verify a Program before its first run (the
port's copy of ``paddle_tpu/analysis/``, its single-process passes).

The whole static Program is linted *ahead of time*, before the executor's
warm-up and CUDA-graph capture, on the host, touching no device (shape
inference runs each lowering on ``torch.device("meta")`` tensors):

    import paddle_tpu_torch.analysis as analysis
    diags = analysis.verify(main_program, fetch_names=["loss"])
    errors = [d for d in diags if d.severity == "error"]

Findings carry stable ``PT0xx`` codes (diagnostics.CODES is the table, the
JAX package's), severities (error/warn/info), and the op's user-code
creation stack (Operator._creation_stack) so every finding points at the
model line that built the offending op.

Three doors in:

- library: ``analysis.verify(program) -> [Diagnostic]`` (this module);
- CLI: ``python -m paddle_tpu_torch.analysis program.json --format json``
  over a serialized Program (``Program.to_json``, of either package);
- executor gate: ``PADDLE_TPU_VALIDATE=off|warn|raise`` (and
  ``PADDLE_TPU_MEM_BUDGET``) verifies once per signature miss, before the
  warm-up and the capture, and journals findings through observability.

Passes (pass_base registry): ``wellformed`` (undefined/use-before-def
vars, unregistered ops, block-graph sanity), ``dataflow`` (dead ops, WAW
hazards, fetch reachability), ``typecheck`` (shape/dtype propagation vs
declarations), ``recompile`` (capture-cache churn risks), the opt-in
``memplan`` (static liveness-based peak-memory planner, engaged by
``mem_budget=`` / ``--mem-budget`` or by naming the pass) and the opt-in
``layout_churn`` (PT060 over the port's per-op attribution).

Not ported: the JAX package's ``distributed`` (PT04x) and ``shardplan``
(PT07x) passes, which need a DistributedStrategy and ``comm/`` (ROADMAP
item 13). A ``strategy``, ``auto_shard=True``, or importing either name
from this package raises, naming the item.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..framework import Program
from . import dataflow  # noqa: F401  (registers the pass)
from . import layout_churn  # noqa: F401
from . import memplan  # noqa: F401
from . import recompile  # noqa: F401
from . import typecheck  # noqa: F401
from . import wellformed  # noqa: F401
from .diagnostics import (CODES, Diagnostic, Severity,  # noqa: F401
                          apply_baseline, codes_table, count_by_severity,
                          format_diagnostics, load_baseline,
                          sort_diagnostics, write_baseline)
from .memplan import (MemEstimate, estimate_program_memory,  # noqa: F401
                      format_bytes, infer_batch, parse_bytes)
from .pass_base import (ITEM_13, AnalysisPass, PassContext,  # noqa: F401
                        default_passes, get_pass, register_pass,
                        registered_passes, run_passes, split_strategy)

#: the JAX package's names that belong to ROADMAP item 13
_ITEM_13_NAMES = ("distributed", "shardplan", "strategy_from_dict",
                  "search_plans", "SearchResult", "ShardPlan")


def __getattr__(name):
    if name in _ITEM_13_NAMES:
        raise ImportError(f"paddle_tpu_torch.analysis.{name}: {ITEM_13}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class VerificationError(RuntimeError):
    """Raised by verify_or_raise / PADDLE_TPU_VALIDATE=raise: the program
    has error-severity findings. ``diagnostics`` holds every finding."""

    def __init__(self, message: str, diagnostics: List[Diagnostic]):
        super().__init__(message)
        self.diagnostics = diagnostics


def verify(program: Program,
           feed_names: Optional[Sequence[str]] = None,
           fetch_names: Optional[Sequence[str]] = None,
           passes: Optional[Sequence[str]] = None,
           strategy=None, mem_budget: Optional[int] = None,
           batch: Optional[int] = None,
           fuse_k: Optional[int] = None,
           auto_shard: bool = False) -> List[Diagnostic]:
    """Run the analysis pipeline over ``program``; return sorted findings.

    ``feed_names``/``fetch_names`` sharpen the analysis when the run intent
    is known (Executor.run passes both): fetch targets switch on dead-op
    liveness and fetch-reachability, feeds tighten the unread-feed check.
    Without them the checks degrade gracefully (is_data vars are assumed
    feedable, liveness is skipped).

    ``mem_budget`` (bytes) adds the PT05x static peak-memory planner to the
    pipeline and errors (PT051) when the estimate exceeds it; ``batch``
    resolves dynamic (-1) dims for that accounting (without it the planner
    assumes batch 1 and says so, PT052).

    ``fuse_k`` declares fused intent (Executor.run_fused passes its K): the
    PT03x recompile lint then flags the churn fusion adds (PT034).

    ``strategy`` and ``auto_shard=True`` raise NotImplementedError: the
    PT04x distributed checks and the PT07x planner are ROADMAP item 13's.
    """
    if strategy is not None or auto_shard:
        what = "auto_shard=True" if auto_shard else \
            f"strategy={type(strategy).__name__}"
        raise NotImplementedError(f"{what}: {ITEM_13}")
    # supplying a budget means the caller wants that check's verdict:
    # engage the owning pass even under an explicit --passes subset (a CI
    # gate narrowing passes must not silently lose the PT051 check)
    if mem_budget is not None:
        passes = list(passes) if passes is not None else default_passes()
        if "memplan" not in passes:
            passes = passes + ["memplan"]
    return sort_diagnostics(run_passes(program, passes=passes,
                                       feed_names=feed_names,
                                       fetch_names=fetch_names,
                                       mem_budget=mem_budget, batch=batch,
                                       fuse_k=fuse_k))


def verify_or_raise(program: Program,
                    feed_names: Optional[Sequence[str]] = None,
                    fetch_names: Optional[Sequence[str]] = None,
                    passes: Optional[Sequence[str]] = None,
                    strategy=None, mem_budget: Optional[int] = None,
                    batch: Optional[int] = None) -> List[Diagnostic]:
    """verify(), raising VerificationError if any error-severity finding."""
    diags = verify(program, feed_names=feed_names, fetch_names=fetch_names,
                   passes=passes, strategy=strategy, mem_budget=mem_budget,
                   batch=batch)
    errors = [d for d in diags if d.severity == Severity.ERROR]
    if errors:
        raise VerificationError(
            "program verification failed:\n" +
            format_diagnostics(errors, with_stack=True), diags)
    return diags
