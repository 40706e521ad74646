"""Dataflow pass: liveness vs the fetch targets, hazards, reachability (the
port's copy of ``paddle_tpu/analysis/dataflow.py``).

Liveness reuses the executor's prune semantics (Program._prune /
reference framework/prune.cc): an op is live if its outputs reach a fetch
target -- with two additions prune doesn't need but a *verifier* must make
to avoid calling a training program dead:

- writes to persistable vars are live (they become ``new_state`` and land
  in the Scope: optimizer updates, batch-norm stat writes);
- side-effecting op types (print/assert/host-table pushes) are live.

Sub-block reads count as reads of the referencing op, exactly as in
Program._prune's op_reads, so a While whose body consumes an outer temp
keeps that temp's producer live.
"""
from __future__ import annotations

from typing import Dict, List, Set

from .diagnostics import Diagnostic
from .pass_base import (AnalysisPass, PassContext, op_input_names,
                        op_output_names, register_pass, sub_block_indices)

#: op types that must never be pruned/reported dead: they act on the world
#: (stdout, the host-side embedding tables) rather than on the dataflow.
SIDE_EFFECT_OPS = frozenset({
    "print", "assert", "host_table_push", "host_table_init",
})

#: the op types the JAX package's ``ops.collective.is_collective`` names (the
#: keys of its COLLECTIVE_OPS; their port is ROADMAP item 13's). They are
#: side-effecting too -- every rank of the axis must execute the same
#: collective sequence, so a psum whose output feeds only a stage boundary
#: is NOT dead: pruning it on one rank desynchronizes the others.
COLLECTIVE_OPS = frozenset({
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allreduce_avg", "c_allgather", "c_reducescatter",
    "c_broadcast", "alltoall", "collective_permute", "temporal_pipeline",
    "reshard",
})


def _is_side_effecting(op_type: str) -> bool:
    return op_type in SIDE_EFFECT_OPS or op_type in COLLECTIVE_OPS


def op_reads(program, op) -> List[str]:
    """Input names of ``op`` plus outer-var reads of any sub-block it
    references, transitively (mirrors Program._prune.op_reads)."""
    reads = list(op_input_names(op))
    stack = list(sub_block_indices(op, program))
    seen: Set[int] = set()
    while stack:
        bi = stack.pop()
        if bi in seen:
            continue
        seen.add(bi)
        produced: Set[str] = set()
        for sop in program.blocks[bi].ops:
            for n in op_input_names(sop):
                if n not in produced:
                    reads.append(n)
            produced.update(op_output_names(sop))
            stack.extend(sub_block_indices(sop, program))
    return reads


@register_pass
class DataflowPass(AnalysisPass):
    name = "dataflow"

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        prog = ctx.program
        gb = prog.global_block()
        persistable = {n for b in prog.blocks
                       for n, v in b.vars.items() if v.persistable}

        # reads of each global-block var name: (op idx, names read); sub-block
        # reads attribute to the referencing op
        reads_at: List[List[str]] = [op_reads(prog, op) for op in gb.ops]
        read_anywhere: Set[str] = set()
        for names in reads_at:
            read_anywhere.update(names)

        produced: Set[str] = set()
        for op in gb.ops:
            produced.update(op_output_names(op))

        self._check_fetches(ctx, diags, gb, produced)
        live = self._live_ops(ctx, gb, persistable, reads_at)
        self._check_dead_ops(ctx, diags, gb, live)
        self._check_unused_outputs(ctx, diags, gb, persistable,
                                   read_anywhere, live)
        self._check_unread_feeds(ctx, diags, read_anywhere)
        for b in prog.blocks:
            # the global block's (expensive, sub-block-transitive) reads
            # were already computed above; sub-blocks compute their own
            self._check_hazards(ctx, diags, b, persistable,
                                reads_at if b is gb else None)
        return diags

    # ------------------------------------------------------------------
    def _check_fetches(self, ctx, diags, gb, produced: Set[str]):
        if not ctx.fetch_names:
            return
        feedable = ctx.feedable()
        for n in ctx.fetch_names:
            if n in produced or n in feedable:
                continue
            diags.append(Diagnostic(
                "PT012", f"fetch target {n!r} is never produced by the "
                         f"program and is not a feed or persistable var "
                         f"(Executor.run would raise)", var=n,
                block_idx=gb.idx))

    def _live_ops(self, ctx, gb, persistable, reads_at) -> Set[int]:
        """Indices of live global-block ops, backward from the fetch
        targets + state writes + side effects (None = liveness unknown,
        no fetch targets given)."""
        if ctx.fetch_names is None:
            return None
        needed: Set[str] = set(ctx.fetch_names)
        live: Set[int] = set()
        for i in range(len(gb.ops) - 1, -1, -1):
            op = gb.ops[i]
            outs = op_output_names(op)
            if (any(n in needed for n in outs)
                    or any(n in persistable for n in outs)
                    or _is_side_effecting(op.type)):
                live.add(i)
                needed.update(reads_at[i])
        return live

    def _check_dead_ops(self, ctx, diags, gb, live):
        if live is None:
            return
        for i, op in enumerate(gb.ops):
            if i in live:
                continue
            diags.append(Diagnostic.for_op(
                "PT010", f"op contributes to no fetch target "
                         f"({ctx.fetch_names!r}) and writes no persistable "
                         f"state -- it would be pruned or wasted work",
                gb, op))

    def _check_unused_outputs(self, ctx, diags, gb, persistable,
                              read_anywhere, live):
        fetches = set(ctx.fetch_names or ())
        for i, op in enumerate(gb.ops):
            if live is not None and i not in live:
                continue  # the dead-op finding covers every output already
            for n in op_output_names(op):
                if (n in read_anywhere or n in fetches or n in persistable):
                    continue
                if ctx.fetch_names is None:
                    # without fetch intent any output might be fetched;
                    # only unread AND undeclared-as-fetchable is notable
                    msg = (f"output {n!r} is never read by any op "
                           f"(may still be fetched at run time)")
                else:
                    msg = (f"output {n!r} is never read, fetched, or "
                           f"persisted")
                diags.append(Diagnostic.for_op("PT011", msg, gb, op, var=n))

    def _check_unread_feeds(self, ctx, diags, read_anywhere):
        prog = ctx.program
        fetches = set(ctx.fetch_names or ())
        names = (ctx.feed_names if ctx.feed_names is not None else
                 [n for b in prog.blocks for n, v in b.vars.items()
                  if v.is_data])
        for n in names:
            if n in read_anywhere or n in fetches:
                continue
            diags.append(Diagnostic(
                "PT015", f"feed var {n!r} is never read by the program "
                         f"(stale feed entry or dead input pipeline?)",
                var=n))

    # ------------------------------------------------------------------
    def _check_hazards(self, ctx, diags, block, persistable,
                       reads_at=None):
        """PT013 write-after-write (overwrite before any read) and PT014
        same-op read+write of a non-persistable name, per block.
        ``reads_at`` reuses the per-op (sub-block-transitive) reads the
        liveness stage already computed for this block."""
        writers: Dict[str, List[int]] = {}
        readers: Dict[str, List[int]] = {}
        for i, op in enumerate(block.ops):
            rd = (reads_at[i] if reads_at is not None else
                  op_reads(ctx.program, op)
                  if sub_block_indices(op, ctx.program)
                  else op_input_names(op))
            for n in rd:
                readers.setdefault(n, []).append(i)
            for n in op_output_names(op):
                writers.setdefault(n, []).append(i)
            ins = set(op_input_names(op))
            for n in set(op_output_names(op)):
                if n in ins and n not in persistable:
                    diags.append(Diagnostic.for_op(
                        "PT014", f"op reads and writes {n!r} in place; "
                                 f"fine under functional lowering, but "
                                 f"the pre-write value is gone for later "
                                 f"ops", block, op, var=n))
        for n, ws in writers.items():
            rs = readers.get(n, [])
            for w1, w2 in zip(ws, ws[1:]):
                # a read at w2 itself happens before the write (trace_block
                # binds inputs first), so it rescues the earlier write
                if not any(w1 < r <= w2 for r in rs):
                    diags.append(Diagnostic.for_op(
                        "PT013", f"{n!r} written at op #{w1} "
                                 f"({block.ops[w1].type}) is overwritten "
                                 f"at op #{w2} before any read", block,
                        block.ops[w2], var=n))
