"""Well-formedness pass: vars resolve, ops exist, block graph is sane (the
port's copy of ``paddle_tpu/analysis/wellformed.py``).

Catches at lint time what the executor's op loop surfaces as mid-run
KeyErrors (trace_block's missing input, registry.get "op type not
registered") -- plus structural rot no runtime check sees until it
wedges: sub-block cycles and dangling ``*_block`` indices.

Scoping model mirrors the trace env: a name is readable at op i if it was
fed (``is_data`` / explicit feed list), is persistable state, or was
produced by an earlier op of the same block -- or, inside a sub-block, by
any op preceding the referencing control-flow op in the enclosing block
(sub-blocks see the enclosing env; see core/executor.py's SubBlockRunner).
"""
from __future__ import annotations

from typing import List, Set

from ..core import registry
from .diagnostics import Diagnostic
from .pass_base import (AnalysisPass, PassContext, block_attr_indices,
                        op_input_names, op_output_names, register_pass,
                        sub_block_indices)

#: attrs whose list-of-names values a control-flow op BINDS into its
#: sub-block's env before running it (ops/control_flow.py: while
#: zips x_names over X, scan zips carry_names/x_names/static_names over
#: Init/X/Static, remat_segment zips in_names over X). Those names exist
#: in the sub-block without any op producing them.
_ENV_BINDING_ATTRS = ("x_names", "carry_names", "static_names", "in_names")


def injected_names(op) -> Set[str]:
    out: Set[str] = set()
    for a in _ENV_BINDING_ATTRS:
        v = op.attr(a)
        if isinstance(v, (list, tuple)):
            out.update(n for n in v if isinstance(n, str))
    return out


@register_pass
class WellFormednessPass(AnalysisPass):
    name = "wellformed"

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        self._check_op_types(ctx, diags)
        self._check_block_attrs(ctx, diags)
        cyclic = self._check_cycles(ctx, diags)
        self._check_shadowing(ctx, diags)
        for idx in ctx.orphan_blocks():
            diags.append(Diagnostic(
                "PT007", f"block {idx} is not referenced by any op "
                         f"(orphaned by a clone/prune rewrite?)",
                block_idx=idx))
        self._check_availability(ctx, diags, cyclic)
        return diags

    # ------------------------------------------------------------------
    def _check_op_types(self, ctx, diags):
        for b in ctx.program.blocks:
            for op in b.ops:
                if not registry.is_registered(op.type):
                    diags.append(Diagnostic.for_op(
                        "PT004", f"op type {op.type!r} is not registered "
                                 f"(no lowering in paddle_tpu_torch/ops/)", b, op))

    def _check_block_attrs(self, ctx, diags):
        nblocks = len(ctx.program.blocks)
        for b in ctx.program.blocks:
            for op in b.ops:
                for attr, v in block_attr_indices(op):
                    if isinstance(v, bool) or not isinstance(v, int) \
                            or not 0 <= v < nblocks:
                        diags.append(Diagnostic.for_op(
                            "PT005", f"attr {attr}={v!r} does not name a "
                                     f"block (program has {nblocks} "
                                     f"blocks)", b, op))

    def _check_cycles(self, ctx, diags) -> Set[int]:
        """Blocks involved in a reference cycle (availability checks skip
        them -- one clear finding beats a cascade)."""
        prog = ctx.program
        edges = {b.idx: sorted({si for op in b.ops
                                for si in sub_block_indices(op, prog)})
                 for b in prog.blocks}
        cyclic: Set[int] = set()
        state = {}  # 0 visiting, 1 done

        def visit(i, path):
            if state.get(i) == 1:
                return
            if state.get(i) == 0:
                cycle = path[path.index(i):]
                cyclic.update(cycle)
                diags.append(Diagnostic(
                    "PT006", "sub-block cycle via *_block attrs: " +
                             " -> ".join(str(x) for x in cycle + [i]),
                    block_idx=i))
                return
            state[i] = 0
            for j in edges.get(i, ()):
                visit(j, path + [i])
            state[i] = 1

        for b in prog.blocks:
            visit(b.idx, [])
        return cyclic

    def _check_shadowing(self, ctx, diags):
        for b in ctx.program.blocks[1:]:
            p = b.parent
            if p is None:
                continue
            for n in b.vars:
                if p.find_var_recursive(n) is not None:
                    diags.append(Diagnostic(
                        "PT003", f"var {n!r} declared in block {b.idx} "
                                 f"shadows an outer declaration",
                        block_idx=b.idx, var=n))

    # ------------------------------------------------------------------
    def _check_availability(self, ctx, diags, cyclic: Set[int]):
        """PT001/PT002 by walking blocks the way trace_block consumes them."""
        prog = ctx.program
        roots = ctx.feedable()
        # first producer per (block idx, name), for the use-before-def case
        first_prod = {}
        for b in prog.blocks:
            for i, op in enumerate(b.ops):
                for n in op_output_names(op):
                    first_prod.setdefault((b.idx, n), i)
        seen: Set[tuple] = set()  # dedupe blocks referenced more than once

        def declared(name: str, block) -> bool:
            return block.find_var_recursive(name) is not None

        def walk(bidx: int, avail: Set[str], stack: Set[int]):
            if bidx in cyclic or bidx in stack:
                return
            block = prog.blocks[bidx]
            for i, op in enumerate(block.ops):
                for n in op_input_names(op):
                    if n in avail:
                        continue
                    key = (bidx, i, n)
                    if key in seen:
                        continue
                    seen.add(key)
                    later = first_prod.get((bidx, n))
                    if later is not None and later == i:
                        # the op reads its own first write: at bind time
                        # the input has no value yet
                        diags.append(Diagnostic.for_op(
                            "PT002", f"var {n!r} is read by the same op "
                                     f"that first produces it (in-place "
                                     f"read of an uninitialized var)",
                            block, op, var=n))
                    elif later is not None and later > i:
                        diags.append(Diagnostic.for_op(
                            "PT002", f"var {n!r} is read before op "
                                     f"#{later} ({block.ops[later].type}) "
                                     f"produces it", block, op, var=n))
                    elif declared(n, block):
                        diags.append(Diagnostic.for_op(
                            "PT001", f"var {n!r} is declared but nothing "
                                     f"feeds or produces it (not is_data, "
                                     f"not persistable)", block, op, var=n))
                    else:
                        diags.append(Diagnostic.for_op(
                            "PT001", f"var {n!r} is not defined in block "
                                     f"{bidx} or any ancestor", block, op,
                            var=n))
                    avail.add(n)  # report each missing name once per block
                for si in sub_block_indices(op, prog):
                    walk(si, avail | injected_names(op), stack | {bidx})
                avail.update(op_output_names(op))

        # orphan blocks are never walked: they are dead code (PT007) and the
        # enclosing env that would feed them is unknowable
        walk(0, set(roots), set())
