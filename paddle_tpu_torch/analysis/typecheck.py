"""Type/shape consistency pass: re-derive shapes, compare to declarations
(the port's copy of ``paddle_tpu/analysis/typecheck.py``).

Propagates ``registry.infer_shape`` over a structural CLONE of the program
(op order, block by block) and reports where the inferred output
dtype/shape disagrees with what the original program declares. In the
port, inference runs each op's lowering on ``torch.device("meta")``
tensors (``core/registry.py``), as the JAX package runs it under
``jax.eval_shape``; at run time these mismatches surface as dtype errors
in a lowering or a kernel (the executor's ``check_dtype`` flag names
exactly this hazard); at lint time they are PT020/PT021 with op
attribution.

The clone matters twice over: inference mutates var metadata (it would
corrupt the program under analysis), and running it over the clone
propagates downstream -- op k+1 is checked against op k's *inferred*
output, so a single upstream drift is caught at its source, not as a
cascade.

Ops that reference sub-blocks are skipped: their lowerings need a live
block runner (LowerCtx.block_runner is None under meta inference), same as
at build time where the control-flow DSL appends them with
infer_shape=False.
Inference *failure* on an ordinary op is PT022 (warn, not error: a number
of builder paths append with infer_shape=False precisely because the
abstract path cannot evaluate them, and a lint must not invent failures
the runtime never sees).
"""
from __future__ import annotations

from typing import List

from ..core import registry
from ..framework import Program
from .diagnostics import Diagnostic
from .pass_base import (AnalysisPass, PassContext, block_attr_indices,
                        register_pass)
from .pass_base import EMPTY_VAR


def _shape_compatible(declared: tuple, inferred: tuple) -> bool:
    """-1 is a wildcard on either side; a declared empty shape () is the
    create_var default, i.e. 'unspecified', and matches anything."""
    if declared == ():
        return True
    if len(declared) != len(inferred):
        return False
    return all(d == -1 or i == -1 or d == i
               for d, i in zip(declared, inferred))


@register_pass
class TypeShapePass(AnalysisPass):
    name = "typecheck"

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        diags: List[Diagnostic] = []
        orig = ctx.program
        try:
            clone = Program.from_dict(orig.to_dict())
        except Exception as e:
            diags.append(Diagnostic(
                "PT022", f"program is not cloneable for shape propagation "
                         f"({type(e).__name__}: {e})"))
            return diags
        last_writer = self._last_writers(orig)
        for ob, cb in zip(orig.blocks, clone.blocks):
            for i, (oop, cop) in enumerate(zip(ob.ops, cb.ops)):
                if not registry.is_registered(cop.type):
                    continue  # PT004 (wellformed) already owns this
                if block_attr_indices(cop):
                    continue  # control flow: no block runner at lint time
                try:
                    registry.infer_shape(cop, cb)
                except Exception as e:
                    msg = str(e)
                    if len(msg) > 300:
                        msg = msg[:300] + "..."
                    diags.append(Diagnostic.for_op(
                        "PT022", f"shape inference failed: "
                                 f"{type(e).__name__}: {msg}", ob, oop))
                    continue
                self._compare(diags, ob, oop, cb, cop,
                              last_writer, (ob.idx, i))
        return diags

    @staticmethod
    def _last_writers(program):
        """resolved-Variable identity -> (block idx, op idx) of its last
        *inference-visible* writer. A var's declared metadata reflects the
        last build-time inference that wrote it (a While carry is written
        by its init op, then re-inferred by the body's assign); comparing
        any earlier writer against that final declaration would invent
        mismatches. Keyed by the Variable object the write resolves to
        (find_var_recursive from the writing block), NOT the bare name: a
        sub-block local that shadows an outer name updates its own
        metadata, and must not suppress checking of the outer var's
        writer."""
        last = {}
        for b in program.blocks:
            for i, op in enumerate(b.ops):
                if not registry.is_registered(op.type) \
                        or block_attr_indices(op):
                    continue
                for names in op.outputs.values():
                    for n in names:
                        if n != EMPTY_VAR:
                            v = b.find_var_recursive(n)
                            key = id(v) if v is not None else n
                            last[key] = (b.idx, i)
        return last

    @staticmethod
    def _writer_key(ob, n):
        v = ob.find_var_recursive(n)
        return id(v) if v is not None else n

    def _compare(self, diags, ob, oop, cb, cop, last_writer, here):
        for slot, names in oop.outputs.items():
            for n in names:
                if n == EMPTY_VAR or \
                        last_writer.get(self._writer_key(ob, n)) != here:
                    continue
                ov = ob.find_var_recursive(n)
                cv = cb.find_var_recursive(n)
                if ov is None or cv is None or ov.is_data:
                    # undeclared output (env-only name) or a feed entry
                    # inference never overwrites: nothing to compare
                    continue
                if ov.dtype != cv.dtype:
                    diags.append(Diagnostic.for_op(
                        "PT020", f"output {n!r} declared {ov.dtype} but "
                                 f"shape inference derives {cv.dtype} "
                                 f"(would retrace or fail at XLA compile)",
                        ob, oop, var=n))
                if not _shape_compatible(tuple(ov.shape), tuple(cv.shape)):
                    diags.append(Diagnostic.for_op(
                        "PT021", f"output {n!r} declared shape "
                                 f"{list(ov.shape)} but shape inference "
                                 f"derives {list(cv.shape)}", ob, oop,
                        var=n))
