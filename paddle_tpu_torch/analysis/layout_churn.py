"""Layout-churn lint (PT060): blame a step's copy kernels on IR ops.

The port's counterpart of ``paddle_tpu/analysis/layout_churn.py``. The JAX
pass reads the attribution walk of XLA's optimized HLO, which blames each
copy / transpose instruction's *bytes* on the (producer, consumer) IR op
pair around it. The port has no HLO: its attribution
(``observability.attribution``, a step's eager warm-up profiled at a capture
miss when armed) places every kernel under the IR op whose range launched
it and buckets its *device time* by category, ``copy`` among them (copies,
casts, concatenations, transposes, gathers). So PT060 here names the IR
ops whose ranges hold the most ``copy`` device time in a step.

Floors: an op is reported when its copy time is at least
``MIN_OP_SECONDS`` (10 us) and at least ``MIN_OP_FRACTION`` (1%) of the
step's attributed device time -- the JAX pass's 1% floor, on device time
instead of modelled bytes -- and at most ``TOP_OPS`` (5) ops, the most
copy time first.

Registered opt-in (``default=False``) because it can only report on a
program that has *already run* with attribution armed
(``PADDLE_TPU_OBS=1`` / ``PADDLE_TPU_OBS_ATTRIB=1`` /
``attribution.arm_capture``): ``verify()`` normally runs before the first
run, where there is nothing to read. When named explicitly but no
attribution exists, it emits nothing.
"""
from __future__ import annotations

import re
from typing import List

from .diagnostics import Diagnostic
from .pass_base import AnalysisPass, PassContext, register_pass

#: an op is worth warning about when its copy time clears both floors
MIN_OP_SECONDS = 10e-6
MIN_OP_FRACTION = 0.01
TOP_OPS = 5

#: ``attribution.ir_key``'s ``type#i`` (block 0) or ``type#b:i``
_IR_KEY = re.compile(r"^(.*)#(?:(\d+):)?(\d+)$")


def op_ref(key: str):
    """'cast#12' -> ('cast', 0, 12); 'mul#2:3' -> ('mul', 2, 3); anything
    else (the unattributed row) -> None."""
    m = _IR_KEY.match(key)
    if m is None:
        return None
    return m.group(1), int(m.group(2) or 0), int(m.group(3))


@register_pass(default=False)
class LayoutChurnPass(AnalysisPass):
    name = "layout_churn"

    def run(self, ctx: PassContext) -> List[Diagnostic]:
        from ..observability import attribution
        attrib = attribution.lookup_program(ctx.program)
        if attrib is None or not attrib.attributed_device_seconds:
            return []
        floor = max(MIN_OP_SECONDS,
                    MIN_OP_FRACTION * attrib.attributed_device_seconds)
        ranked = sorted(((row["categories"].get("copy", 0.0), key, row)
                         for key, row in attrib.per_ir.items()
                         if op_ref(key) is not None),
                        key=lambda t: (-t[0], t[1]))
        diags: List[Diagnostic] = []
        for secs, key, row in ranked[:TOP_OPS]:
            if secs < floor:
                break
            op_type, block_idx, op_idx = op_ref(key)
            copies = sorted(n for n in row["names"]
                            if attribution.kernel_category(n) == "copy")
            diags.append(Diagnostic(
                "PT060",
                f"{key} spends {secs * 1e3:.3f} ms of device time a step in "
                f"copy kernels ({len(copies)} kind(s): "
                f"{', '.join(copies[:3])}{', ...' if len(copies) > 3 else ''}; "
                f"{secs / attrib.attributed_device_seconds:.1%} of the "
                f"step's attributed device time); consider the conv2d.layout "
                f"autotune or keeping the producer in the consumer's layout "
                f"and dtype",
                block_idx=block_idx, op_idx=op_idx, op_type=op_type))
        return diags
