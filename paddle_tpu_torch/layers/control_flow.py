"""Control-flow DSL (the port's copy of ``Scan``, ``_outer_reads``,
``increment`` and the comparison layers of
``paddle_tpu/layers/control_flow.py``).

A ``Scan`` body is built into a sub-block (``Program._create_block``) and
lowers to the ``scan`` op (``ops/control_flow.py``). Every outer variable
the body reads is a declared ``Static`` input of the op, never reached by
closure: the generic grad differentiates the op's declared inputs, and the
executor reads a program's persistable state from its global block's ops.
"""
from __future__ import annotations

from ..framework import default_main_program
from ..layer_helper import LayerHelper


def _outer_reads(program, root_idx, parent, exclude=()):
    """Outer variables read inside block ``root_idx`` (and the blocks its ops
    hold), in first-read order: names that resolve in ``parent`` or its
    ancestors and are not local to the body."""
    order, seen = [], set(exclude)

    def walk(idx, local):
        blk = program.blocks[idx]
        local = local | set(blk.vars)
        for op in blk.ops:
            for n in op.input_arg_names():
                if n in local or n in seen or n == "@EMPTY@":
                    continue
                if parent.find_var_recursive(n) is not None:
                    seen.add(n)
                    order.append(n)
            for a in ("sub_block", "else_block"):
                si = op.attr(a, -1)
                if isinstance(si, int) and 0 <= si < len(program.blocks) and si != idx:
                    walk(si, local)

    walk(root_idx, set())
    return order


def _cmp_layer(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type)
        if cond is None:
            cond = helper.create_variable_for_type_inference("bool", stop_gradient=True)
        helper.append_op(op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]})
        return helper.main_program.current_block().var(cond.name)
    layer.__name__ = op_type
    return layer



def increment(x, value=1.0, in_place=True):
    """x + value, written back to x itself unless ``in_place`` is False."""
    helper = LayerHelper("increment")
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op("increment", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"step": float(value)})
    return helper.main_program.current_block().var(out.name)


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp_layer("less_than")(x, y, cond)


less_equal = _cmp_layer("less_equal")
greater_than = _cmp_layer("greater_than")
greater_equal = _cmp_layer("greater_equal")
equal = _cmp_layer("equal")
not_equal = _cmp_layer("not_equal")


class Scan:
    """A recurrence over a static number of steps, lowered to the ``scan``
    op::

        scan = Scan()
        with scan.step():
            x_t = scan.step_input(x_seq)          # [B, T, D] -> [B, D] a step
            h_prev = scan.memory(init=h0)         # loop state
            h = some_layers(x_t, h_prev)
            scan.update_memory(h_prev, h)
            scan.step_output(h)
        outs = scan()                             # [B, T, H]

    ``scan.finals`` holds the final memories, in ``memory()`` order.
    """

    def __init__(self, time_major=False):
        self.time_major = time_major
        self._seq_inputs = []   # (outer var, inner name)
        self._memories = []     # [init outer var, inner name, update name]
        self._outputs = []      # inner names

    def step(self):
        scan = self

        class _Guard:
            def __enter__(self):
                prog = default_main_program()
                scan._parent_block = prog.current_block()
                scan._sub = prog._create_block()
                return scan

            def __exit__(self, *exc):
                default_main_program()._rollback()
                return False

        return _Guard()

    def step_input(self, x):
        sub = default_main_program().current_block()
        t_axis = 0 if self.time_major else 1
        inner = sub.create_var(x.name + "@step",
                               tuple(s for i, s in enumerate(x.shape) if i != t_axis),
                               x.dtype)
        self._seq_inputs.append((x, inner.name))
        return inner

    def memory(self, init):
        sub = default_main_program().current_block()
        inner = sub.create_var(init.name + "@mem", init.shape, init.dtype)
        self._memories.append([init, inner.name, None])
        return inner

    def update_memory(self, mem, new_val):
        for m in self._memories:
            if m[1] == mem.name:
                m[2] = new_val.name
                return
        raise ValueError(f"{mem.name} is not a Scan memory")

    def step_output(self, o):
        self._outputs.append(o.name)

    def __call__(self):
        parent, sub = self._parent_block, self._sub
        # each memory takes its update at the end of an iteration
        for init, inner, update in self._memories:
            if update is None:
                raise ValueError(f"memory {inner} never updated")
            sub.append_op("assign", inputs={"X": [update]}, outputs={"Out": [inner]},
                          infer_shape=False)
        if not self._seq_inputs:
            raise ValueError("Scan requires at least one step_input to determine "
                             "the sequence length")
        t_axis = 0 if self.time_major else 1
        T = self._seq_inputs[0][0].shape[t_axis]
        outs = []
        for n in self._outputs:
            step_shape = tuple(sub.var(n).shape)
            shape = ((T,) + step_shape if self.time_major
                     else step_shape[:1] + (T,) + step_shape[1:])
            outs.append(parent.create_var(n + "@scan_out", shape, sub.var(n).dtype))
        finals = [parent.create_var(m[1] + "@final", sub.var(m[1]).shape, sub.var(m[1]).dtype)
                  for m in self._memories]
        self.finals = [parent.var(f.name) for f in finals]
        already = ({m[0].name for m in self._memories}
                   | {si[0].name for si in self._seq_inputs})
        statics = _outer_reads(parent.program, sub.idx, parent, exclude=already)
        parent.append_op(
            "scan",
            inputs={"Init": [m[0] for m in self._memories],
                    "X": [si[0] for si in self._seq_inputs],
                    "Static": list(statics)},
            outputs={"Out": outs, "FinalCarry": finals},
            attrs={"sub_block": sub.idx,
                   "carry_names": [m[1] for m in self._memories],
                   "x_names": [si[1] for si in self._seq_inputs],
                   "out_names": list(self._outputs),
                   "static_names": list(statics),
                   "time_major": self.time_major},
            infer_shape=False)
        if len(outs) == 1:
            return parent.var(outs[0].name)
        return [parent.var(o.name) for o in outs]
