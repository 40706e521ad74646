"""Control-flow DSL (the port's copy of ``paddle_tpu/layers/control_flow.py``:
``While``, ``Switch``, ``IfElse``, ``Scan`` and its alias ``StaticRNN``,
``DynamicRNN``, the TensorArray layers, ``increment``, the comparisons,
``is_empty``, ``Print`` and ``reorder_lod_tensor_by_rank``).

A body is built into a sub-block (``Program._create_block``) and lowers to
a control-flow op (``ops/control_flow.py``): ``While`` to ``while``,
``Switch`` to a chain of ``conditional_block``, ``Scan`` / ``DynamicRNN``
to ``scan``; ``IfElse`` runs both branches over the whole batch and merges
each output pair with ``where``. Every outer variable a body reads is a
declared input of its op, never reached by closure: the generic grad
differentiates the op's declared inputs, and the executor reads a
program's persistable state from its global block's ops. Outer variables
a ``While`` or ``Switch`` body writes are found by walking it
(``_outer_writes``) and become the op's carries / outputs, under their own
names. A TensorArray is a fixed-capacity stacked buffer (the capacity is
the enclosing ``While``'s ``max_iters``).
"""
from __future__ import annotations

from .. import unique_name
from ..framework import convert_dtype, default_main_program
from ..layer_helper import LayerHelper
from . import tensor

__all__ = ["increment", "array_write", "array_read", "array_length",
           "create_array", "less_than", "equal", "greater_than",
           "greater_equal", "less_equal", "not_equal", "is_empty", "Print",
           "Scan", "StaticRNN", "While", "Switch", "IfElse", "DynamicRNN",
           "reorder_lod_tensor_by_rank"]


def _sub_blocks(program, op, idx):
    for a in ("sub_block", "else_block"):
        si = op.attr(a, -1)
        if isinstance(si, int) and 0 <= si < len(program.blocks) and si != idx:
            yield si


def _outer_writes(program, root_idx, parent):
    """Outer variables written inside block ``root_idx`` (and the blocks its
    ops hold), in first-write order: a ``While`` body's carries, a
    ``Switch`` branch's outputs. A name local to the body does not count."""
    order, seen = [], set()

    def walk(idx, local):
        blk = program.blocks[idx]
        local = local | set(blk.vars)
        for op in blk.ops:
            for si in _sub_blocks(program, op, idx):
                walk(si, local)
            for n in op.output_arg_names():
                if n in local or n in seen or n == "@EMPTY@":
                    continue
                if parent.find_var_recursive(n) is not None:
                    seen.add(n)
                    order.append(n)

    walk(root_idx, set())
    return order


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
            for si in _sub_blocks(program, op, idx):
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


def create_array(dtype, capacity=None, like=None):
    """A TensorArray: a fixed-capacity stacked buffer [capacity, *elem]
    (pass the enclosing ``While``'s ``max_iters``). The first
    ``array_write`` fixes the element's shape; when it writes a value with
    a dynamic batch dim computed inside a loop body, pass ``like`` (an
    outer variable with the same batch dim) to size the zero buffer."""
    block = default_main_program().current_block()
    name = unique_name.generate("tensor_array")
    arr = block.create_var(name, (), convert_dtype(dtype))
    arr.persistable = False
    arr.stop_gradient = False
    arr._ta_capacity = capacity
    arr._ta_like = like
    arr._ta_block = block
    arr._ta_initialized = False
    arr._ta_len_name = name + "@alen"
    alen = block.create_var(arr._ta_len_name, (1,), "int32")
    alen.stop_gradient = True
    block.append_op("fill_constant", outputs={"Out": [alen.name]},
                    attrs={"shape": [1], "dtype": "int32", "value": 0.0}, infer_shape=False)
    return arr


def _init_tensor_array(array, x):
    """The first write fixes the element's shape: the zero buffer is made in
    the array's creation block (before any enclosing ``While`` reads it)."""
    cap = getattr(array, "_ta_capacity", None)
    if cap is None:
        raise ValueError(
            f"TensorArray {array.name!r} needs a static capacity: create it with "
            f"layers.create_array(dtype, capacity=N) where N bounds the writes (e.g. "
            f"the While's max_iters)")
    blk = array._ta_block
    shape = (int(cap),) + tuple(x.shape)
    array.shape = shape
    dyn = [i for i, d in enumerate(x.shape) if d == -1]
    if dyn:
        ref = x
        if blk.find_var_recursive(x.name) is None:
            ref = getattr(array, "_ta_like", None)
            if ref is None:
                raise ValueError(
                    f"TensorArray {array.name!r}: first array_write value {x.name!r} has "
                    f"a dynamic batch dim but is computed inside a sub-block, so the "
                    f"array's zero buffer (in the creation block) cannot size it. Pass a "
                    f"batch reference at creation: layers.create_array(dtype, "
                    f"capacity=N, like=some_outer_var)")
        blk.append_op("fill_constant_batch_size_like", inputs={"Input": [ref.name]},
                      outputs={"Out": [array.name]},
                      attrs={"shape": list(shape), "dtype": array.dtype, "value": 0.0,
                             "input_dim_idx": dyn[0], "output_dim_idx": dyn[0] + 1},
                      infer_shape=False)
    else:
        blk.append_op("fill_constant", outputs={"Out": [array.name]},
                      attrs={"shape": list(shape), "dtype": array.dtype, "value": 0.0},
                      infer_shape=False)
    array._ta_initialized = True


def array_write(x, i, array=None):
    """Write ``x`` at index ``i``; inside a ``While`` body the array becomes
    one of the loop's carries."""
    if array is None:
        array = create_array(x.dtype)   # raises with the capacity's guidance
    if not getattr(array, "_ta_initialized", False):
        _init_tensor_array(array, x)
    block = default_main_program().current_block()
    block.append_op("array_write",
                    inputs={"Array": [array.name], "X": [x.name], "I": [i.name],
                            "ALen": [array._ta_len_name]},
                    outputs={"Out": [array.name], "OutLen": [array._ta_len_name]},
                    infer_shape=False)
    return array


def array_read(array, i):
    """Element ``i`` of ``array``."""
    block = default_main_program().current_block()
    out = block.create_var(unique_name.generate(array.name + "@read"),
                           tuple(array.shape[1:]), array.dtype)
    block.append_op("array_read", inputs={"Array": [array.name], "I": [i.name]},
                    outputs={"Out": [out.name]}, infer_shape=False)
    return out


def array_length(array):
    """The number of elements written (one past the largest index), int64."""
    blk = default_main_program().current_block()
    alen = (blk.find_var_recursive(array._ta_len_name)
            or array._ta_block.var(array._ta_len_name))
    return tensor.cast(alen, "int64")


class While:
    """A loop over a sub-block::

        i = layers.fill_constant([1], "float32", 0)
        limit = layers.fill_constant([1], "float32", 10)
        cond = layers.less_than(i, limit)
        w = layers.While(cond, max_iters=10)
        with w.block():
            ...                                   # the body writes loop vars in place
            layers.increment(i, in_place=True)
            layers.less_than(i, limit, cond=cond) # the body must rewrite cond

    The outer variables the body writes (nested sub-blocks included) are the
    loop's carries; after the loop their names hold the final values.
    ``max_iters`` bounds the trip count: the loop is then a masked loop of
    that many runs, differentiable and captured in a step's CUDA graph.
    Without it the condition is read on the host at each run: the program
    is not captured, and a gradient through the loop raises."""

    def __init__(self, cond, is_test=False, name=None, max_iters=None):
        if cond.dtype != "bool":
            raise TypeError(f"While cond must be bool, got {cond.dtype}")
        if tuple(cond.shape) not in ((1,), ()):
            raise TypeError(f"While cond must be scalar [1], got {cond.shape}")
        self.cond = cond
        self.max_iters = max_iters

    def block(self):
        w = self

        class _Guard:
            def __enter__(self):
                prog = default_main_program()
                w._parent = prog.current_block()
                w._sub = prog._create_block()
                return self

            def __exit__(self, exc_type, *exc):
                default_main_program()._rollback()
                if exc_type is None:
                    w._finalize()
                return False

        return _Guard()

    def _finalize(self):
        parent, sub = self._parent, self._sub
        carries = _outer_writes(parent.program, sub.idx, parent)
        if self.cond.name not in carries:
            raise ValueError(
                "While body never rewrites the condition var -- the loop would never "
                "terminate. End the body with e.g. layers.less_than(i, limit, cond=cond).")
        reads = _outer_reads(parent.program, sub.idx, parent, exclude=carries)
        # the op writes the carries' own names, so its inputs are copies taken
        # before it: a grad op that reran the loop from the carries' names would
        # start from their final values
        snaps = []
        for n in carries:
            v = parent.find_var_recursive(n)
            # after the loop the names are its outputs: clear the stop_gradient
            # their constant initialisers set, or backward prunes the path
            if v is not None and v.dtype in ("float32", "float64", "bfloat16", "float16"):
                v.stop_gradient = False
            sv = parent.create_var(unique_name.generate(n + "@while_in"),
                                   tuple(v.shape) if v is not None else (),
                                   v.dtype if v is not None else "float32")
            sv.stop_gradient = False
            parent.append_op("assign", inputs={"X": [n]}, outputs={"Out": [sv.name]},
                             infer_shape=False)
            snaps.append(sv.name)
        attrs = {"sub_block": sub.idx, "cond_name": self.cond.name,
                 "x_names": list(carries) + reads, "out_names": list(carries)}
        if self.max_iters is not None:
            attrs["max_iters"] = int(self.max_iters)
        parent.append_op("while", inputs={"X": snaps + reads}, outputs={"Out": list(carries)},
                         attrs=attrs, infer_shape=False)


class Switch:
    """First-match-wins cases (a piecewise learning-rate schedule's form)::

        with layers.Switch() as switch:
            with switch.case(cond1):
                layers.assign(v1, lr)
            with switch.default():
                layers.assign(v2, lr)

    A chain of ``conditional_block`` ops; a variable any branch assigns
    keeps its value when no branch fires. Not differentiable (``IfElse``
    is)."""

    def __init__(self, name=None):
        self._cases = []
        self._default = None
        self._inside = False

    def __enter__(self):
        self._parent = default_main_program().current_block()
        self._inside = True
        return self

    def __exit__(self, exc_type, *exc):
        self._inside = False
        if exc_type is None:
            self._finalize()
        return False

    def _branch(self, condition):
        sw = self

        class _Guard:
            def __enter__(self):
                if not sw._inside:
                    raise ValueError("Switch.case/default must be used inside "
                                     "'with Switch() as switch:'")
                sub = default_main_program()._create_block()
                if condition is None:
                    if sw._default is not None:
                        raise ValueError("Switch allows one default() only")
                    sw._default = sub
                else:
                    sw._cases.append((condition, sub))
                return self

            def __exit__(self, *exc):
                default_main_program()._rollback()
                return False

        return _Guard()

    def case(self, condition):
        if condition.dtype != "bool":
            raise TypeError(f"Switch.case cond must be bool, got {condition.dtype}")
        return self._branch(condition)

    def default(self):
        return self._branch(None)

    def _finalize(self):
        if not self._cases:
            raise ValueError("Switch needs at least one case()")
        parent = self._parent
        prog = parent.program
        outs = []
        branches = [b for _, b in self._cases]
        if self._default is not None:
            branches.append(self._default)
        for b in branches:
            for n in _outer_writes(prog, b.idx, parent):
                if n not in outs:
                    outs.append(n)
        # a nested level sees only its declared inputs: every later case's
        # condition and every variable a branch reads rides the X slot
        xs = list(outs)
        for cond, _ in self._cases[1:]:
            if cond.name not in xs:
                xs.append(cond.name)
        for b in branches:
            xs.extend(_outer_reads(prog, b.idx, parent, exclude=xs))
        next_else = self._default.idx if self._default is not None else -1
        for cond, blk in reversed(self._cases[1:]):
            wrapper = prog._create_block(parent_idx=parent.idx)
            wrapper.append_op("conditional_block", inputs={"Cond": [cond.name], "X": list(xs)},
                              outputs={"Out": list(outs)},
                              attrs={"sub_block": blk.idx, "else_block": next_else,
                                     "x_names": list(xs), "out_names": list(outs)},
                              infer_shape=False)
            prog._rollback()
            next_else = wrapper.idx
        cond0, blk0 = self._cases[0]
        parent.append_op("conditional_block", inputs={"Cond": [cond0.name], "X": list(xs)},
                         outputs={"Out": list(outs)},
                         attrs={"sub_block": blk0.idx, "else_block": next_else,
                                "x_names": list(xs), "out_names": list(outs)},
                         infer_shape=False)


class IfElse:
    """Branch on a mask: both branches run over the whole batch and each
    output pair merges with ``where(cond, true, false)`` (differentiable);
    ``input(x)`` returns x unsplit. cond is [B, 1] (a row each) or [1]::

        ie = layers.IfElse(cond)
        with ie.true_block():
            ie.output(ie.input(x) + 1)
        with ie.false_block():
            ie.output(ie.input(x) - 1)
        out, = ie()
    """

    def __init__(self, cond, name=None):
        if cond.dtype != "bool":
            raise TypeError(f"IfElse cond must be bool, got {cond.dtype}")
        self.cond = cond
        self._outs = {True: [], False: []}
        self._branch = None

    def _guard(self, val):
        ie = self

        class _Guard:
            def __enter__(self):
                ie._branch = val
                return self

            def __exit__(self, *exc):
                ie._branch = None
                return False

        return _Guard()

    def true_block(self):
        return self._guard(True)

    def false_block(self):
        return self._guard(False)

    def input(self, x):
        if self._branch is None:
            raise ValueError("IfElse.input() outside a true_block/false_block")
        return x

    def output(self, *outs):
        if self._branch is None:
            raise ValueError("IfElse.output() outside a true_block/false_block")
        self._outs[self._branch].extend(outs)

    def __call__(self):
        t, f = self._outs[True], self._outs[False]
        if len(t) != len(f):
            raise ValueError(f"IfElse branches produced {len(t)} vs {len(f)} "
                             f"outputs; they must match pairwise")
        from . import nn as _nn
        return [_nn.where(self.cond, a, b) for a, b in zip(t, f)]


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


class DynamicRNN:
    """A recurrence over padded sequences with per-row lengths: a ``Scan``
    over [B, T] with a validity mask, memories frozen and outputs zero once
    ``t >= length`` (the padded [B, T, D] input and a ``lengths`` [B] take
    the place of the reference's LoD)::

        drnn = layers.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(x_padded, lengths=seq_len)   # [B, D] a step
            prev = drnn.memory(shape=[H], value=0.0)
            h = layers.fc(w, H) + layers.fc(prev, H)
            drnn.update_memory(prev, h)
            drnn.output(h)
        hs = drnn()                                           # [B, T, H]
    """

    def __init__(self, name=None):
        self._scan = Scan(time_major=False)
        self._lengths = None
        self._mask = None
        self._t = None
        self._first_outer_x = None

    def block(self):
        rnn = self
        inner = self._scan.step()

        class _Guard:
            def __enter__(self):
                inner.__enter__()
                return rnn

            def __exit__(self, exc_type, *exc):
                if exc_type is None and rnn._t is not None:
                    nxt = increment(rnn._t, value=1.0, in_place=False)
                    rnn._scan.update_memory(rnn._t, nxt)
                return inner.__exit__(exc_type, *exc)

        return _Guard()

    def step_input(self, x, lengths=None):
        """x: a padded [B, T, ...] sequence; returns the [B, ...] step. Pass
        ``lengths`` ([B] int) once to mask."""
        if self._first_outer_x is None:
            self._first_outer_x = x
        inner = self._scan.step_input(x)
        if lengths is not None:
            if self._lengths is not None:
                raise ValueError("DynamicRNN lengths already set")
            self._lengths = lengths
            self._build_mask()
        return inner

    def static_input(self, x):
        """A non-sequence input, the same at every step."""
        return x

    def _build_mask(self):
        parent = self._scan._parent_block
        t0 = unique_name.generate("drnn_t0")
        parent.create_var(t0, (1,), "float32").stop_gradient = True
        parent.append_op("fill_constant", outputs={"Out": [t0]},
                         attrs={"shape": [1], "dtype": "float32", "value": 0.0},
                         infer_shape=False)
        self._t = self._scan.memory(parent.var(t0))
        from . import nn as _nn
        lens_f = _nn.reshape(tensor.cast(self._lengths, "float32"), [-1])
        self._mask = less_than(self._t, lens_f)   # [1] < [B] -> [B] bool

    def _masked(self, new, old):
        if self._mask is None:
            return new
        from . import nn as _nn
        cond = self._mask
        rank = len(new.shape)
        if rank > 1:
            cond = _nn.unsqueeze(cond, list(range(1, rank)))
        return _nn.where(cond, new, old)

    def memory(self, init=None, shape=None, value=0.0, dtype="float32", need_reorder=False):
        """Loop state: ``init`` (a [B, ...] variable) or ``shape`` and
        ``value`` for a constant one sized by the first step input's batch."""
        if init is None:
            if self._first_outer_x is None:
                raise ValueError("DynamicRNN.memory(shape=...) needs a prior step_input "
                                 "to size the batch dim")
            parent = self._scan._parent_block
            name = unique_name.generate("drnn_mem_init")
            full = [-1] + [int(d) for d in (shape or [])]
            parent.create_var(name, tuple(full), convert_dtype(dtype))
            parent.append_op("fill_constant_batch_size_like",
                             inputs={"Input": [self._first_outer_x.name]},
                             outputs={"Out": [name]},
                             attrs={"shape": full, "dtype": convert_dtype(dtype),
                                    "value": float(value), "input_dim_idx": 0,
                                    "output_dim_idx": 0},
                             infer_shape=False)
            init = parent.var(name)
        return self._scan.memory(init)

    def update_memory(self, mem, new):
        """Masked: a finished row keeps its last state."""
        self._scan.update_memory(mem, self._masked(new, mem))

    def output(self, *outputs):
        """Step outputs, zero past each row's length."""
        for o in outputs:
            if self._mask is not None:
                o = self._masked(o, tensor.zeros_like(o))
            self._scan.step_output(o)

    def __call__(self):
        return self._scan()


def is_empty(x, cond=None):
    """[1] bool: whether ``x`` has no elements, decided when the program runs
    (a -1 batch dim is concrete by then)."""
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference("bool", stop_gradient=True)
    helper.append_op("is_empty", inputs={"X": [x]}, outputs={"Out": [out]})
    return helper.main_program.current_block().var(out.name)


def Print(input, first_n=-1, message=None, summarize=20, print_tensor_name=True,
          print_tensor_type=True, print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """Prints ``input`` on the host at every run (the ``print`` op); a program
    holding one runs eagerly, not as a CUDA graph."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op("print", inputs={"In": [input]}, outputs={"Out": [out]},
                     attrs={"message": message or (input.name + ": ")})
    return helper.main_program.current_block().var(out.name)


def reorder_lod_tensor_by_rank(x, rank_table):
    raise NotImplementedError(
        "reorder_lod_tensor_by_rank reorders ragged LoD rows by a rank table; "
        "sequences here are padded with lengths -- sort or gather the padded batch "
        "with argsort + gather instead")


# the reference's StaticRNN: Scan has its step_input / memory / update_memory /
# step_output protocol
StaticRNN = Scan
