"""Program IR: the serializable graph-program representation.

The port's copy of ``paddle_tpu/framework.py``: the same Variable / Parameter /
Operator / Block / Program classes and the same JSON form (``to_dict`` /
``from_dict``), so a Program saved by either package loads in the other.

What differs from the JAX package:
  * ``Block.append_op`` runs the port's own shape inference
    (``core/registry.py``: the lowering on ``torch.device("meta")`` tensors).
  * No ``device_guard``: the port runs no pipeline stages yet.

Variables carry the JAX package's arithmetic sugar (``layers/math_sugar.py``):
``+ - * / **``, unary ``-``, the comparisons and ``[]`` build ops in the
current block, as the learning-rate schedules use them. ``==`` and ``!=``
against a Variable or a number build ``equal`` / ``not_equal`` ops too, so
``var in some_list`` or ``list.index(var)`` is no identity test: code
compares Variables by ``is`` or by name. ``__hash__`` stays the identity.

Sub-blocks (``Program._create_block`` / ``_rollback``) hold the bodies of
control-flow ops (``layers.Scan``); the executor runs them through
``LowerCtx.block_runner``.

``Block.insert_op``, ``prepend_op`` and ``remove_op`` are the JAX package's
(``quantize_weights`` inserts its ``dequantize_weight`` ops with
``insert_op``).
"""
from __future__ import annotations

import json
import os as _os
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name

_PKG_DIR = _os.path.dirname(_os.path.abspath(__file__))


def _user_stack(limit: int = 6):
    """Frames outside this package where the current op is being created,
    attached to lowering errors so a failure names the user's line."""
    frames = []
    f = sys._getframe(2)
    depth = 0
    while f is not None and depth < 50 and len(frames) < limit:
        fn = f.f_code.co_filename
        if not fn.startswith(_PKG_DIR):
            frames.append(traceback.FrameSummary(fn, f.f_lineno,
                                                 f.f_code.co_name,
                                                 lookup_line=False))
        f = f.f_back
        depth += 1
    return list(reversed(frames))


# --------------------------------------------------------------------------------------
# dtypes
# --------------------------------------------------------------------------------------

_DTYPE_ALIASES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "float64": "float64", "fp64": "float64", "f64": "float64", "double": "float64",
    "float16": "float16", "fp16": "float16", "half": "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8", "uint8": "uint8", "int16": "int16",
    "int32": "int32", "int64": "int64", "bool": "bool",
}

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def convert_dtype(dtype) -> str:
    """Normalize a dtype spec (str / np.dtype / torch.dtype) to a canonical string."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, str):
        if dtype in _DTYPE_ALIASES:
            return _DTYPE_ALIASES[dtype]
        raise ValueError(f"unsupported dtype string: {dtype!r}")
    name = str(dtype).replace("torch.", "")
    if name not in _DTYPE_ALIASES:
        name = np.dtype(dtype).name
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    raise ValueError(f"unsupported dtype: {dtype!r}")


def is_float_dtype(dtype) -> bool:
    return convert_dtype(dtype) in _FLOAT_DTYPES


def grad_var_name(name: str) -> str:
    return name + "@GRAD"


# --------------------------------------------------------------------------------------
# Variable
# --------------------------------------------------------------------------------------

class VarType:
    DENSE = "dense"
    TENSOR_ARRAY = "tensor_array"
    SELECTED_ROWS = "selected_rows"
    STEP_SCOPES = "step_scopes"
    RAW = "raw"


class Variable:
    """A named tensor slot in a Block. -1 in ``shape`` is a dim unknown until
    feed time (typically batch); ``persistable`` marks state kept in the Scope."""

    def __init__(self, block: "Block", name: str, shape: Sequence[int] = (),
                 dtype="float32", persistable: bool = False, stop_gradient: bool = False,
                 is_data: bool = False, type: str = VarType.DENSE, initializer=None):
        self.block = block
        self.name = name
        self.shape = tuple(int(d) for d in shape)
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.type = type
        self.initializer = initializer

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def to_dict(self) -> dict:
        d = {
            "name": self.name, "shape": list(self.shape), "dtype": self.dtype,
            "persistable": self.persistable, "stop_gradient": self.stop_gradient,
            "is_data": self.is_data, "type": self.type,
        }
        if isinstance(self, Parameter):
            d["is_parameter"] = True
            d["trainable"] = self.trainable
        return d

    def __repr__(self):
        flags = "".join(
            f for f, on in (("P", self.persistable), ("D", self.is_data),
                            ("S", self.stop_gradient)) if on)
        return f"Var({self.name}: {self.dtype}{list(self.shape)}{' ' + flags if flags else ''})"

    # -- DSL sugar: arithmetic builds ops in the current program -----------------------
    def _binary(self, other, op_type, reverse=False):
        from .layers import math_sugar
        return math_sugar.binary(self, other, op_type, reverse)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._binary(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __rtruediv__(self, other):
        return self._binary(other, "elementwise_div", reverse=True)

    def __pow__(self, other):
        return self._binary(other, "elementwise_pow")

    def __neg__(self):
        from .layers import math_sugar
        return math_sugar.scale(self, -1.0)

    def __lt__(self, other):
        return self._binary(other, "less_than")

    def __le__(self, other):
        return self._binary(other, "less_equal")

    def __gt__(self, other):
        return self._binary(other, "greater_than")

    def __ge__(self, other):
        return self._binary(other, "greater_equal")

    def __eq__(self, other):  # builds an op: compare Variables by ``is`` or name
        if isinstance(other, (Variable, int, float)):
            return self._binary(other, "equal")
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Variable, int, float)):
            return self._binary(other, "not_equal")
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __getitem__(self, item):
        from .layers import math_sugar
        return math_sugar.getitem(self, item)


class Parameter(Variable):
    """A trainable persistable variable."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 regularizer=None, gradient_clip=None, do_model_average=True,
                 initializer=None, **kw):
        super().__init__(block, name, shape, dtype, persistable=True,
                         stop_gradient=not trainable, initializer=initializer)
        self.trainable = trainable
        self.regularizer = regularizer
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        self.is_distributed = kw.get("is_distributed", False)


# --------------------------------------------------------------------------------------
# Operator
# --------------------------------------------------------------------------------------

class Operator:
    """One op in a Block: slot name -> list of var names, plus JSON-able attrs."""

    def __init__(self, block, type: str, inputs: Dict[str, List[str]] = None,
                 outputs: Dict[str, List[str]] = None, attrs: Dict[str, Any] = None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self._creation_stack = _user_stack()

    def creation_stack_str(self) -> str:
        return "".join(f'  File "{f.filename}", line {f.lineno}, '
                       f"in {f.name}\n    {f.line}\n"
                       for f in self._creation_stack)

    def input(self, slot) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot) -> List[str]:
        return self.outputs.get(slot, [])

    def input_arg_names(self) -> List[str]:
        return [n for v in self.inputs.values() for n in v]

    def output_arg_names(self) -> List[str]:
        return [n for v in self.outputs.values() for n in v]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def to_dict(self) -> dict:
        return {"type": self.type, "inputs": self.inputs, "outputs": self.outputs,
                "attrs": _jsonable_attrs(self.attrs)}

    def __repr__(self):
        ins = ", ".join(f"{k}={v}" for k, v in sorted(self.inputs.items()))
        outs = ", ".join(f"{k}={v}" for k, v in sorted(self.outputs.items()))
        return f"{{{self.type}: ({ins}) -> ({outs})}}"


def _jsonable_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        else:
            out[k] = v
    return out


def _unjson_attrs(attrs: dict) -> dict:
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__ndarray__" in v:
            out[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
        else:
            out[k] = v
    return out


# --------------------------------------------------------------------------------------
# Block
# --------------------------------------------------------------------------------------

class Block:
    """Ordered op list + var map, with parent scoping."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def create_var(self, name=None, shape=(), dtype="float32", **kw) -> Variable:
        if name is None:
            name = unique_name.generate("tmp")
        if name in self.vars:
            return self.vars[name]
        v = Variable(self, name, shape, dtype, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name=None, shape=(), dtype="float32", **kw) -> Parameter:
        if name is None:
            name = unique_name.generate("param")
        # parameters always live in the program's global (root) block
        gb = self.program.global_block()
        if name in gb.vars:
            v = gb.vars[name]
            if not isinstance(v, Parameter):
                raise TypeError(f"{name} exists and is not a Parameter")
            return v
        p = Parameter(gb, name, shape, dtype, **kw)
        gb.vars[name] = p
        self.program._bump()
        return p

    def var(self, name) -> Variable:
        v = self.find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name) -> bool:
        return name in self.vars

    def find_var_recursive(self, name) -> Optional[Variable]:
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None,
                  infer_shape: bool = True) -> Operator:
        op = Operator(self, type, _normalize_io(inputs), _normalize_io(outputs), attrs)
        self.ops.append(op)
        self.program._bump()
        if infer_shape:
            from .core import registry
            registry.infer_shape(op, self)
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None,
                   infer_shape: bool = True) -> Operator:
        """Append the op (shape inference included), then move it first."""
        return self.insert_op(0, type, inputs, outputs, attrs, infer_shape=infer_shape)

    def insert_op(self, index: int, type: str, inputs=None, outputs=None, attrs=None,
                  infer_shape: bool = True) -> Operator:
        """Append the op (shape inference included), then move it to ``index``."""
        op = self.append_op(type, inputs, outputs, attrs, infer_shape=infer_shape)
        self.ops.insert(index, self.ops.pop())
        return op

    def remove_op(self, index: int):
        del self.ops[index]
        self.program._bump()

    def to_dict(self) -> dict:
        return {
            "idx": self.idx, "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }

    def __str__(self):
        lines = [f"block {self.idx} (parent {self.parent_idx}):"]
        lines += [f"  {v!r}" for v in self.vars.values()]
        lines += [f"  {op!r}" for op in self.ops]
        return "\n".join(lines)


def _normalize_io(io) -> Dict[str, List[str]]:
    """Accept {slot: Variable | name | list thereof} and normalize to {slot: [names]}."""
    out: Dict[str, List[str]] = {}
    if not io:
        return out
    for slot, val in io.items():
        if val is None:
            continue
        if not isinstance(val, (list, tuple)):
            val = [val]
        names = []
        for v in val:
            if isinstance(v, Variable):
                names.append(v.name)
            elif isinstance(v, str):
                names.append(v)
            else:
                raise TypeError(f"bad io entry for slot {slot}: {v!r}")
        if names:
            out[slot] = names
    return out


# --------------------------------------------------------------------------------------
# Program
# --------------------------------------------------------------------------------------

# ops whose inference behaviour differs (clone(for_test) sets is_test on them)
_IS_TEST_OPS = {"dropout", "batch_norm", "sync_batch_norm", "lrn",
                "fused_attention", "conv2d_bn_fused"}


class Program:
    """A multi-block program; ``_version`` is bumped on any mutation."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._current_block_idx = 0
        self.random_seed: Optional[int] = None
        self._version = 0
        self._is_startup = False

    def _bump(self):
        self._version += 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._current_block_idx]

    def _create_block(self, parent_idx=None) -> Block:
        """A new block whose parent is the current block (or ``parent_idx``);
        layers build into it until ``_rollback``."""
        parent = self._current_block_idx if parent_idx is None else parent_idx
        b = Block(self, len(self.blocks), parent)
        self.blocks.append(b)
        self._current_block_idx = b.idx
        self._bump()
        return b

    def _rollback(self):
        """Make the current block's parent current again."""
        self._current_block_idx = self.current_block().parent_idx

    def clone(self, for_test: bool = False) -> "Program":
        """Deep structural copy. With for_test=True, sets is_test on the ops that
        behave differently in inference (dropout off, batch_norm on running stats)."""
        p = Program.from_dict(self.to_dict())
        p.random_seed = self.random_seed
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if op.type in _IS_TEST_OPS:
                        op.attrs["is_test"] = True
        return p

    def _prune(self, feed_names, target_names, for_test: bool = False) -> "Program":
        """Slice to the subgraph producing ``target_names`` from ``feed_names``
        (used by save_inference_model)."""
        pruned = self.clone(for_test=for_test)
        block = pruned.global_block()

        def op_reads(op):
            """Input names of ``op`` plus outer-var reads of any sub-block it
            references (control-flow bodies see the enclosing env)."""
            reads = list(op.input_arg_names())
            sub_idx = op.attrs.get("sub_block")
            stack = [sub_idx] if isinstance(sub_idx, int) else []
            eb = op.attrs.get("else_block")
            if isinstance(eb, int) and eb >= 0:
                stack.append(eb)
            seen = set()
            while stack:
                bi = stack.pop()
                if bi in seen or bi >= len(pruned.blocks):
                    continue
                seen.add(bi)
                produced = set()
                for sop in pruned.blocks[bi].ops:
                    reads.extend(n for n in sop.input_arg_names() if n not in produced)
                    produced.update(sop.output_arg_names())
                    si = sop.attrs.get("sub_block")
                    if isinstance(si, int):
                        stack.append(si)
            return reads

        needed = set(target_names)
        keep = set()
        for i in range(len(block.ops) - 1, -1, -1):
            op = block.ops[i]
            if any(n in needed for n in op.output_arg_names()):
                keep.add(i)
                needed.update(op_reads(op))
        block.ops = [op for i, op in enumerate(block.ops) if i in keep]
        referenced = set(feed_names) | set(target_names)
        for op in block.ops:
            referenced.update(op.input_arg_names())
            referenced.update(op.output_arg_names())
        block.vars = {n: v for n, v in block.vars.items() if n in referenced}
        pruned._bump()
        return pruned

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def to_dict(self) -> dict:
        return {"version": 1, "random_seed": self.random_seed,
                "blocks": [b.to_dict() for b in self.blocks]}

    @staticmethod
    def from_dict(d: dict) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed")
        p.blocks = [Block(p, bd["idx"], bd["parent_idx"]) for bd in d["blocks"]]
        for bd, b in zip(d["blocks"], p.blocks):
            for vd in bd["vars"]:
                if vd.get("is_parameter"):
                    v = Parameter(b, vd["name"], vd["shape"], vd["dtype"],
                                  trainable=vd.get("trainable", True))
                else:
                    v = Variable(b, vd["name"], vd["shape"], vd["dtype"],
                                 persistable=vd["persistable"],
                                 stop_gradient=vd["stop_gradient"],
                                 is_data=vd["is_data"], type=vd["type"])
                b.vars[v.name] = v
            for od in bd["ops"]:
                b.ops.append(Operator(b, od["type"], od["inputs"], od["outputs"],
                                      _unjson_attrs(od["attrs"])))
        p._current_block_idx = 0
        return p

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Program":
        return Program.from_dict(json.loads(s))

    def __str__(self):
        return "\n".join(str(b) for b in self.blocks)


# --------------------------------------------------------------------------------------
# default programs / guards
# --------------------------------------------------------------------------------------

class _TLS(threading.local):
    def __init__(self):
        self.main_program = Program()
        self.startup_program = Program()
        self.startup_program._is_startup = True


_tls = _TLS()


def default_main_program() -> Program:
    return _tls.main_program


def default_startup_program() -> Program:
    return _tls.startup_program


def switch_main_program(p: Program) -> Program:
    old = _tls.main_program
    _tls.main_program = p
    return old


def switch_startup_program(p: Program) -> Program:
    old = _tls.startup_program
    _tls.startup_program = p
    return old


class program_guard:
    """``with program_guard(main, startup):`` builds into these programs."""

    def __init__(self, main_program: Program, startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        self.old_main = switch_main_program(self.main)
        if self.startup is not None:
            self.startup._is_startup = True
            self.old_startup = switch_startup_program(self.startup)
        return self

    def __exit__(self, *exc):
        switch_main_program(self.old_main)
        if self.startup is not None:
            switch_startup_program(self.old_startup)
        return False
