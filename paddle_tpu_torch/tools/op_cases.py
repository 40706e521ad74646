"""The case table of the dense op families: numpy inputs, attrs, the dtype
of the float inputs and the tolerance of each case, for the 99 op types of
the activation, elementwise, reduction, basic, tensor and math families
that the learning-rate schedules and the dense layers lower to.

    from paddle_tpu_torch.tools import op_cases
    outs = op_cases.forward("hard_swish-bounds", "cpu")
    grads = op_cases.grad("hard_swish-bounds", "cpu", outs)

``CASES`` maps a case id to a ``Case``. ``forward`` runs the port's
lowering of a case on a device; ``grad`` runs the port's generic
``<op>_grad`` there, with the grad op's own slots and attrs as
``append_backward`` builds them (the forward's inputs and outputs and a
seeded cotangent for each float output of ``Case.grad``). The tests hold
both against the JAX package's lowerings on the CPU
(``tests/test_torch_dense_ops.py``, ``tests/test_torch_tensor_ops.py``);
``chip_smoke.py`` runs each case on the card against the CPU port, and
each case whose gradient scatters (``Case.scatters``) twice on the card,
bit for bit.

The cases hold the points where two frameworks part: inputs exactly on a
clip's bounds or a kink (``jnp.clip`` and ``jnp.maximum`` pass half the
gradient at a tie), tied values where an index or a maximum is chosen,
negative operands of ``mod`` and ``floordiv``, and repeated indices where
a gradient or an update adds rows. ``RANDOM_CASES`` holds the two random
ops, which each package draws with its own generator: they are held by
their statistics (``random_stats``).

Tolerances: float32 ``atol 1e-5, rtol 1e-5`` (the two sides round
transcendental functions and sums in other orders, a few ulps);
bfloat16 ``atol 1e-2, rtol 1e-2`` (one bf16 ulp is 2^-8 relative, and the
two round at other steps).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import registry

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)


class Case(NamedTuple):
    op: str
    ins: Dict[str, list]
    attrs: dict
    dtype: str            # of the float inputs: "float32" or "bfloat16"
    tol: dict
    grad: Tuple[str, ...]  # output slots that get a cotangent; () = no gradient
    scatters: bool        # the gradient (or the op) adds rows by index
    grad_tol: dict        # the gradient's tolerance (``tol`` unless the case says)


CASES: Dict[str, Case] = {}


def case(name, op, ins, attrs=None, dtype="float32", tol=None, grad=("Out",),
         scatters=False, grad_tol=None):
    assert name not in CASES, name
    tol = tol or (BF16_TOL if dtype == "bfloat16" else F32_TOL)
    CASES[name] = Case(op, ins, dict(attrs or {}), dtype, tol, tuple(grad), scatters,
                       grad_tol or tol)


def r(*shape, scale=1.0, seed=None, lo=None, hi=None):
    """Seeded f32 normals (or uniforms in [lo, hi))."""
    rng = np.random.RandomState(sum(shape) if seed is None else seed)
    if lo is not None:
        return np.asarray(rng.uniform(lo, hi, shape), "float32")
    return np.asarray(rng.randn(*shape) * scale, "float32")


def ids(shape, hi, seed=1, lo=0):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype("int64")


def f32(*vals):
    return np.array(vals, "float32")


# --------------------------------------------------------------------------------------
# the schedules' ops: increment, elementwise min / pow / mod / floordiv, floor,
# ceil, cos, exp, pow
# --------------------------------------------------------------------------------------

case("increment-f32", "increment", {"X": [f32(3.0)]}, {"step": 1.5})
case("increment-int64", "increment", {"X": [np.array([9998], "int64")]}, {"step": 1.0},
     grad=())
_MIN_X = f32(-1.5, 0.25, 2.0, 3.0, -0.0, 7.0)
_MIN_Y = f32(-1.5, 0.5, 1.0, 3.0, 0.0, -7.0)      # ties at 0, 3 and 4
case("elementwise_min-ties", "elementwise_min", {"X": [_MIN_X], "Y": [_MIN_Y]})
case("elementwise_min-axis", "elementwise_min", {"X": [r(2, 3, 4)], "Y": [r(3, seed=5)]},
     {"axis": 1})
case("elementwise_min-bf16", "elementwise_min", {"X": [r(4, 6)], "Y": [r(6, seed=2)]},
     dtype="bfloat16")
case("elementwise_pow", "elementwise_pow",
     {"X": [r(3, 4, lo=0.2, hi=2.0)], "Y": [r(3, 4, lo=-1.5, hi=2.5, seed=9)]})
case("elementwise_pow-scalar-base", "elementwise_pow",
     {"X": [f32(0.5)], "Y": [f32(2.75)]})
case("elementwise_pow-int", "elementwise_pow",
     {"X": [np.array([2, -3, 0, 5], "int64")], "Y": [np.array([3, 2, 4, 0], "int64")]}, grad=())
_MOD_X = f32(-7.0, 7.0, -7.0, 7.0, 5.5, -0.5, 6.0, -6.0)
_MOD_Y = f32(2.0, -2.0, -2.0, 2.0, 2.0, 3.0, 3.0, 3.0)
case("elementwise_mod-signs", "elementwise_mod", {"X": [_MOD_X], "Y": [_MOD_Y]})
case("elementwise_mod-int", "elementwise_mod",
     {"X": [np.array([-7, 7, -7, 7, 0, -6], "int64")],
      "Y": [np.array([2, -2, -2, 3, 5, 3], "int64")]}, grad=())
case("elementwise_mod-broadcast", "elementwise_mod",
     {"X": [r(2, 5, scale=4.0)], "Y": [f32(1.5, -2.5, 3.0, -0.75, 2.0)]})
case("elementwise_floordiv-signs", "elementwise_floordiv", {"X": [_MOD_X], "Y": [_MOD_Y]})
case("elementwise_floordiv-int", "elementwise_floordiv",
     {"X": [np.array([-7, 7, -7, 7, 0, -6], "int64")],
      "Y": [np.array([2, -2, -2, 3, 5, 3], "int64")]}, grad=())
_ROUND = f32(-2.5, -1.5, -0.5, -0.2, 0.0, 0.4, 0.5, 1.5, 2.5, 2.7, -3.7, 1e-7)
case("floor", "floor", {"X": [_ROUND]}, grad=())
case("ceil", "ceil", {"X": [_ROUND]}, grad=())
case("round-half-even", "round", {"X": [_ROUND]}, grad=())
case("cos", "cos", {"X": [r(3, 5, scale=3.0)]})
case("cos-bf16", "cos", {"X": [r(3, 5, scale=3.0)]}, dtype="bfloat16")
case("exp", "exp", {"X": [r(3, 5, scale=2.0)]})
case("pow-half", "pow", {"X": [r(3, 4, lo=0.1, hi=3.0)]}, {"factor": -0.5})
case("pow-cube-negative", "pow", {"X": [r(3, 4, scale=2.0)]}, {"factor": 3.0})
case("pow-square-zero", "pow", {"X": [f32(0.0, -1.0, 2.0, 0.5)]}, {"factor": 2.0})

# --------------------------------------------------------------------------------------
# the other activations, with points on every kink and bound
# --------------------------------------------------------------------------------------

_XM = r(3, 5, lo=-0.9, hi=0.9)
_XP = r(3, 5, lo=0.3, hi=2.0)
for _op, _x, _attrs in (
        ("logsigmoid", r(3, 5, scale=4.0), {}), ("tanh_shrink", r(3, 5, scale=2.0), {}),
        ("log", _XP, {}), ("log1p", _XP, {}), ("rsqrt", _XP, {}), ("reciprocal", _XP, {}),
        ("softplus", f32(-30.0, -2.0, 0.0, 0.5, 3.0, 30.0), {}),
        ("softsign", f32(-3.0, -0.5, 0.0, 0.5, 2.0), {}),
        ("mish", r(3, 5, scale=2.0), {}), ("stanh", r(3, 5, scale=2.0),
                                           {"scale_a": 0.5, "scale_b": 1.5}),
        ("swish", r(3, 5, scale=2.0), {"beta": 1.5}),
        ("sin", r(3, 5, scale=3.0), {}), ("acos", _XM, {}), ("asin", _XM, {}),
        ("atan", r(3, 5, scale=2.0), {}), ("cosh", r(3, 5), {}), ("sinh", r(3, 5), {}),
        ("erf", r(3, 5), {})):
    case(_op, _op, {"X": [_x]}, _attrs)
case("abs-zero", "abs", {"X": [f32(-2.0, -0.5, 0.0, 0.5, 3.0)]})
case("softshrink-bounds", "softshrink", {"X": [f32(-1.0, -0.5, -0.2, 0.0, 0.5, 0.7)]},
     {"lambda": 0.5})
case("hard_shrink-bounds", "hard_shrink", {"X": [f32(-1.0, -0.5, -0.2, 0.0, 0.5, 0.7)]},
     {"threshold": 0.5})
case("thresholded_relu-bound", "thresholded_relu", {"X": [f32(-1.0, 0.0, 0.5, 1.0, 1.5)]},
     {"threshold": 1.0})
case("relu6-bounds", "relu6", {"X": [f32(-1.0, 0.0, 3.0, 6.0, 7.5)]}, {"threshold": 6.0})
case("brelu-bounds", "brelu", {"X": [f32(-1.0, 0.0, 2.0, 5.0, 8.0)]},
     {"t_min": 0.0, "t_max": 5.0})
case("leaky_relu-zero", "leaky_relu", {"X": [f32(-2.0, -0.5, 0.0, 0.5, 1.0)]},
     {"alpha": 0.1})
case("elu-zero", "elu", {"X": [f32(-3.0, -0.5, 0.0, 0.5, 2.0)]}, {"alpha": 1.5})
case("hard_swish-bounds", "hard_swish", {"X": [f32(-4.0, -3.0, -1.0, 0.0, 1.0, 3.0, 5.0)]},
     {"scale": 6.0, "offset": 0.5})
case("hard_sigmoid-bounds", "hard_sigmoid",
     {"X": [f32(-3.0, -2.5, -1.0, 0.0, 1.0, 2.5, 4.0)]}, {"slope": 0.2, "offset": 0.5})
case("soft_relu-bounds", "soft_relu", {"X": [f32(-3.0, -2.0, 0.0, 1.0, 2.0, 3.0)]},
     {"threshold": 2.0})
case("hard_swish-bf16", "hard_swish", {"X": [r(4, 6, scale=3.0)]}, dtype="bfloat16")
# the gradient is exp(x - softplus(x)) in bf16 steps: x - softplus(x) subtracts
# two rounded values of like size (ulp 2^-6 to 2^-5 at |x| 2 to 8), and each side
# rounds the difference at its own step, so an element of the gradient moves by
# 2-4 bf16 ulps (measured: 0.031 at 1.7, 1.8%): rtol 2e-2 for the gradient
case("softplus-bf16", "softplus", {"X": [r(4, 6, scale=3.0)]}, dtype="bfloat16",
     grad_tol=dict(atol=1e-2, rtol=2e-2))

# --------------------------------------------------------------------------------------
# reductions
# --------------------------------------------------------------------------------------

_TIES = np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, -1.0], [0.0, -2.0, -2.0, 0.0]],
                 "float32")
case("reduce_mean", "reduce_mean", {"X": [r(2, 3, 4)]}, {"dim": [1, 2], "keep_dim": False})
case("reduce_mean-all", "reduce_mean", {"X": [r(2, 3, 4)]},
     {"dim": [0], "keep_dim": True, "reduce_all": True})
case("reduce_max-ties", "reduce_max", {"X": [_TIES]}, {"dim": [1], "keep_dim": True})
case("reduce_max-all-ties", "reduce_max", {"X": [_TIES]},
     {"dim": [0], "keep_dim": False, "reduce_all": True})
case("reduce_min-ties", "reduce_min", {"X": [_TIES]}, {"dim": [-1], "keep_dim": False})
case("reduce_min-axis0", "reduce_min", {"X": [r(3, 4, 2)]}, {"dim": [0, 2]})
case("reduce_prod", "reduce_prod", {"X": [r(2, 3, 4, lo=0.5, hi=1.5)]}, {"dim": [1]})
case("reduce_prod-zero", "reduce_prod", {"X": [f32(0.0, 3.0, 2.0, -1.5)]},
     {"dim": [0], "reduce_all": True})
case("reduce_prod-two-axes", "reduce_prod", {"X": [r(2, 3, 4, lo=-1.5, hi=1.5)]},
     {"dim": [0, 2], "keep_dim": True})
case("reduce_all", "reduce_all", {"X": [np.array([[True, False], [True, True]])]},
     {"dim": [1]}, grad=())
case("reduce_any-all", "reduce_any", {"X": [np.array([[False, False], [True, False]])]},
     {"dim": [0], "reduce_all": True}, grad=())
case("cumsum", "cumsum", {"X": [r(3, 5)]}, {"axis": 1})
case("cumsum-exclusive-reverse", "cumsum", {"X": [r(3, 5)]},
     {"axis": -1, "exclusive": True, "reverse": True})
case("cumsum-flatten", "cumsum", {"X": [r(2, 3)]}, {"flatten": True})
case("logsumexp", "logsumexp", {"X": [r(3, 5, scale=4.0)]}, {"dim": [1], "keep_dim": True})
case("logsumexp-all", "logsumexp", {"X": [r(2, 3, 4, scale=4.0)]},
     {"dim": [0], "reduce_all": True})

# --------------------------------------------------------------------------------------
# basic: fills, bounds, shapes, logical ops, one-hot, where
# --------------------------------------------------------------------------------------

case("fill_any_like", "fill_any_like", {"X": [r(2, 3)]}, {"value": 2.5}, grad=())
case("fill_any_like-int", "fill_any_like", {"X": [r(2, 3)]},
     {"value": 7.0, "dtype": "int64"}, grad=())
case("fill_zeros_like", "fill_zeros_like", {"X": [r(3, 2)]}, grad=())
case("isfinite-inf", "isfinite", {"X": [f32(1.0, np.inf, 2.0)]}, grad=())
case("isfinite-nan", "isfinite", {"X": [f32(1.0, np.nan)]}, grad=())
case("isfinite-true", "isfinite", {"X": [r(2, 3)]}, grad=())
case("linspace", "linspace", {}, {"start": -1.0, "stop": 2.0, "num": 7}, grad=())
case("range-float", "range", {}, {"start": 1.0, "end": 7.0, "step": 1.5,
                                   "dtype": "float32"}, grad=())
case("range-int", "range", {}, {"start": 2, "end": -7, "step": -3, "dtype": "int64"}, grad=())
case("shape", "shape", {"Input": [r(2, 3, 4)]}, grad=())
_LA = np.array([[True, False, True], [False, False, True]])
_LB = np.array([[True, True, False], [False, True, True]])
for _op in ("logical_and", "logical_or", "logical_xor"):
    case(_op, _op, {"X": [_LA], "Y": [_LB]}, grad=())
case("logical_not", "logical_not", {"X": [_LA]}, grad=())
case("one_hot_v2", "one_hot_v2", {"X": [np.array([[1, 3], [0, 4]], "int64")]}, {"depth": 5},
     grad=())
case("one_hot_v2-out-of-range", "one_hot_v2", {"X": [np.array([2, 7, -1], "int64")]},
     {"depth": 4}, grad=())
case("where", "where", {"Condition": [_LA], "X": [r(2, 3)], "Y": [r(2, 3, seed=4)]})
case("where-broadcast", "where", {"Condition": [np.array([True, False, True])],
                                  "X": [r(2, 3)], "Y": [r(3, seed=4)]})

# --------------------------------------------------------------------------------------
# tensor ops
# --------------------------------------------------------------------------------------

_ARG = np.array([[1.0, 3.0, 3.0, 2.0, 3.0], [-1.0, -1.0, -2.0, -2.0, -1.0]], "float32")
# argsort's Out is x taken at the sorted indices: its gradient scatters back
case("arg_max-ties", "arg_max", {"X": [_ARG]}, {"axis": -1}, grad=())
case("arg_max-axis0", "arg_max", {"X": [ids((6, 4), 3, seed=3).astype("float32")]},
     {"axis": 0}, grad=())
case("arg_min-ties", "arg_min", {"X": [_ARG]}, {"axis": 1}, grad=())
case("argsort-ties", "argsort", {"X": [_ARG]}, {"axis": -1, "descending": False},
     grad=("Out",), scatters=True)
case("argsort-ties-descending", "argsort", {"X": [_ARG]}, {"axis": -1, "descending": True},
     grad=("Out",), scatters=True)
case("argsort-axis0-64x50", "argsort", {"X": [ids((64, 50), 3, seed=7).astype("float32")]},
     {"axis": 0, "descending": True}, grad=("Out",), scatters=True)
case("diag-vector", "diag", {"Diagonal": [r(4)]}, grad=())
case("diag-matrix", "diag", {"Diagonal": [r(3, 3)]}, grad=())
case("eye", "eye", {}, {"num_rows": 3, "num_columns": 5, "dtype": "float32"}, grad=())
case("expand_as", "expand_as", {"X": [r(2, 1, 3)], "target_tensor": [r(4, 5, 3)]})
case("tile", "tile", {"X": [r(2, 3)]}, {"repeat_times": [2, 1, 3]})
case("tile-short", "tile", {"X": [r(2, 3)]}, {"repeat_times": [2]})
case("flatten", "flatten", {"X": [r(2, 3, 4)]}, {"axis": 2})
case("flatten2-axis0", "flatten2", {"X": [r(2, 3, 4)]}, {"axis": 0})
case("reshape", "reshape", {"X": [r(2, 6, 4)]}, {"shape": [0, -1, 3]})
case("transpose", "transpose", {"X": [r(2, 3, 4)]}, {"axis": [2, 0, 1]})
case("squeeze", "squeeze", {"X": [r(2, 1, 3, 1)]}, {"axes": [1, -1]})
case("unsqueeze", "unsqueeze", {"X": [r(2, 3)]}, {"axes": [0, 2]})
case("flip", "flip", {"X": [r(2, 3, 4)]}, {"axis": [0, 2]})
case("reverse", "reverse", {"X": [r(3, 4)]}, {"axis": [1]})
case("roll", "roll", {"X": [r(3, 5)]}, {"shifts": [2, -1], "axis": [1, 0]})
case("stack", "stack", {"X": [r(2, 3), r(2, 3, seed=1), r(2, 3, seed=2)]}, {"axis": 1},
     grad=("Y",))
case("unstack", "unstack", {"X": [r(3, 2, 4)]}, {"axis": 1}, grad=("Y",))
case("strided_slice", "strided_slice", {"Input": [r(5, 6, 4)]},
     {"axes": [0, 1], "starts": [1, 0], "ends": [5, 6], "strides": [2, 3]})
case("strided_slice-negative", "strided_slice", {"Input": [r(5, 6, 4)]},
     {"axes": [1, 2], "starts": [-1, 3], "ends": [0, -10], "strides": [-2, -1]})
case("pad", "pad", {"X": [r(2, 3)]}, {"paddings": [1, 0, 2, 3], "pad_value": -1.5})
for _mode in ("constant", "reflect", "edge"):
    case(f"pad2d-{_mode}-nchw", "pad2d", {"X": [r(2, 3, 4, 5)]},
         {"paddings": [2, 1, 3, 2], "mode": _mode, "pad_value": 0.5, "data_format": "NCHW"},
         scatters=_mode != "constant")
    case(f"pad2d-{_mode}-nhwc", "pad2d", {"X": [r(2, 4, 5, 3)]},
         {"paddings": [1, 3, 0, 2], "mode": _mode, "data_format": "NHWC"},
         scatters=_mode != "constant")
# repeated indices: the gradients add rows
case("gather_nd-repeats", "gather_nd",
     {"X": [r(4, 5, 3)], "Index": [np.array([[[1, 2], [3, 0]], [[1, 2], [-1, -2]]], "int64")]},
     scatters=True)
case("gather_nd-full", "gather_nd",
     {"X": [r(4, 5)], "Index": [np.array([[0, 1], [0, 1], [3, 4], [2, 2]], "int64")]},
     scatters=True)
case("index_select-repeats", "index_select",
     {"X": [r(4, 6)], "Index": [np.array([1, 3, 1, 0, 1], "int64")]}, {"dim": 1},
     scatters=True)
case("lookup_table-repeats", "lookup_table",
     {"W": [r(10, 4)], "Ids": [np.array([[1], [7], [1], [3], [7], [1]], "int64")]},
     {"padding_idx": -1}, scatters=True)
case("lookup_table-padding", "lookup_table",
     {"W": [r(10, 4)], "Ids": [ids((3, 4, 1), 10, seed=5)]}, {"padding_idx": 2},
     scatters=True)
case("embedding_bag-sum", "embedding_bag",
     {"W": [r(8, 3)], "Ids": [np.array([[1, 1, 4], [0, 1, 7]], "int64")]}, {"mode": "sum"},
     scatters=True)
case("embedding_bag-mean", "embedding_bag",
     {"W": [r(8, 3)], "Ids": [ids((4, 5), 8, seed=6)]}, {"mode": "mean"}, scatters=True)
# overwrite with distinct ids: which of two updates of one id lands is undefined in
# both packages (x.at[ids].set), so the parity cases never repeat an id there
case("scatter-overwrite", "scatter",
     {"X": [r(6, 3)], "Ids": [np.array([4, 0, 2], "int64")], "Updates": [r(3, 3, seed=2)]},
     {"overwrite": True}, scatters=True)
case("scatter-add-repeats", "scatter",
     {"X": [r(6, 3)], "Ids": [np.array([4, 0, 4, 4, 1], "int64")],
      "Updates": [r(5, 3, seed=2)]}, {"overwrite": False}, scatters=True)
case("scatter_nd_add-repeats", "scatter_nd_add",
     {"X": [r(4, 5, 2)], "Index": [np.array([[1, 2], [3, 0], [1, 2], [1, 2]], "int64")],
      "Updates": [r(4, 2, seed=3)]}, scatters=True)
case("scatter_nd_add-rows", "scatter_nd_add",
     {"X": [r(5, 3)], "Index": [np.array([[[0], [4]], [[0], [2]]], "int64")],
      "Updates": [r(2, 2, 3, seed=3)]}, scatters=True)
case("meshgrid", "meshgrid", {"X": [r(3), r(4, seed=1)]}, grad=())
case("shard_index", "shard_index", {"X": [np.array([[0], [7], [12], [19], [5]], "int64")]},
     {"index_num": 20, "nshards": 3, "shard_id": 1, "ignore_value": -1}, grad=())

# --------------------------------------------------------------------------------------
# math: products, losses, norms
# --------------------------------------------------------------------------------------

case("bmm", "bmm", {"X": [r(2, 3, 4)], "Y": [r(2, 4, 5, seed=1)]})
case("dot", "dot", {"X": [r(3, 5)], "Y": [r(3, 5, seed=1)]})
case("cross_entropy2", "cross_entropy2",
     {"X": [r(5, 4, lo=0.05, hi=1.0)], "Label": [np.array([[0], [3], [2], [-1], [7]], "int64")]},
     {"ignore_index": 2}, grad=("Y",))
_HR = f32(0.0, 0.5, 1.0, -1.0, 2.5, -3.0)                  # residuals on |r| = delta
case("huber_loss-bounds", "huber_loss", {"X": [f32(1.0, 1.0, 1.0, 1.0, 1.0, 1.0)],
                                         "Y": [1.0 + _HR]}, {"delta": 1.0})
case("smooth_l1_loss", "smooth_l1_loss", {"X": [r(3, 4)], "Y": [r(3, 4, seed=2)]},
     {"sigma": 2.0})
case("smooth_l1_loss-weights-bound", "smooth_l1_loss",
     {"X": [f32(0.25, -0.25, 0.0, 1.0).reshape(2, 2)], "Y": [np.zeros((2, 2), "float32")],
      "InsideWeight": [f32(1.0, 1.0, 2.0, 0.5).reshape(2, 2)],
      "OutsideWeight": [f32(0.5, 2.0, 1.0, 1.0).reshape(2, 2)]}, {"sigma": 2.0})
case("l2_normalize", "l2_normalize", {"X": [r(3, 4)]}, {"axis": 1, "epsilon": 1e-12})
case("log_loss", "log_loss", {"Predicted": [r(4, 1, lo=0.05, hi=0.95)],
                              "Labels": [f32(0.0, 1.0, 1.0, 0.0).reshape(4, 1)]},
     {"epsilon": 1e-4}, grad=("Loss",))
case("p_norm", "p_norm", {"X": [r(3, 4)]}, {"porder": 2.0, "axis": -1})
case("p_norm-3-keepdim-zero", "p_norm", {"X": [f32(0.0, -1.0, 2.0, 0.5, 0.0, -3.0).reshape(2, 3)]},
     {"porder": 3.0, "axis": 1, "keepdim": True})

#: the random ops: (attrs, the dtype of Out); held by ``random_stats``
RANDOM_CASES = {
    "randint": ({"shape": [200, 500], "low": -3, "high": 9, "dtype": "int64", "seed": 0},
                "int64"),
    "truncated_gaussian_random": ({"shape": [200, 500], "mean": 0.5, "std": 2.0, "seed": 0,
                                   "dtype": "float32"}, "float32"),
}


def random_stats(op: str, out: np.ndarray) -> Optional[str]:
    """Why a random op's draws do not have its distribution's range and
    moments, or None. 100,000 draws: the sample mean of a uniform integer
    in [-3, 9) lies within ~0.01 of 2.5 and its variance (143 / 12) within
    ~1%; a normal truncated at +-2 has mean 0 and variance
    1 - 4 phi(2) / (Phi(2) - Phi(-2)) = 0.7737 (times std^2), and nothing
    beyond 2 std."""
    attrs, _ = RANDOM_CASES[op]
    if op == "randint":
        lo, hi = attrs["low"], attrs["high"]
        vals = np.unique(out)
        if out.min() < lo or out.max() >= hi or len(vals) != hi - lo:
            return f"values {vals} outside [{lo}, {hi}) or some missing"
        mean, var = (lo + hi - 1) / 2, ((hi - lo) ** 2 - 1) / 12
        if abs(out.mean() - mean) > 0.05 or abs(out.var() / var - 1) > 0.03:
            return f"mean {out.mean()} (expected {mean}), variance {out.var()} ({var})"
        return None
    m, s = attrs["mean"], attrs["std"]
    z = (out.astype(np.float64) - m) / s
    if np.abs(z).max() > 2.0 + 1e-6:
        return f"a draw {np.abs(z).max()} std from the mean, beyond 2"
    if abs(z.mean()) > 0.02 or abs(z.var() / 0.7737 - 1) > 0.03:
        return f"standardised mean {z.mean()}, variance {z.var()} (expected 0, 0.7737)"
    return None


# --------------------------------------------------------------------------------------
# running a case through the port
# --------------------------------------------------------------------------------------

def to_tensor(a: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A case input on ``device``: float arrays in the case's dtype."""
    t = torch.from_numpy(np.array(a))
    if dtype == "bfloat16" and a.dtype.kind == "f":
        t = t.to(torch.bfloat16)
    return t.to(device)


def forward(name: str, device) -> Dict[str, list]:
    """The port's lowering of case ``name`` on ``device``."""
    c = CASES[name]
    ins = {s: [to_tensor(a, c.dtype, device) for a in v] for s, v in c.ins.items()}
    return registry.get(c.op).lower(registry.LowerCtx(dict(c.attrs), device), ins)


def cotangent(shape, i: int) -> np.ndarray:
    """The seeded cotangent of the i-th output of a slot."""
    return r(*shape, seed=100 + i).reshape(shape)


def grad_inputs(name: str, outs: Dict[str, list]):
    """(the grad op's numpy inputs, its attrs) as ``make_grad_op_descs``
    builds them: the forward's inputs, its outputs ``outs`` (numpy) and a
    cotangent for each float output of the case's ``grad`` slots."""
    c = CASES[name]
    gins = {s: list(v) for s, v in c.ins.items()}
    for s, vals in outs.items():
        gins[s] = [None if v is None else np.asarray(v) for v in vals]
        if s in c.grad:
            gins[s + "@GRAD"] = [None if v is None or np.asarray(v).dtype.kind != "f"
                                 else cotangent(np.shape(v), i) for i, v in enumerate(vals)]
    gattrs = dict(c.attrs, __fwd_attrs__=dict(c.attrs), __fwd_out_slots__=sorted(outs),
                  __fwd_out0__="out0")
    return gins, gattrs


def numpy_outs(outs: Dict[str, list]) -> Dict[str, list]:
    """Tensors (bf16 widened to f32) or arrays as numpy."""
    def conv(v):
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        v = np.asarray(v)
        return v.astype(np.float32) if str(v.dtype) == "bfloat16" else v
    return {s: [conv(v) for v in vals] for s, vals in outs.items()}


def grad(name: str, device, outs: Dict[str, list]) -> Dict[str, list]:
    """The port's generic ``<op>_grad`` of case ``name`` on ``device``,
    given the forward's outputs ``outs`` (tensors or numpy)."""
    c = CASES[name]
    gins, gattrs = grad_inputs(name, numpy_outs(outs))
    fwd_slots = set(c.ins)
    tins = {s: [None if a is None else to_tensor(a, c.dtype if s in fwd_slots else "float32",
                                                  device) for a in v]
            for s, v in gins.items()}
    return registry.get(c.op + "_grad").lower(registry.LowerCtx(gattrs, device), tins)
