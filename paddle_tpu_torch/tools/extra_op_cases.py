"""The case table of the op types of ROADMAP item 8: the 34 of
``ops/extra_ops.py``, the 22 of ``ops/tail_ops.py``, the 12 sequence op
types of ``ops/sequence_ops.py`` added with them, ``warpctc`` and
``ctc_align``, ``nce`` and ``hsigmoid``, and ``chunk_eval``.

    from paddle_tpu_torch.tools import extra_op_cases as xc
    outs = xc.forward(xc.CASES["warpctc"], "cpu")
    grads = xc.grad(xc.CASES["warpctc"], "cpu", outs)

Each case holds numpy inputs made from a seed, attrs, the tolerance of its
outputs and gradients (``op_cases.Case``), the output slots that get a
seeded cotangent, and ``scatters``: the gradient (or the op) adds rows by
index, so the card runs it twice and holds the two bit for bit.
``tests/test_torch_extra_ops.py`` holds every case against the JAX lowering
on the CPU, forward and generic grad; ``chip_smoke.py`` phase 24 C runs each
on the card against the CPU port, captured in a CUDA graph, except
``py_func``, whose capture is refused.

Tolerances: float32 ``atol 1e-5, rtol 1e-5`` (transcendental functions and
sums rounded in other orders, a few ulps), ``EXACT`` for integer outputs and
for counts held in float32 (``edit_distance``). ``RANDOM`` names the cases
whose ops draw from the port's counter-derived generator: the JAX package
draws from its own, so the CPU tests hold them by statistics (``nce``
through the JAX lowering with the port's negatives); the card holds them
against the CPU port, which draws the same numbers from the same seed.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core import registry
from .op_cases import F32_TOL, Case, r
# the cases run as vision_cases' do: forward(c, device), grad_inputs(c, outs),
# grad(c, device, outs)
from .vision_cases import _tensors, forward, grad, grad_inputs  # noqa: F401

EXACT = dict(atol=0.0, rtol=0.0)
#: warpctc's loss is a sum of 10-70 log-sum-exps over the steps (a few ulps
#: of it each) and its infeasible rows sit near 1e30
CTC_TOL = dict(atol=1e-4, rtol=1e-5)

CASES: Dict[str, Case] = {}
#: the cases whose ops draw random numbers
RANDOM = frozenset({"sampling_id", "uniform_random_batch_size_like",
                    "gaussian_random_batch_size_like", "random_crop", "nce", "nce-no-bias"})


def _case(name, op, ins, attrs=None, grad=("Out",), scatters=False, tol=None):
    assert name not in CASES, name
    tol = tol or F32_TOL
    CASES[name] = Case(op, ins, dict(attrs or {}), "float32", tol, tuple(grad), scatters, tol, {})


def ids(shape, hi, seed, lo=0, dtype="int64"):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(dtype)


def lens(*v):
    return np.array(v, "int64")


def _pool_indices(x, k):
    """max_pool2d_with_index's Mask of x (n, c, h, w) over k x k windows."""
    n, c, h, w = x.shape
    xb = x.reshape(n, c, h // k, k, w // k, k).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(n, c, h // k, w // k, k * k)
    win = xb.argmax(-1)
    rows = np.arange(h // k)[:, None] * k + win // k
    cols = np.arange(w // k)[None, :] * k + win % k
    return (rows * w + cols).astype("int32")


# -- CTC ---------------------------------------------------------------------
_case("warpctc", "warpctc",
      {"Logits": [r(4, 7, 5, seed=1)], "Label": [ids((4, 3), 5, 2, lo=1)],
       "LogitsLength": [lens(7, 6, 5, 7)], "LabelLength": [lens(3, 2, 1, 0)]},
      {"blank": 0}, grad=("Loss",), tol=CTC_TOL)
_case("warpctc-norm-blank-last", "warpctc",
      {"Logits": [r(3, 6, 6, seed=3)], "Label": [ids((3, 4), 5, 4)],
       "LogitsLength": [lens(6, 6, 4)], "LabelLength": [lens(4, 2, 3)]},
      {"blank": 5, "norm_by_times": True}, grad=("Loss",), tol=CTC_TOL)
# row 0 needs 5 steps for [1, 1, 1] (blanks between the repeats) and has 4;
# row 1's label is longer than its steps: a loss near 1e30 in both packages.
# Its gradient is rounding at -1e30 (a log-add-exp of two equal states passes
# 1, not 1/2, to each), defined by neither package: the loss only
_case("warpctc-infeasible", "warpctc",
      {"Logits": [r(2, 4, 3, seed=5)], "Label": [np.array([[1, 1, 1], [1, 2, 1]], "int64")],
       "LogitsLength": [lens(4, 2)], "LabelLength": [lens(3, 3)]},
      {"blank": 0}, grad=(), tol=CTC_TOL)
# rows with just enough steps: [1, 1] in 3, [2, 3, 2] in 3
_case("warpctc-tight", "warpctc",
      {"Logits": [r(2, 3, 4, seed=4)], "Label": [np.array([[1, 1, 0], [2, 3, 2]], "int64")],
       "LogitsLength": [lens(3, 3)], "LabelLength": [lens(2, 3)]},
      {"blank": 0}, grad=("Loss",), tol=CTC_TOL)
_case("ctc_align", "ctc_align",
      {"Input": [np.round(r(3, 9, 4, seed=6), 1)], "InputLength": [lens(9, 5, 0)]},
      {"blank": 0, "padding_value": -1}, grad=())

# -- sequence ----------------------------------------------------------------
_case("im2sequence", "im2sequence", {"X": [r(2, 3, 6, 8, seed=7)]},
      {"kernels": [3, 2], "strides": [1, 2]})
_case("im2sequence-ocr", "im2sequence", {"X": [r(2, 4, 6, 5, seed=8)]},
      {"kernels": [6, 1], "strides": [1, 1]})
_case("sequence_mask", "sequence_mask", {"X": [lens(3, 0, 6)]},
      {"maxlen": 6, "out_dtype": "int64"}, grad=())
_case("sequence_mask-float", "sequence_mask", {"X": [lens(2, 5)]},
      {"maxlen": 5, "out_dtype": "float32"}, grad=())
_case("sequence_softmax", "sequence_softmax",
      {"X": [r(3, 6, seed=9)], "Length": [lens(6, 2, 1)]})
_case("sequence_expand", "sequence_expand", {"X": [r(3, 4, seed=10)]},
      {"ref_lengths": [2, 0, 3]}, scatters=True)
_case("sequence_expand-times", "sequence_expand", {"X": [r(3, 2, 2, seed=11)]},
      {"expand_times": 3}, scatters=True)
_case("sequence_expand_as", "sequence_expand_as",
      {"X": [r(3, 4, seed=12)], "Y": [r(5, 4, seed=13)]}, {"ref_lengths": [1, 3, 1]},
      scatters=True)
_case("sequence_concat", "sequence_concat", {"X": [r(2, 3, 4, seed=14), r(2, 3, 2, seed=15)]})
# sequence_pad names Length on both sides, which neither package's generic grad
# op takes (make_grad_op_descs refuses the clash): no gradient case
_case("sequence_pad", "sequence_pad", {"X": [r(3, 5, 2, seed=16)], "Length": [lens(5, 3, 0)]},
      {"pad_value": 1.5}, grad=())
_case("sequence_pad-tensor", "sequence_pad",
      {"X": [r(3, 5, seed=17)], "Length": [lens(1, 4, 5)],
       "PadValue": [np.array([-2.0], "float32")]}, grad=())
_case("sequence_slice", "sequence_slice",
      {"X": [r(3, 6, 2, seed=18)], "Offset": [np.array([[0], [2], [3]], "int64")]},
      {"out_len": 3})
_case("sequence_enumerate", "sequence_enumerate",
      {"X": [ids((3, 6), 9, 19)], "Length": [lens(6, 4, 1)]}, {"win_size": 3, "pad_value": 0},
      grad=())
_case("sequence_erase", "sequence_erase",
      {"X": [ids((3, 7), 6, 20)], "Length": [lens(7, 5, 2)]}, {"tokens": [2, 5]}, grad=())
_case("sequence_reshape", "sequence_reshape", {"X": [r(2, 6, 4, seed=21)]}, {"new_dim": 8})
_case("sequence_scatter", "sequence_scatter",
      {"X": [r(3, 5, seed=22)], "Ids": [np.array([[0, 2, 2, 4], [1, 1, 1, 0], [4, 3, 2, 1]],
                                                 "int64")],
       "Updates": [r(3, 4, seed=23)]}, scatters=True)

# -- extra_ops: vision / tensor rearranges -----------------------------------
_case("maxout", "maxout", {"X": [r(2, 6, 3, 3, seed=24)]}, {"groups": 2})
_case("lrn", "lrn", {"X": [r(2, 6, 3, 3, seed=25)]}, {"n": 5, "alpha": 0.1, "beta": 0.75})
_case("multiplex", "multiplex",
      {"X": [r(4, 3, seed=26), r(4, 3, seed=27), r(4, 3, seed=28)],
       "Ids": [np.array([[2], [0], [1], [2]], "int32")]}, scatters=True)
_case("pixel_shuffle", "pixel_shuffle", {"X": [r(2, 8, 3, 3, seed=29)]}, {"upscale_factor": 2})
_case("shuffle_channel", "shuffle_channel", {"X": [r(2, 6, 3, 3, seed=30)]}, {"group": 3})
_case("temporal_shift", "temporal_shift", {"X": [r(6, 8, 2, 2, seed=31)]}, {"seg_num": 3})
_case("unfold", "unfold", {"X": [r(2, 3, 6, 6, seed=32)]},
      {"kernel_sizes": [3, 3], "strides": [2, 1], "paddings": [1, 1], "dilations": [1, 2]})
_case("affine_channel", "affine_channel",
      {"X": [r(2, 3, 4, 4, seed=33)], "Scale": [r(3, seed=34)], "Bias": [r(3, seed=35)]})
_case("bilinear_tensor_product", "bilinear_tensor_product",
      {"X": [r(4, 3, seed=36)], "Weight": [r(5, 3, 2, seed=37)], "Y": [r(4, 2, seed=38)],
       "Bias": [r(1, 5, seed=39)]})
_case("add_position_encoding", "add_position_encoding", {"X": [r(2, 5, 6, seed=40)]},
      {"alpha": 0.5, "beta": 2.0})
_case("mean_iou", "mean_iou",
      {"Predictions": [ids((12,), 4, 41, dtype="int32")],
       "Labels": [ids((12,), 4, 42, dtype="int32")]}, {"num_classes": 5}, grad=())
_case("crop_tensor", "crop_tensor", {"X": [r(4, 5, seed=43)]},
      {"offsets": [1, 2], "shape": [2, 3]})
_case("crop_tensor-clamped", "crop_tensor", {"X": [r(4, 5, seed=44)]},
      {"offsets": [3, 4], "shape": [2, 3]})
_case("pad_constant_like", "pad_constant_like",
      {"X": [r(4, 6, seed=45)], "Y": [r(3, 4, seed=46)]}, {"pad_value": 2.0})

# -- extra_ops: losses -------------------------------------------------------
_case("rank_loss", "rank_loss",
      {"Label": [np.array([[1], [0], [1], [0], [1]], "float32")], "Left": [r(5, 1, seed=47)],
       "Right": [r(5, 1, seed=48)]})
_case("margin_rank_loss", "margin_rank_loss",
      {"Label": [np.array([[1], [-1], [1], [-1], [1]], "float32")], "X1": [r(5, 1, seed=49)],
       "X2": [r(5, 1, seed=50)]}, {"margin": 0.1})
_case("bpr_loss", "bpr_loss", {"X": [r(4, 5, seed=51)], "Label": [ids((4, 1), 5, 52)]})
for red in ("mean", "sum", "batchmean", "none"):
    t = r(3, 4, seed=54, lo=0.0, hi=1.0)
    t[0, 1] = t[2, 3] = 0.0
    _case(f"kldiv_loss-{red}", "kldiv_loss", {"X": [r(3, 4, seed=53)], "Target": [t]},
          {"reduction": red}, grad=("Loss",))
_case("teacher_student_sigmoid_loss", "teacher_student_sigmoid_loss",
      {"X": [r(6, 1, seed=55)],
       "Label": [np.array([[-2], [-1], [0.3], [1.4], [0.0], [1.0]], "float32")]}, grad=("Y",))
_case("row_conv", "row_conv", {"X": [r(2, 5, 3, seed=56)], "Filter": [r(3, 3, seed=57)]})
_case("gather_tree", "gather_tree",
      {"Ids": [ids((4, 2, 3), 9, 58)], "Parents": [ids((4, 2, 3), 3, 59)]}, grad=())

# -- extra_ops: random --------------------------------------------------------
_case("sampling_id", "sampling_id",
      {"X": [np.tile(np.array([[0.1, 0.2, 0.3, 0.4]], "float32"), (4000, 1))]}, grad=())
_case("uniform_random_batch_size_like", "uniform_random_batch_size_like",
      {"Input": [r(400, 3, seed=60)]},
      {"shape": [-1, 250], "min": -2.0, "max": 3.0, "dtype": "float32"}, grad=())
_case("gaussian_random_batch_size_like", "gaussian_random_batch_size_like",
      {"Input": [r(400, 3, seed=61)]},
      {"shape": [-1, 250], "mean": 0.5, "std": 2.0, "dtype": "float32"}, grad=())
_case("random_crop", "random_crop", {"X": [r(3, 8, 9, seed=62)]}, {"shape": [5, 4]}, grad=())

# -- extra_ops: edit distance, hash, unique -----------------------------------
_hyps = ids((5, 6), 4, 63)
_refs = ids((5, 5), 4, 64)
for norm in (True, False):
    _case(f"edit_distance-{'normalized' if norm else 'raw'}", "edit_distance",
          {"Hyps": [_hyps], "Refs": [_refs], "HypsLength": [lens(6, 3, 0, 5, 2)],
           "RefsLength": [lens(5, 5, 2, 0, 4)]}, {"normalized": norm}, grad=(), tol=EXACT)
_case("hash", "hash",
      {"X": [np.array([[0], [1], [7], [123456789], [2 ** 31 - 1], [99991]], "int64")]},
      {"num_hash": 3, "mod_by": 10007}, grad=(), tol=EXACT)
_case("unique_with_counts", "unique_with_counts",
      {"X": [np.array([3, 1, 3, 2, 5, 1, 1, 9], "int64")]}, grad=(), tol=EXACT)
_case("unique_with_counts-float", "unique_with_counts",
      {"X": [np.array([2.0, -1.0, 2.0, 7.0, -1.0], "float32")]}, grad=(), tol=EXACT)

# -- extra_ops: state ---------------------------------------------------------
_case("spectral_norm", "spectral_norm",
      {"Weight": [r(4, 3, 2, seed=65)], "U": [r(4, seed=66)], "V": [r(6, seed=67)]},
      {"dim": 0, "power_iters": 2, "eps": 1e-12})
_case("spectral_norm-dim1", "spectral_norm",
      {"Weight": [r(4, 3, 2, seed=68)], "U": [r(3, seed=69)], "V": [r(8, seed=70)]},
      {"dim": 1, "power_iters": 1, "eps": 1e-12})
_case("center_loss", "center_loss",
      {"X": [r(6, 3, seed=71)], "Label": [np.array([[0], [2], [0], [1], [0], [2]], "int64")],
       "Centers": [r(3, 3, seed=72)], "CenterUpdateRate": [np.array([0.5], "float32")]},
      {"need_update": True}, grad=("Loss",), scatters=True)
_case("data_norm", "data_norm",
      {"X": [r(4, 3, seed=73)], "BatchSize": [np.full(3, 1e4, "float32")],
       "BatchSum": [r(3, seed=74, scale=10.0)], "BatchSquareSum": [np.full(3, 2e4, "float32")]},
      {"epsilon": 1e-4}, grad=("Y",))
_case("affine_grid", "affine_grid", {"Theta": [r(2, 2, 3, seed=75)]},
      {"output_shape": [2, 1, 4, 5]}, grad=("Output",))
_case("grid_sampler", "grid_sampler",
      {"X": [r(2, 3, 4, 5, seed=76)], "Grid": [r(2, 3, 3, 2, seed=77, lo=-0.95, hi=0.95)]},
      grad=("Output",), scatters=True)
_case("tree_conv", "tree_conv",
      {"NodesVector": [r(2, 5, 3, seed=78)],
       "EdgeSet": [np.array([[[1, 2], [1, 3], [2, 4], [2, 5]], [[1, 2], [2, 3], [0, 0], [0, 0]]],
                            "int64")],
       "Filter": [r(3, 3, 2, 2, seed=79)]}, {"max_depth": 3}, scatters=True)


def _py_func_double(x):
    return np.asarray(x) * 2.0 + 1.0


def py_func_key(table) -> int:
    """``_py_func_double``'s key in a package's py_func table
    (``layers.extras._PYFUNC_TABLE``), registered there on first use."""
    for k, f in table.items():
        if f is _py_func_double:
            return k
    key = len(table)
    table[key] = _py_func_double
    return key


def py_func_case(table) -> Case:
    """``py_func`` over ``_py_func_double``, keyed in ``table``."""
    return Case("py_func", {"X": [r(3, 4, seed=80)]},
                {"func_key": py_func_key(table), "out_shapes": [[3, 4]],
                 "out_dtypes": ["float32"]}, "float32", F32_TOL, (), False, F32_TOL, {})


# -- tail_ops -----------------------------------------------------------------
_case("selu", "selu", {"X": [r(3, 4, seed=81)]})
_case("hinge_loss", "hinge_loss",
      {"Logits": [r(5, 1, seed=82)], "Labels": [np.array([[1], [0], [1], [0], [1]], "float32")]},
      grad=("Loss",))
_case("modified_huber_loss", "modified_huber_loss",
      {"X": [np.array([[-2.5], [-0.5], [0.3], [1.7], [-1.4], [0.9]], "float32")],
       "Y": [np.array([[1], [1], [0], [1], [0], [0]], "float32")]})
_case("squared_l2_distance", "squared_l2_distance",
      {"X": [r(4, 3, seed=83)], "Y": [r(1, 3, seed=84)]})
_case("l1_norm", "l1_norm", {"X": [r(3, 4, seed=85)]})
_case("minus", "minus", {"X": [r(3, 4, seed=86)], "Y": [r(3, 4, seed=87)]})
_case("norm", "norm", {"X": [r(3, 4, 2, seed=88)]}, {"axis": 1, "epsilon": 1e-10})
_case("size", "size", {"Input": [r(3, 4, seed=89)]}, grad=(), tol=EXACT)
_case("fill", "fill", {}, {"shape": [2, 3], "value": [1.5, -2.0, 0.25, 3.0, 7.0, -0.5],
                           "dtype": "float32"}, grad=())
_case("fill-int", "fill", {}, {"shape": [3], "value": [4.0, -1.0, 9.0], "dtype": "int32"},
      grad=(), tol=EXACT)
_case("fill_zeros_like2", "fill_zeros_like2", {"X": [r(2, 3, seed=90)]}, {"dtype": "int32"},
      grad=())
_case("crop", "crop", {"X": [r(4, 5, seed=91)]}, {"offsets": [1, 1], "shape": [2, 3]})
_case("crop-like", "crop", {"X": [r(4, 5, seed=92)], "Y": [r(3, 2, seed=93)]},
      {"offsets": [0, 2]})
_case("fc", "fc", {"Input": [r(2, 3, 4, seed=94)], "W": [r(12, 5, seed=95)],
                   "Bias": [r(5, seed=96)]}, {"in_num_col_dims": 1})
_case("fc-2d", "fc", {"Input": [r(2, 3, 4, seed=97)], "W": [r(4, 5, seed=98)]},
      {"in_num_col_dims": 2})
_cvm_x = np.abs(r(4, 5, seed=99)) * 3.0
_case("cvm", "cvm", {"X": [_cvm_x]}, {"use_cvm": True}, grad=("Y",))
_case("cvm-drop", "cvm", {"X": [_cvm_x]}, {"use_cvm": False}, grad=("Y",))
_case("conv_shift", "conv_shift", {"X": [r(3, 6, seed=100)], "Y": [r(3, 3, seed=101)]})
_mp_x = r(2, 3, 4, 6, seed=102)
_case("max_pool2d_with_index", "max_pool2d_with_index", {"X": [_mp_x]},
      {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]})
_case("unpool", "unpool",
      {"X": [r(2, 3, 2, 3, seed=103)], "Indices": [_pool_indices(_mp_x, 2)]},
      {"unpool_size": [4, 6], "ksize": [2, 2], "strides": [2, 2]}, scatters=True)
_case("spp-max", "spp", {"X": [r(2, 3, 5, 7, seed=104)]},
      {"pyramid_height": 3, "pooling_type": "max"})
_case("spp-avg", "spp", {"X": [r(2, 3, 5, 7, seed=105)]},
      {"pyramid_height": 2, "pooling_type": "avg"})
_case("depthwise_conv2d_transpose", "depthwise_conv2d_transpose",
      {"Input": [r(2, 3, 4, 4, seed=106)], "Filter": [r(3, 1, 3, 3, seed=107)]},
      {"strides": [2, 2], "paddings": [1, 1]}, grad=("Output",))
_case("proximal_adagrad", "proximal_adagrad",
      {"Param": [r(3, 4, seed=108)], "Grad": [r(3, 4, seed=109)],
       "Moment": [r(3, 4, seed=110, lo=0.1, hi=1.0)], "LearningRate": [np.array([0.1], "float32")]},
      {"l1": 0.01, "l2": 0.02}, grad=())
_case("proximal_adagrad-l2", "proximal_adagrad",
      {"Param": [r(3, 4, seed=111)], "Grad": [r(3, 4, seed=112)],
       "Moment": [r(3, 4, seed=113, lo=0.1, hi=1.0)], "LearningRate": [np.array([0.1], "float32")]},
      {"l1": 0.0, "l2": 0.02}, grad=())
_dx = r(2, 4, 5, 5, seed=114)
_case("deformable_conv", "deformable_conv",
      {"Input": [_dx], "Offset": [r(2, 18, 5, 5, seed=115, scale=0.7)],
       "Mask": [r(2, 9, 5, 5, seed=116, lo=0.1, hi=1.0)], "Filter": [r(6, 4, 3, 3, seed=117)]},
      {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1], "groups": 1,
       "deformable_groups": 1}, grad=("Output",), scatters=True)
_case("deformable_conv-groups", "deformable_conv",
      {"Input": [_dx], "Offset": [r(2, 36, 3, 3, seed=118, scale=0.7)],
       "Mask": [r(2, 18, 3, 3, seed=119, lo=0.1, hi=1.0)], "Filter": [r(4, 2, 3, 3, seed=120)]},
      {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1], "groups": 2,
       "deformable_groups": 2}, grad=("Output",), scatters=True)
_case("deformable_conv_v1", "deformable_conv_v1",
      {"Input": [_dx], "Offset": [r(2, 18, 3, 3, seed=121, scale=0.7)],
       "Filter": [r(6, 4, 3, 3, seed=122)]},
      {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1], "groups": 1,
       "deformable_groups": 1}, grad=("Output",), scatters=True)
_case("similarity_focus", "similarity_focus", {"X": [r(2, 3, 4, 5, seed=123)]},
      {"axis": 1, "indexes": [0, 2]}, grad=())

# -- sampled / metrics ---------------------------------------------------------
_case("nce", "nce",
      {"Input": [r(6, 4, seed=124)], "Label": [ids((6, 1), 20, 125)],
       "Weight": [r(20, 4, seed=126)], "Bias": [r(20, seed=127)]},
      {"num_total_classes": 20, "num_neg_samples": 5}, grad=("Cost",), scatters=True)
_case("nce-no-bias", "nce",
      {"Input": [r(6, 4, seed=128)], "Label": [ids((6, 1), 20, 129)],
       "Weight": [r(20, 4, seed=130)]},
      {"num_total_classes": 20, "num_neg_samples": 8}, grad=("Cost",), scatters=True)
_case("hsigmoid", "hsigmoid",
      {"Input": [r(6, 3, seed=131)], "Label": [ids((6, 1), 5, 132)], "W": [r(7, 3, seed=133)],
       "Bias": [r(7, 1, seed=134)]}, {"num_classes": 5}, grad=("Cost",), scatters=True)
for scheme, nct in (("IOB", 2), ("IOE", 2), ("IOBES", 2), ("plain", 3)):
    tags = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme] * nct + 1
    _case(f"chunk_eval-{scheme}", "chunk_eval",
          {"Inference": [ids((3, 10), tags, 135)], "Label": [ids((3, 10), tags, 136)],
           "SeqLength": [lens(10, 7, 3)]},
          {"chunk_scheme": scheme, "num_chunk_types": nct,
           "excluded_chunk_types": [1] if scheme == "IOB" else []}, grad=())

#: every op type of the table
EXTRA_TYPES = frozenset(c.op for c in CASES.values()) | {"py_func"}


def grad_slots(c: Case):
    """The input slots whose gradient the generic grad op gives: the float
    slots the op does not declare non-differentiable."""
    nondiff = registry.get(c.op).nondiff_inputs
    return [s for s, v in c.ins.items()
            if np.asarray(v[0]).dtype.kind == "f" and s not in nondiff]



def build_state_program(pkg, width: int = 5, classes: int = 3, seed: int = 0):
    """A training program over the ops that write state back and one that
    draws: ``data_norm`` (its three accumulators), ``center_loss`` (its
    centers), ``spectral_norm`` of a parameter (its U and V) and a
    ``uniform_random_batch_size_like`` noise added to the input, under SGD
    0.1. Feeds ``x`` [B, 3] float32 and ``l`` [B, 1] int64; returns (main,
    startup, loss, noise). Built by ``pkg``'s DSL (the tests pass the JAX
    package too)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    A = dict(append_batch_size=False)
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        L = pkg.layers
        x = pkg.data("x", [-1, 3], "float32", **A)
        label = pkg.data("l", [-1, 1], "int64", **A)
        noise = L.uniform_random_batch_size_like(x, [-1, 3], min=-0.01, max=0.01)
        h = L.fc(L.data_norm(L.elementwise_add(x, noise)), width, act="tanh")
        w = L.create_parameter([width, 4], "float32", name="sn_w")
        sn = L.spectral_norm(w, dim=0, power_iters=1)
        loss = L.elementwise_add(L.mean(L.center_loss(h, label, classes, 0.5)),
                                 L.mean(L.matmul(h, sn)))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup, loss, noise


def state_feed(batch: int, classes: int = 3, seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(batch, 3).astype("float32"),
            "l": rng.randint(0, classes, (batch, 1)).astype("int64")}
