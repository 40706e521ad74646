"""The port's generic ``<op>_grad`` against the JAX package's, op by op, on
the same numpy inputs and cotangents; the backward pass's plumbing.

Each case lowers ``<op>_grad`` in both registries with the grad op's own
slots (forward inputs, forward outputs, ``<Out>@GRAD`` cotangents) and attrs
(``__fwd_attrs__``, ``__fwd_out_slots__``, ``__fwd_out0__``), as
``append_backward`` builds them. Tolerance: float32 ``atol 1e-5, rtol
1e-5`` (the two frameworks sum in other orders; attention and the matmuls
``atol 5e-5``, the JAX attention suite's own, tests/test_pallas_attention.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX op library)
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg

TOL = dict(atol=1e-5, rtol=1e-5)
SUM_TOL = dict(atol=5e-5, rtol=1e-5)


def _r(*shape, scale=1.0, seed=None):
    seed = sum(shape) if seed is None else seed
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("float32")


def _ids(shape, hi, seed=1):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


# id -> (op type, forward inputs, attrs, output slots that get a cotangent, tolerance)
CASES = {
    "elementwise_add": ("elementwise_add", {"X": [_r(2, 3, 4)], "Y": [_r(4)]},
                        {"axis": -1}, ("Out",), TOL),
    "elementwise_add-axis": ("elementwise_add", {"X": [_r(2, 3, 4)], "Y": [_r(3)]},
                             {"axis": 1}, ("Out",), TOL),
    "mul": ("mul", {"X": [_r(2, 3, 16)], "Y": [_r(16, 8)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}, ("Out",), SUM_TOL),
    "matmul": ("matmul", {"X": [_r(2, 2, 5, 8)], "Y": [_r(2, 2, 6, 8)]},
               {"transpose_X": False, "transpose_Y": True, "alpha": 0.35}, ("Out",), SUM_TOL),
    "matmul-2d": ("matmul", {"X": [_r(6, 16)], "Y": [_r(20, 16)]},
                  {"transpose_Y": True}, ("Out",), SUM_TOL),
    "softmax": ("softmax", {"X": [_r(3, 4, 9, scale=3.0)]}, {"axis": -1}, ("Out",), TOL),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy",
                                   {"Logits": [_r(6, 11, scale=2.0)], "Label": [_ids((6, 1), 11)]},
                                   {"soft_label": False, "ignore_index": -100, "axis": -1},
                                   ("Loss",), TOL),
    "mean": ("mean", {"X": [_r(4, 7)]}, {}, ("Out",), TOL),
    "slice": ("slice", {"Input": [_r(3, 5, 4)]}, {"axes": [1], "starts": [0], "ends": [1]},
              ("Out",), TOL),
    "gather": ("gather", {"X": [_r(12, 8)], "Index": [_ids((7, 1), 12, seed=5)]},
               {"axis": 0}, ("Out",), TOL),
    "top_k": ("top_k", {"X": [_r(5, 9)]}, {"k": 2}, ("Out",), TOL),
    # ties: Out's gradient lands on the entries Indices names, the lower first
    "top_k-ties": ("top_k", {"X": [np.array([[1, 3, 3, 2, 3]], "float32")]}, {"k": 2},
                   ("Out",), TOL),
    "top_k-ties-64x50": ("top_k", {"X": [_ids((64, 50), 3, seed=7).astype("float32")]},
                         {"k": 5}, ("Out",), TOL),
    # non-finite points and 0^0 (ROADMAP 3.20): at a NaN input the clips and
    # min / max pass no gradient; hard_swish at +-inf and pow's dX at 0^0 are NaN
    "relu6-nan": ("relu6", {"X": [np.array([np.nan, -1, 3, 6, 7, 0], "float32")]},
                  {"threshold": 6.0}, ("Out",), TOL),
    "brelu-nan": ("brelu", {"X": [np.array([np.nan, -1, 3, 24, 30, 0], "float32")]},
                  {"t_min": 0.0, "t_max": 24.0}, ("Out",), TOL),
    "hard_sigmoid-nan": ("hard_sigmoid", {"X": [np.array([np.nan, -3, 0, 2.5, 5], "float32")]},
                         {"slope": 0.2, "offset": 0.5}, ("Out",), TOL),
    "hard_swish-inf": ("hard_swish", {"X": [np.array([np.inf, -np.inf, 1, -3, 3], "float32")]},
                       {"scale": 6.0, "offset": 0.5, "threshold": 6.0}, ("Out",), TOL),
    "elementwise_min-nan": ("elementwise_min",
                            {"X": [np.array([np.nan, 1, 2, 3], "float32")],
                             "Y": [np.array([1, np.nan, 2, 1], "float32")]},
                            {"axis": -1}, ("Out",), TOL),
    "elementwise_max-nan": ("elementwise_max",
                            {"X": [np.array([np.nan, 1, 2, 3], "float32")],
                             "Y": [np.array([1, np.nan, 2, 1], "float32")]},
                            {"axis": -1}, ("Out",), TOL),
    "elementwise_pow-zero": ("elementwise_pow",
                             {"X": [np.array([0.0, -0.0, 0.0, -0.0, 2.0], "float32")],
                              "Y": [np.array([0.0, 0.0, -0.0, -0.0, 3.0], "float32")]},
                             {"axis": -1}, ("Out",), TOL),
    "assign": ("assign", {"X": [_r(3, 4)]}, {}, ("Out",), TOL),
    "sum": ("sum", {"X": [_r(3, 4), _r(3, 4, seed=9), _r(3, 4, seed=10)]}, {}, ("Out",), TOL),
    "tanh": ("tanh", {"X": [_r(4, 6, scale=2.0)]}, {}, ("Out",), TOL),
    "gelu-tanh": ("gelu", {"X": [_r(4, 16, scale=2.0)]}, {"approximate": True}, ("Out",), TOL),
    "layer_norm": ("layer_norm", {"X": [_r(2, 5, 16, scale=2.0)], "Scale": [_r(16)],
                                  "Bias": [_r(16, seed=3)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}, ("Y",), TOL),
    "cast": ("cast", {"X": [_r(4, 8)]}, {"in_dtype": "float32", "out_dtype": "float32"},
             ("Out",), TOL),
    "scale": ("scale", {"X": [_r(3, 7)]}, {"scale": 2.5, "bias": -1.0,
                                           "bias_after_scale": True}, ("Out",), TOL),
    "reshape2": ("reshape2", {"X": [_r(2, 6, 4)]}, {"shape": [0, -1, 2, 2]}, ("Out",), TOL),
    "transpose2": ("transpose2", {"X": [_r(2, 3, 4, 5)]}, {"axis": [0, 2, 1, 3]},
                   ("Out",), TOL),
    "unsqueeze2": ("unsqueeze2", {"X": [_r(2, 3)]}, {"axes": [1, 3]}, ("Out",), TOL),
    "split": ("split", {"X": [_r(2, 4, 9)]}, {"num": 3, "sections": [], "axis": 2},
              ("Out",), TOL),
    "lookup_table_v2": ("lookup_table_v2", {"W": [_r(20, 8)], "Ids": [_ids((2, 5), 20)]},
                        {"padding_idx": -1}, ("Out",), TOL),
    "dropout-p0": ("dropout", {"X": [_r(4, 8)]},
                   {"dropout_prob": 0.0, "is_test": False,
                    "dropout_implementation": "upscale_in_train"}, ("Out",), TOL),
    "fused_attention": ("fused_attention",
                        {"Q": [_r(2, 2, 16, 8)], "K": [_r(2, 2, 16, 8, seed=3)],
                         "V": [_r(2, 2, 16, 8, seed=4)],
                         "Bias": [np.where(_r(2, 1, 1, 16) > -1.0, 0.0, -1e4)
                                  .astype("float32")]},
                        {"scale": 0.0, "is_test": False, "dropout_prob": 0.0,
                         "causal": False, "impl": "auto"}, ("Out",), SUM_TOL),
    "fused_attention-causal": ("fused_attention",
                               {"Q": [_r(1, 2, 16, 8)], "K": [_r(1, 2, 16, 8, seed=5)],
                                "V": [_r(1, 2, 16, 8, seed=6)]},
                               {"scale": 0.3, "is_test": True, "causal": True,
                                "impl": "composed"}, ("Out",), SUM_TOL),
    # the detection and vision ops (ops/detection_ops.py, ops/nn_ops.py)
    "yolov3_loss": ("yolov3_loss",
                    {"X": [_r(1, 21, 4, 4, scale=1.5)],
                     "GTBox": [np.array([[[0.3, 0.6, 0.47, 0.47], [0.32, 0.62, 0.47, 0.48],
                                          [0, 0, 0, 0]]], "float32")],
                     "GTLabel": [np.array([[1, 0, 0]], "int32")]},
                    {"anchors": [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119, 116, 90,
                                 156, 198, 373, 326], "anchor_mask": [3, 4, 5], "class_num": 2,
                     "ignore_thresh": 0.5, "downsample_ratio": 32, "use_label_smooth": False},
                    ("Loss",), TOL),
    "roi_align": ("roi_align", {"X": [_r(1, 2, 6, 6)],
                                "ROIs": [np.array([[0.5, 1.0, 4.5, 5.0], [2.0, 0.0, 5.5, 3.5]],
                                                  "float32")]},
                  {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0,
                   "sampling_ratio": 2}, ("Out",), TOL),
    "roi_pool": ("roi_pool", {"X": [_r(1, 2, 6, 6, seed=3)],
                              "ROIs": [np.array([[0.0, 1.0, 4.0, 5.0], [2.0, 0.0, 5.0, 3.0]],
                                                "float32")]},
                 {"pooled_height": 2, "pooled_width": 2, "spatial_scale": 1.0}, ("Out",), TOL),
    "sigmoid_focal_loss": ("sigmoid_focal_loss",
                           {"X": [_r(4, 3, scale=2.0)],
                            "Label": [np.array([[0], [1], [3], [2]], "int32")],
                            "FgNum": [np.array([3], "int32")]},
                           {"gamma": 2.0, "alpha": 0.25}, ("Out",), TOL),
    "interpolate-bilinear": ("interpolate", {"X": [_r(1, 2, 4, 5)]},
                             {"interp_method": "bilinear", "out_h": 6, "out_w": 3, "scale": 0.0},
                             ("Out",), TOL),
    "interpolate-nearest": ("interpolate", {"X": [_r(1, 2, 3, 4)]},
                            {"interp_method": "nearest", "out_h": 5, "out_w": 7, "scale": 0.0},
                            ("Out",), TOL),
    "conv2d_transpose": ("conv2d_transpose", {"Input": [_r(1, 4, 3, 3)],
                                              "Filter": [_r(4, 2, 4, 4, scale=0.5)]},
                         {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
                          "groups": 2}, ("Output",), SUM_TOL),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def _grad_ins_and_attrs(op_type, ins, attrs, cot_slots, skip=()):
    """The grad op's inputs (numpy) and attrs, as make_grad_op_descs builds
    them: forward outputs from the JAX forward, a seeded cotangent for each
    float entry of ``cot_slots`` (None for the (slot, index) in ``skip``)."""
    fwd = jreg.get(op_type).lower(jreg.LowerCtx(dict(attrs)),
                                  {s: [jnp.asarray(a) for a in v] for s, v in ins.items()})
    gins = {s: list(v) for s, v in ins.items()}
    for s, vals in fwd.items():
        gins[s] = [None if v is None else np.asarray(v) for v in vals]
        if s in cot_slots:
            gins[s + "@GRAD"] = [
                None if (s, i) in skip or v is None
                else _r(*np.shape(v), seed=100 + i).reshape(np.shape(v))
                for i, v in enumerate(vals)]
    gattrs = dict(attrs, __fwd_attrs__=dict(attrs), __fwd_out_slots__=sorted(fwd),
                  __fwd_out0__="out0")
    return gins, gattrs


def _grad_both(op_type, gins, gattrs):
    jouts = jreg.get(op_type + "_grad").lower(
        jreg.LowerCtx(dict(gattrs)),
        {s: [None if a is None else jnp.asarray(a) for a in v] for s, v in gins.items()})
    touts = treg.get(op_type + "_grad").lower(
        treg.LowerCtx(dict(gattrs)),
        {s: [None if a is None else torch.from_numpy(np.array(a)) for a in v]
         for s, v in gins.items()})
    return jouts, touts


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_grad_matches_jax(case):
    op_type, ins, attrs, cot_slots, tol = CASES[case]
    gins, gattrs = _grad_ins_and_attrs(op_type, ins, attrs, cot_slots)
    jouts, touts = _grad_both(op_type, gins, gattrs)
    assert sorted(touts) == sorted(jouts)
    compared = 0
    for slot, tvals in touts.items():
        assert len(tvals) == len(jouts[slot])
        for j, t in zip(jouts[slot], tvals):
            a, b = _np(j), _np(t)
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            np.testing.assert_allclose(b, a, err_msg=f"{case} {slot}", **tol)
            compared += 1
    assert compared >= 1


def test_missing_cotangent_counts_as_zero():
    """split with one output's cotangent absent (@EMPTY@): the JAX package
    takes zeros for it, and so does the port."""
    op_type, ins, attrs, cot_slots, tol = CASES["split"]
    gins, gattrs = _grad_ins_and_attrs(op_type, ins, attrs, cot_slots, skip={("Out", 1)})
    jouts, touts = _grad_both(op_type, gins, gattrs)
    g = _np(touts["X@GRAD"][0])
    np.testing.assert_allclose(g, _np(jouts["X@GRAD"][0]), **tol)
    assert not g[:, :, 3:6].any() and g[:, :, :3].any()


def test_no_cotangent_gives_zero_grads():
    op_type, ins, attrs, _, _ = CASES["mul"]
    gins, gattrs = _grad_ins_and_attrs(op_type, ins, attrs, ())
    _, touts = _grad_both(op_type, gins, gattrs)
    assert set(touts) == {"X@GRAD", "Y@GRAD"}
    for slot, src in (("X@GRAD", "X"), ("Y@GRAD", "Y")):
        assert touts[slot][0].shape == ins[src][0].shape and not touts[slot][0].any()


def test_non_differentiable_ops_have_no_grad():
    for t in ("fill_constant", "gaussian_random", "uniform_random", "accuracy", "adam"):
        with pytest.raises(KeyError, match="non-differentiable"):
            treg.get(t + "_grad")
    assert treg.get("lookup_table_v2").nondiff_inputs == {"Ids"}
    assert treg.get("fused_attention").nondiff_inputs == {"Bias"}
    assert treg.get("layer_norm").nondiff_outputs == {"Mean", "Variance"}
    assert treg.get("dropout").nondiff_outputs == {"Mask"}
    assert treg.get("softmax_with_cross_entropy").nondiff_outputs == {"Softmax"}


def _tiny_program(dtype="float32"):
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [8], dtype)
        h = pt.layers.fc(x, 6, act="tanh")
        loss = pt.layers.mean(pt.layers.fc(h, 3))
    return main, startup, loss


def test_grad_shapes_copy_the_forward_inputs():
    """Grad var shapes and dtypes mirror the forward vars (the dynamic batch
    dim stays -1), inferred without running any lowering."""
    main, _, loss = _tiny_program("bfloat16")
    before = treg._meta_infer
    calls = []
    treg._meta_infer = lambda d, op, block: (calls.append(op.type), before(d, op, block))
    try:
        pgs = pt.append_backward(loss)
    finally:
        treg._meta_infer = before
    assert calls == ["fill_constant"]   # the seed of d(loss); grad ops run no lowering
    blk = main.global_block()
    for p, g in pgs:
        assert (g.shape, g.dtype) == (p.shape, p.dtype) and g.stop_gradient
    h = next(op for op in blk.ops if op.type == "tanh_grad")
    assert blk.var(h.output("X@GRAD")[0]).shape == (-1, 6)


def test_second_order_is_refused():
    """The refusal sits at third order now, the JAX package's ceiling: the
    gradient of a parameter's gradient with respect to the input is built
    and equals the JAX package's from the same weights; a gradient of that
    raises in both, naming the slot collision of a ``*_grad_grad`` op."""
    built = {}
    for pkg in (paddle_tpu, pt):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [8], "float32")
            h = pkg.layers.fc(x, 6, act="tanh")
            loss = pkg.layers.mean(pkg.layers.fc(h, 3))
            g = pkg.append_backward(loss)[0][1]
            g.stop_gradient = False
            gx, = pkg.gradients([g], [x])
            with pytest.raises(NotImplementedError, match="third-order"):
                pkg.gradients([pkg.layers.mean(gx)], [x])
        built[pkg] = (main, startup, gx)
    feed = {"x": np.random.RandomState(0).randn(4, 8).astype("float32")}
    main, startup, gx = built[paddle_tpu]
    scope = paddle_tpu.Scope()
    with paddle_tpu.scope_guard(scope):
        exe = paddle_tpu.Executor()
        exe.run(startup)
        want = exe.run(main, feed=feed, fetch_list=[gx])[0]
        init = {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
                if v.persistable}
    main, _, gx = built[pt]
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        got = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[gx])[0]
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
