"""Each op type of the BERT serving and pretraining slices: the JAX
package's lowering and the port's, on the same numpy inputs.

Tolerances: float32 ``atol 1e-6, rtol 1e-5`` (``mul`` and ``fused_attention``
``1e-5``: their sums run in another order); bfloat16 ``atol 1e-2, rtol
1e-2``, since rounding one step elsewhere moves a value by one bf16 ulp (2^-8
relative). Random ops draw other numbers in each package: they are held by
their statistics, not their bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  (registers the JAX op library)
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch  # noqa: F401  (registers the port's op library)
from paddle_tpu_torch.core import registry as treg

TOL = {"float32": dict(atol=1e-6, rtol=1e-5), "bfloat16": dict(atol=1e-2, rtol=1e-2)}
SUM_TOL = dict(atol=1e-5, rtol=1e-5)


def _r(*shape, scale=1.0):
    return (np.random.RandomState(sum(shape)).randn(*shape) * scale).astype("float32")


def _ids(shape, hi, seed=1):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


# id -> (op type, inputs, attrs, dtype of the float inputs, tolerance override)
CASES = {
    "fill_constant-f32": ("fill_constant", {}, {"shape": [3, 4], "value": 1.5,
                                                "dtype": "float32"}, "float32", None),
    "fill_constant-bf16": ("fill_constant", {}, {"shape": [2, 5], "value": -0.3,
                                                 "dtype": "bfloat16"}, "bfloat16", None),
    "fill_constant-int64": ("fill_constant", {}, {"shape": [4], "value": 7.0,
                                                  "dtype": "int64"}, "float32", None),
    "lookup_table_v2": ("lookup_table_v2", {"W": [_r(20, 8)], "Ids": [_ids((2, 5), 20)]},
                        {"padding_idx": -1}, "float32", None),
    "lookup_table_v2-padding": ("lookup_table_v2",
                                {"W": [_r(20, 8)], "Ids": [_ids((2, 5, 1), 20, seed=3)]},
                                {"padding_idx": 3}, "float32", None),
    "elementwise_add-trailing": ("elementwise_add", {"X": [_r(2, 3, 4)], "Y": [_r(4)]},
                                 {"axis": -1}, "float32", None),
    "elementwise_add-axis1": ("elementwise_add", {"X": [_r(2, 3, 4)], "Y": [_r(3, 1)]},
                              {"axis": 1}, "float32", None),
    "elementwise_add-bf16": ("elementwise_add", {"X": [_r(2, 6, 8)], "Y": [_r(8)]},
                             {"axis": 2}, "bfloat16", None),
    "cast-f32-bf16": ("cast", {"X": [_r(4, 8, scale=3.0)]},
                      {"in_dtype": "float32", "out_dtype": "bfloat16"}, "float32", None),
    "cast-f32-int32": ("cast", {"X": [_r(4, 8, scale=3.0)]},
                       {"in_dtype": "float32", "out_dtype": "int32"}, "float32", None),
    "cast-bf16-f32": ("cast", {"X": [_r(4, 8)]},
                      {"in_dtype": "bfloat16", "out_dtype": "float32"}, "bfloat16", None),
    "layer_norm": ("layer_norm", {"X": [_r(2, 5, 16, scale=2.0)], "Scale": [_r(16)],
                                  "Bias": [_r(16)]},
                   {"begin_norm_axis": 2, "epsilon": 1e-5}, "float32", None),
    "layer_norm-noaffine": ("layer_norm", {"X": [_r(3, 4, 6)]}, {"begin_norm_axis": 1},
                            "float32", None),
    "layer_norm-bf16": ("layer_norm", {"X": [_r(2, 5, 16, scale=2.0)], "Scale": [_r(16)],
                                       "Bias": [_r(16)]},
                        {"begin_norm_axis": 2, "epsilon": 1e-5}, "bfloat16", None),
    "dropout-test-upscale": ("dropout", {"X": [_r(4, 8)]},
                             {"dropout_prob": 0.1, "is_test": True,
                              "dropout_implementation": "upscale_in_train"}, "float32", None),
    "dropout-test-downgrade": ("dropout", {"X": [_r(4, 8)]},
                               {"dropout_prob": 0.25, "is_test": True,
                                "dropout_implementation": "downgrade_in_infer"},
                               "float32", None),
    "scale": ("scale", {"X": [_r(3, 7)]}, {"scale": 1e4, "bias": -1e4,
                                           "bias_after_scale": True}, "float32", None),
    "scale-bias-first": ("scale", {"X": [_r(3, 7)]}, {"scale": 0.5, "bias": 2.0,
                                                      "bias_after_scale": False},
                         "float32", None),
    "unsqueeze2": ("unsqueeze2", {"X": [_r(2, 3)]}, {"axes": [1, 3]}, "float32", None),
    "mul": ("mul", {"X": [_r(2, 3, 16)], "Y": [_r(16, 8)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}, "float32", SUM_TOL),
    "mul-bf16": ("mul", {"X": [_r(2, 3, 32)], "Y": [_r(32, 8, scale=0.1)]},
                 {"x_num_col_dims": 2, "y_num_col_dims": 1}, "bfloat16", None),
    "split-num": ("split", {"X": [_r(2, 4, 9)]}, {"num": 3, "sections": [], "axis": 2},
                  "float32", None),
    "split-sections": ("split", {"X": [_r(2, 6, 3)]}, {"num": 0, "sections": [2, 4],
                                                       "axis": 1}, "float32", None),
    "reshape2": ("reshape2", {"X": [_r(2, 6, 4)]}, {"shape": [0, -1, 2, 2]}, "float32", None),
    "transpose2": ("transpose2", {"X": [_r(2, 3, 4, 5)]}, {"axis": [0, 2, 1, 3]},
                   "float32", None),
    "gelu-tanh": ("gelu", {"X": [_r(4, 16, scale=2.0)]}, {"approximate": True},
                  "float32", None),
    "gelu-erf": ("gelu", {"X": [_r(4, 16, scale=2.0)]}, {"approximate": False},
                 "float32", None),
    "gelu-tanh-bf16": ("gelu", {"X": [_r(4, 16, scale=2.0)]}, {"approximate": True},
                       "bfloat16", None),
    "fused_attention": ("fused_attention",
                        {"Q": [_r(2, 2, 16, 8)], "K": [_r(2, 2, 17, 8)[:, :, :16]],
                         "V": [_r(2, 2, 18, 8)[:, :, :16]],
                         "Bias": [np.where(_r(2, 1, 1, 16) > -1.0, 0.0, -1e4)
                                  .astype("float32")]},
                        {"scale": 0.0, "is_test": True, "dropout_prob": 0.1,
                         "causal": False, "impl": "auto"}, "float32", SUM_TOL),
    "fused_attention-causal-bf16": ("fused_attention",
                                    {"Q": [_r(1, 2, 16, 8)], "K": [_r(1, 2, 17, 8)[:, :, 1:]],
                                     "V": [_r(1, 2, 18, 8)[:, :, 2:]]},
                                    {"scale": 0.3, "is_test": True, "causal": True,
                                     "impl": "composed"}, "bfloat16", None),
    "matmul": ("matmul", {"X": [_r(2, 3, 5, 8)], "Y": [_r(2, 3, 6, 8)]},
               {"transpose_X": False, "transpose_Y": True, "alpha": 0.125}, "float32", SUM_TOL),
    "matmul-bf16-alpha": ("matmul", {"X": [_r(2, 3, 5, 16)], "Y": [_r(2, 3, 16, 4)]},
                          {"alpha": 0.17677669529663687}, "bfloat16", None),
    "softmax": ("softmax", {"X": [_r(3, 4, 9, scale=3.0)]}, {"axis": -1}, "float32", None),
    "softmax-bf16": ("softmax", {"X": [_r(3, 4, 9, scale=3.0)]}, {"axis": -1}, "bfloat16",
                     None),
    "softmax_with_cross_entropy": ("softmax_with_cross_entropy",
                                   {"Logits": [_r(6, 11, scale=2.0)],
                                    "Label": [_ids((6, 1), 11)]},
                                   {"soft_label": False, "ignore_index": -100},
                                   "float32", None),
    "softmax_with_cross_entropy-ignore": ("softmax_with_cross_entropy",
                                          {"Logits": [_r(6, 11, scale=2.0)],
                                           "Label": [_ids((6, 1), 4, seed=2)]},
                                          {"soft_label": False, "ignore_index": 1},
                                          "float32", None),
    "mean": ("mean", {"X": [_r(4, 7)]}, {}, "float32", None),
    "slice": ("slice", {"Input": [_r(3, 5, 4)]}, {"axes": [1, 2], "starts": [0, -3],
                                                  "ends": [1, 100]}, "float32", None),
    "gather": ("gather", {"X": [_r(12, 8)], "Index": [_ids((7, 1), 12, seed=5)]},
               {"axis": 0}, "float32", None),
    "top_k": ("top_k", {"X": [_r(5, 9)]}, {"k": 3}, "float32", None),
    # ties: the lower index first, as jax.lax.top_k ([[1, 3, 3, 2, 3]], k 2 -> [1, 2])
    "top_k-ties": ("top_k", {"X": [np.array([[1, 3, 3, 2, 3]], "float32")]}, {"k": 2},
                   "float32", None),
    "top_k-ties-64x50": ("top_k", {"X": [_ids((64, 50), 3, seed=7).astype("float32")]},
                         {"k": 5}, "float32", None),
    "accuracy": ("accuracy", {"Indices": [_ids((8, 2), 3, seed=4)],
                              "Label": [_ids((8, 1), 3, seed=6)]}, {}, "float32", None),
    "assign": ("assign", {"X": [_r(3, 4)]}, {}, "float32", None),
    "sum": ("sum", {"X": [_r(3, 4), _r(4, 3).T.copy(), _r(2, 6).reshape(3, 4)]}, {},
            "float32", None),
    "tanh": ("tanh", {"X": [_r(4, 6, scale=2.0)]}, {}, "float32", None),
    "adam": ("adam", {"Param": [_r(4, 5)], "Grad": [_r(5, 4).reshape(4, 5)],
                      "LearningRate": [np.array([0.01], "float32")],
                      "Moment1": [_r(2, 10).reshape(4, 5) * 0.1],
                      "Moment2": [np.abs(_r(10, 2).reshape(4, 5)) * 0.01],
                      "Beta1Pow": [np.array([0.9 ** 3], "float32")],
                      "Beta2Pow": [np.array([0.999 ** 3], "float32")]},
             {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}, "float32", None),
}


def _to_jax(a, dtype):
    a = np.ascontiguousarray(a)
    return jnp.asarray(a, jnp.bfloat16) if (dtype == "bfloat16" and a.dtype.kind == "f") \
        else jnp.asarray(a)


def _to_torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if (dtype == "bfloat16" and a.dtype.kind == "f") else t


def _np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if str(x.dtype) == "bfloat16" else x


def _lower_both(op_type, ins, attrs, dtype):
    jouts = jreg.get(op_type).lower(
        jreg.LowerCtx(dict(attrs)), {s: [_to_jax(a, dtype) for a in v] for s, v in ins.items()})
    touts = treg.get(op_type).lower(
        treg.LowerCtx(dict(attrs)), {s: [_to_torch(a, dtype) for a in v] for s, v in ins.items()})
    return jouts, touts


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_lowering(case):
    op_type, ins, attrs, dtype, tol = CASES[case]
    jouts, touts = _lower_both(op_type, ins, attrs, dtype)
    tol = tol or TOL[dtype]
    compared = 0
    for slot, tvals in touts.items():
        for j, t in zip(jouts[slot], tvals):
            if j is None:   # JAX's reshape2/transpose2 leave XShape empty
                continue
            a, b = _np(j), _np(t)
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            # ids and integer casts: JAX runs with x64 off (int32), the port keeps int64
            assert a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
            np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                       err_msg=f"{case} slot {slot}", **tol)
            compared += 1
    assert compared >= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gaussian_random_distribution(dtype):
    attrs = {"shape": [400, 500], "mean": 0.5, "std": 2.0, "seed": 0, "dtype": dtype}
    jouts, touts = _lower_both("gaussian_random", {}, attrs, dtype)
    a, b = _np(jouts["Out"][0]), _np(touts["Out"][0])
    assert a.shape == b.shape == (400, 500)
    assert str(touts["Out"][0].dtype) == f"torch.{dtype}"
    for x in (a, b):   # 200k draws: the sample mean is within ~0.005 of 0.5
        assert abs(x.mean() - 0.5) < 0.03 and abs(x.std() / 2.0 - 1) < 0.02
    assert abs(a.mean() - b.mean()) < 0.05 and abs(a.std() / b.std() - 1) < 0.03


def test_dropout_train_mode_statistics():
    x = _r(200, 500)
    for impl, scale in (("upscale_in_train", 1 / 0.7), ("downgrade_in_infer", 1.0)):
        attrs = {"dropout_prob": 0.3, "is_test": False, "seed": 0,
                 "dropout_implementation": impl}
        jouts, touts = _lower_both("dropout", {"X": [x]}, attrs, "float32")
        keep_j, keep_t = _np(jouts["Mask"][0]).mean(), _np(touts["Mask"][0]).mean()
        assert abs(keep_j - 0.7) < 0.01 and abs(keep_t - 0.7) < 0.01
        mask = _np(touts["Mask"][0])
        np.testing.assert_allclose(_np(touts["Out"][0]), x * mask * scale, rtol=1e-6)


def test_random_ops_draw_from_the_run_counter():
    """Two runs of one program draw different numbers; the same (seed,
    counter) draws the same."""
    ctx = lambda counter: treg.LowerCtx({"shape": [64], "dtype": "float32"}, seed=5,
                                        counter=counter, salt=11)
    g = treg.get("gaussian_random").lower
    a, b, c = (g(ctx(n), {})["Out"][0] for n in (0, 1, 0))
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_top_k_ties_take_the_lower_index_first():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    outs = treg.get("top_k").lower(treg.LowerCtx({"k": 2}), {"X": [x]})
    assert outs["Indices"][0].tolist() == [[1, 2]]
    assert outs["Out"][0].tolist() == [[3.0, 3.0]]


def test_accuracy_over_tied_scores_equals_jax():
    """``layers.accuracy`` over scores that tie (one-hot rows of a
    saturated softmax, many zeros, repeated maxima): top-1 and top-2 over
    the port's program equal the JAX package's."""
    import paddle_tpu as fluid

    rng = np.random.RandomState(3)
    scores = rng.randint(0, 3, (64, 10)).astype("float32")
    label = rng.randint(0, 10, (64, 1)).astype("int64")
    got = {}
    for name, pkg, place in (("jax", fluid, None), ("port", paddle_tpu_torch,
                                                    paddle_tpu_torch.CPUPlace())):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [10], "float32")
            y = pkg.data("y", [1], "int64")
            accs = [pkg.layers.accuracy(x, y, k=k) for k in (1, 2)]
        exe = pkg.Executor() if place is None else pkg.Executor(place)
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            got[name] = [float(np.asarray(a).reshape(-1)[0]) for a in
                         exe.run(main, feed={"x": scores, "y": label}, fetch_list=accs)]
    assert got["port"] == got["jax"], got
