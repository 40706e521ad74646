"""ResNet training through the port: the ``conv1x1_bn`` kernel's plain
version and its autograd pair, the ops ResNet-50 runs, the conv + BN fuse
pass and three Momentum steps of a one-block-per-stage ResNet, held against
the JAX package on the CPU.

Tolerances:
* plain version against the Pallas kernel (interpret mode), f32: both
  accumulate exact products in f32 in other orders: y ``atol 1e-5`` on
  outputs of unit scale, the column sums ``rtol 1e-5`` of sum |y| (resp.
  sum y^2). bf16: y may move by one bf16 ulp where the two f32 sums fall
  on either side of a rounding boundary (``rtol 2^-7``, one ulp at the
  bottom of a binade, and ``atol 1e-5``
  where the sum cancels to near zero); the sums then by that much of
  sum |y|.
* gradients of the fused pair against ``fused_conv1x1_bn``'s custom VJP,
  f32: ``rtol 1e-4, atol 1e-4`` (the JAX suite's fused-conv grads hold to
  5e-3; the two sides here run the same formulas in other orders).
* op forward and grads, f32: ``atol 1e-5, rtol 1e-5`` (convolutions and
  batch norm ``5e-5``: longer sums).
* three Momentum steps of the tiny ResNet, f32: the losses ``rtol 1e-4``,
  every parameter and velocity ``atol 1e-4 * max|ref|, rtol 1e-3``. The
  last stage batch-normalises 8 values per channel (batch 2 at 2 x 2), so
  its inverse deviations reach ~30 and amplify the 1e-6 differences of
  summation order. At 32 x 32 images that stage sees 2 values per channel
  and inverse deviations of ~300: the two frameworks' first steps already
  part there, so the images here are 64 x 64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import fuse_conv_bn_stats as jfuse
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import resnet as jres
from paddle_tpu.ops import pallas_conv_bn
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import fuse_conv_bn_stats as tfuse
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.ops import conv_bn
from tests.test_torch_grad import _grad_both, _grad_ins_and_attrs, _np, _r

FLAGS = [(True, True), (True, False), (False, True), (False, False)]
TOL = dict(atol=1e-5, rtol=1e-5)
SUM_TOL = dict(atol=5e-5, rtol=1e-5)


def _kernel_inputs(M, K, N, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(M, K).astype("float32"), (rng.randn(K, N) * 0.05).astype("float32"),
            rng.randn(K).astype("float32"), (np.abs(rng.randn(K)) + 0.5).astype("float32"),
            rng.randn(K).astype("float32"), rng.randn(K).astype("float32")]


@pytest.mark.parametrize("apply_in_bn,relu_in", FLAGS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_the_pallas_kernel(apply_in_bn, relu_in, dtype):
    BM = pallas_conv_bn.BM
    x2, w, mu, var, g, b = _kernel_inputs(2 * BM, 128, 64, seed=int(apply_in_bn) + 2 * relu_in)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jy, js, jss = pallas_conv_bn.fused_conv1x1_bn_fwd(
        jnp.asarray(x2, jdt), jnp.asarray(w, jdt), jnp.asarray(mu), jnp.asarray(var),
        jnp.asarray(g), jnp.asarray(b), 1e-5, relu_in, apply_in_bn, interpret=True)
    ty, ts, tss = conv_bn.fused_conv1x1_bn_fwd(
        torch.from_numpy(x2).to(tdt), torch.from_numpy(w).to(tdt),
        *(torch.from_numpy(a) for a in (mu, var, g, b)), 1e-5, relu_in, apply_in_bn)
    assert ty.dtype == tdt and ts.dtype == tss.dtype == torch.float32
    jy = np.asarray(jy.astype(jnp.float32))
    y_tol = dict(atol=1e-5, rtol=0) if dtype == "float32" else dict(atol=1e-5, rtol=2 ** -7)
    np.testing.assert_allclose(ty.float().numpy(), jy, **y_tol)
    rel = 1e-5 if dtype == "float32" else 2 ** -7
    for got, want, mag in ((ts, js, np.abs(jy).sum(0)), (tss, jss, (jy * jy).sum(0))):
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= rel * mag + 1e-6)


def _fused_losses(y, s, ss, cy, cs, css):
    return (y.float() * y.float() * cy).sum() + (s * cs).sum() + (ss * css).sum()


@pytest.mark.parametrize("apply_in_bn,relu_in", FLAGS)
@pytest.mark.parametrize("through", ["y_and_stats", "stats_only"])
def test_fused_gradients_match_the_custom_vjp(apply_in_bn, relu_in, through):
    """d(loss)/d(x2, w, gamma, beta) through ``FusedConv1x1BN`` against
    ``jax.grad`` through ``fused_conv1x1_bn``. With ``stats_only`` the loss
    reads only the column sums: dropping their cotangents would give zero
    grads."""
    BM = pallas_conv_bn.BM
    x2, w, mu, var, g, b = _kernel_inputs(BM, 64, 64, seed=5)
    rng = np.random.RandomState(6)
    cy = 1e-3 if through == "y_and_stats" else 0.0
    cs, css = rng.randn(64).astype("float32") * 1e-2, rng.randn(64).astype("float32") * 1e-4

    def jloss(x2, w, g, b):
        y, s, ss = pallas_conv_bn.fused_conv1x1_bn(x2, w, mu, var, g, b, 1e-5, relu_in,
                                                   apply_in_bn, True)
        return jnp.sum(y * y * cy) + jnp.sum(s * cs) + jnp.sum(ss * css)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (x2, w, g, b)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (x2, w, g, b)]
    y, s, ss = conv_bn.FusedConv1x1BN.apply(ts[0], ts[1], torch.from_numpy(mu),
                                            torch.from_numpy(var), ts[2], ts[3], 1e-5,
                                            relu_in, apply_in_bn)
    tg = torch.autograd.grad(_fused_losses(y, s, ss, cy, torch.from_numpy(cs),
                                           torch.from_numpy(css)), ts)
    for name, a, r in zip(("dx", "dw", "dgamma", "dbeta"), tg, jg):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=1e-4, atol=1e-4, err_msg=name)
    assert np.abs(tg[1].numpy()).max() > 1e-3    # the statistics' cotangents reach w


def _nhwc(*shape, seed=None, scale=1.0):
    return _r(*shape, scale=scale, seed=seed)


# id -> (op type, forward inputs, attrs, output slots that get a cotangent, tolerance)
CASES = {
    "conv2d-nhwc-asym-pad": ("conv2d", {"Input": [_nhwc(2, 7, 7, 12)],
                                        "Filter": [_r(8, 12, 4, 4, seed=5)]},
                             {"strides": [1, 1], "paddings": [2, 1, 2, 1], "dilations": [1, 1],
                              "groups": 1, "data_format": "NHWC"}, ("Output",), SUM_TOL),
    "conv2d-nhwc-s2": ("conv2d", {"Input": [_nhwc(2, 9, 9, 8)], "Filter": [_r(6, 8, 3, 3)]},
                       {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
                        "groups": 1, "data_format": "NHWC"}, ("Output",), SUM_TOL),
    "conv2d-nchw-groups-dil": ("conv2d", {"Input": [_r(2, 8, 9, 9)], "Filter": [_r(6, 4, 3, 3)]},
                               {"strides": [1, 1], "paddings": [2, 2], "dilations": [2, 2],
                                "groups": 2, "data_format": "NCHW"}, ("Output",), SUM_TOL),
    "conv2d-1x1": ("conv2d", {"Input": [_nhwc(2, 5, 5, 16)], "Filter": [_r(32, 16, 1, 1)]},
                   {"strides": [1, 1], "paddings": [0, 0], "dilations": [1, 1], "groups": 1,
                    "data_format": "NHWC"}, ("Output",), SUM_TOL),
    # relu outputs hold many equal zeros: every window of all zeros is a tie
    "pool2d-max-ties": ("pool2d", {"X": [np.maximum(np.round(_r(2, 9, 9, 4)), 0)
                                         .astype("float32")]},
                        {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
                         "paddings": [1, 1], "data_format": "NHWC"}, ("Out",), TOL),
    "pool2d-max-nchw": ("pool2d", {"X": [_r(2, 3, 8, 8)]},
                        {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2],
                         "paddings": [0, 0], "data_format": "NCHW"}, ("Out",), TOL),
    "pool2d-avg-exclusive": ("pool2d", {"X": [_r(2, 7, 7, 3)]},
                             {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
                              "paddings": [1, 1], "exclusive": True, "data_format": "NHWC"},
                             ("Out",), TOL),
    "pool2d-avg-inclusive": ("pool2d", {"X": [_r(2, 3, 7, 7)]},
                             {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
                              "paddings": [1, 1], "exclusive": False, "data_format": "NCHW"},
                             ("Out",), TOL),
    "pool2d-global-avg": ("pool2d", {"X": [_r(2, 4, 4, 16)]},
                          {"pooling_type": "avg", "global_pooling": True,
                           "data_format": "NHWC"}, ("Out",), TOL),
    "pool2d-global-max": ("pool2d", {"X": [_r(2, 16, 4, 4)]},
                          {"pooling_type": "max", "global_pooling": True,
                           "data_format": "NCHW"}, ("Out",), TOL),
    "pool2d-adaptive": ("pool2d", {"X": [_r(2, 6, 6, 3)]},
                        {"pooling_type": "avg", "ksize": [2, 3], "adaptive": True,
                         "data_format": "NHWC"}, ("Out",), TOL),
    "batch_norm-nhwc": ("batch_norm", {"X": [_nhwc(2, 3, 3, 8, scale=2.0)],
                                       "Scale": [_r(8, seed=3)], "Bias": [_r(8, seed=4)],
                                       "Mean": [_r(8, seed=6)],
                                       "Variance": [np.abs(_r(8, seed=7)) + 0.5]},
                        {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NHWC",
                         "is_test": False}, ("Y",), SUM_TOL),
    "batch_norm-nchw": ("batch_norm", {"X": [_r(3, 4, 5, 5, scale=2.0)],
                                       "Scale": [_r(4, seed=3)], "Bias": [_r(4, seed=4)],
                                       "Mean": [np.zeros(4, "float32")],
                                       "Variance": [np.ones(4, "float32")]},
                        {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NCHW",
                         "is_test": False}, ("Y",), SUM_TOL),
    "batch_norm-test": ("batch_norm", {"X": [_nhwc(2, 3, 3, 8)], "Scale": [_r(8, seed=3)],
                                       "Bias": [_r(8, seed=4)], "Mean": [_r(8, seed=6)],
                                       "Variance": [np.abs(_r(8, seed=7)) + 0.5]},
                        {"epsilon": 1e-5, "data_layout": "NHWC", "is_test": True},
                        ("Y",), TOL),
    "relu": ("relu", {"X": [np.round(_r(4, 6, scale=2.0))]}, {}, ("Out",), TOL),
    "conv2d_bn_fused-relu": ("conv2d_bn_fused",
                             {"Input": [_nhwc(2, 4, 4, 16)], "Filter": [_r(24, 16, 1, 1)],
                              "Scale": [_r(24, seed=3)], "Bias": [_r(24, seed=4)],
                              "Mean": [_r(24, seed=6)],
                              "Variance": [np.abs(_r(24, seed=7)) + 0.5]},
                             {"epsilon": 1e-5, "momentum": 0.9, "act": "relu"}, ("Y",),
                             SUM_TOL),
    "conv2d_bn_fused": ("conv2d_bn_fused",
                        {"Input": [_nhwc(3, 2, 5, 8)], "Filter": [_r(8, 8, 1, 1)],
                         "Scale": [_r(8, seed=3)], "Bias": [_r(8, seed=4)],
                         "Mean": [np.zeros(8, "float32")], "Variance": [np.ones(8, "float32")]},
                        {"epsilon": 1e-3, "momentum": 0.8, "act": None}, ("Y",), SUM_TOL),
    "conv2d_bn_fused-test": ("conv2d_bn_fused",
                             {"Input": [_nhwc(2, 3, 3, 8)], "Filter": [_r(4, 8, 1, 1)],
                              "Scale": [_r(4, seed=3)], "Bias": [_r(4, seed=4)],
                              "Mean": [_r(4, seed=6)],
                              "Variance": [np.abs(_r(4, seed=7)) + 0.5]},
                             {"epsilon": 1e-5, "act": "relu", "is_test": True}, ("Y",), TOL),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_forward_and_grad_match_jax(case):
    op_type, ins, attrs, cot_slots, tol = CASES[case]
    jouts = jreg.get(op_type).lower(jreg.LowerCtx(dict(attrs)),
                                    {s: [jnp.asarray(a) for a in v] for s, v in ins.items()})
    touts = treg.get(op_type).lower(treg.LowerCtx(dict(attrs)),
                                    {s: [torch.from_numpy(np.array(a)) for a in v]
                                     for s, v in ins.items()})
    assert sorted(touts) == sorted(jouts)
    for slot in touts:
        for j, t in zip(jouts[slot], touts[slot]):
            np.testing.assert_allclose(_np(t), _np(j), err_msg=f"{case} {slot}", **tol)
    gins, gattrs = _grad_ins_and_attrs(op_type, ins, attrs, cot_slots)
    jg, tg = _grad_both(op_type, gins, gattrs)
    assert sorted(tg) == sorted(jg)
    for slot in tg:
        for j, t in zip(jg[slot], tg[slot]):
            np.testing.assert_allclose(_np(t), _np(j), err_msg=f"{case} {slot}", **tol)


def test_max_pool_ties_send_the_gradient_to_the_first_maximum():
    """A window of equal values gives its whole gradient to the first (row-
    major) element, as JAX's select_and_scatter_add does."""
    x = torch.zeros(1, 4, 4, 1, requires_grad=True)
    out = treg.get("pool2d").lower(treg.LowerCtx(
        {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
         "data_format": "NHWC"}), {"X": [x]})["Out"][0]
    g, = torch.autograd.grad(out.sum(), x)
    assert g[0, :, :, 0].tolist() == [[1, 0, 1, 0], [0, 0, 0, 0], [1, 0, 1, 0], [0, 0, 0, 0]]


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_momentum_matches_jax(nesterov, param_dtype):
    rng = np.random.RandomState(3)
    ins = {"Param": [rng.randn(6, 5).astype("float32")],
           "Grad": [rng.randn(6, 5).astype("float32")],
           "Velocity": [rng.randn(6, 5).astype("float32") * 0.1],
           "LearningRate": [np.array([0.1], "float32")]}
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    low = lambda s: param_dtype == "bfloat16" and s in ("Param", "Grad")
    jouts = jreg.get("momentum").lower(jreg.LowerCtx(attrs), {
        s: [jnp.asarray(a, jnp.bfloat16 if low(s) else jnp.float32) for a in v]
        for s, v in ins.items()})
    touts = treg.get("momentum").lower(treg.LowerCtx(attrs), {
        s: [torch.from_numpy(a).to(torch.bfloat16 if low(s) else torch.float32) for a in v]
        for s, v in ins.items()})
    assert touts["ParamOut"][0].dtype == getattr(torch, param_dtype)
    assert touts["VelocityOut"][0].dtype == torch.float32
    for s in touts:
        np.testing.assert_allclose(_np(touts[s][0]), _np(jouts[s][0]), rtol=1e-6,
                                   atol=1e-7, err_msg=s)


def _build(pkg, res, fuse_fn, image=64, classes=10, fuse=True, lr=1e-3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 0
    startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [image, image, 3], "float32")
        label = pkg.data("label", [1], "int64")
        loss, acc, _ = res.resnet50(img, label, num_classes=classes, data_format="NHWC",
                                    conv1_space_to_depth=True)
        fused = 0
        if fuse:
            for op in main.global_block().ops:
                if op.type == "batch_norm":
                    op.attrs["fuse_stats"] = True
            fused = fuse_fn(main)
        _, pg = pkg.optimizer.Momentum(lr, 0.9).minimize(loss)
    return main, startup, loss, fused, pg


@pytest.fixture
def one_block_per_stage(monkeypatch):
    monkeypatch.setitem(jres._DEPTHS, 50, [1, 1, 1, 1])
    monkeypatch.setitem(tres._DEPTHS, 50, [1, 1, 1, 1])


def test_fuse_pass_rewrites_as_jax_does(one_block_per_stage):
    jm, _, _, jn, jpg = _build(fluid, jres, jfuse)
    tm, _, _, tn, tpg = _build(pt, tres, tfuse)
    # 4 bottlenecks x (conv0 + relu, conv2) + res0_0's stride-1 shortcut
    assert jn == tn == 9
    jd, td = jm.to_dict(), tm.to_dict()
    assert [o["type"] for o in td["blocks"][0]["ops"]] == \
        [o["type"] for o in jd["blocks"][0]["ops"]]
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    assert [(p.name, g.name) for p, g in tpg] == [(p.name, g.name) for p, g in jpg]
    fused = [op for op in tm.global_block().ops if op.type == "conv2d_bn_fused"]
    assert [op.attr("act") for op in fused] == ["relu", None, None] * 1 + \
        ["relu", None] * 3
    assert "momentum" in {op.type for op in tm.global_block().ops}


def test_resnet50_program_fuses_33_chains():
    """conv0 and conv2 of all 16 bottlenecks and res0_0's stride-1 shortcut;
    the stem, the 3x3 convs and the three stride-2 shortcuts stay."""
    main, _, _, fused, _ = _build(pt, tres, tfuse, image=224, classes=1000)
    assert fused == 33
    ops = main.global_block().ops
    convs = [op for op in ops if op.type == "conv2d"]
    assert len(convs) == 1 + 16 + 3
    assert sum(op.type == "conv2d_bn_fused_grad" for op in ops) == 33
    assert sum(op.type == "batch_norm" for op in ops) == 20


def test_three_momentum_steps_match_jax(one_block_per_stage):
    jm, js, jl, _, _ = _build(fluid, jres, jfuse)
    tm, _, tl, _, _ = _build(pt, tres, tfuse)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(2, 64, 64, 3).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    exe = fluid.Executor()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jlosses = [float(exe.run(jm, feed=feed, fetch_list=[jl])[0][0]) for _ in range(3)]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    texe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(tscope):
        tlosses = [float(texe.run(tm, feed=feed, fetch_list=[tl])[0][0]) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[2] < tlosses[0]
    assert any(n.endswith("_velocity_0") for n in names)
    for n in names:
        got, want = tscope.find_var(n).numpy(), jfinal[n]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max(),
                                   err_msg=n)


def test_convert_carries_a_bf16_resnet_state(one_block_per_stage):
    """The JAX package's bf16 ResNet state (bf16 filters and BN scales, f32
    running statistics) loads into the port's own program by name, bit for
    bit, and the port evaluates it like the JAX package (test mode)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 0
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.data("img", [64, 64, 3], "bfloat16")
        logits = jres.resnet50(img, None, num_classes=10, data_format="NHWC",
                               conv1_space_to_depth=True, is_test=True)
    tm, ts = pt.Program(), pt.Program()
    tm.random_seed = ts.random_seed = 0
    with pt.unique_name.guard(), pt.program_guard(tm, ts):
        timg = pt.data("img", [64, 64, 3], "bfloat16")
        tlogits = tres.resnet50(timg, None, num_classes=10, data_format="NHWC",
                                conv1_space_to_depth=True, is_test=True)
    assert tm.to_dict() == main.to_dict()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        fluid.Executor().run(startup)
    state = {n: np.asarray(jscope.find_var(n)) for n in jscope.var_names()}
    tstate = convert.state_from_numpy(state, device="cpu")
    assert tstate["conv1_w"].dtype == torch.bfloat16
    assert tstate["batch_norm_0.global_0"].dtype == torch.float32
    for n, a in state.items():
        np.testing.assert_array_equal(_np(tstate[n]), _np(a), err_msg=n)
    x = _bf16_round(np.random.RandomState(4).randn(2, 64, 64, 3).astype("float32"))
    tscope = pt.Scope()
    convert.load_state(tscope, tstate)
    got, = pt.Executor(pt.CPUPlace()).run(tm, feed={"img": torch.from_numpy(x).bfloat16()},
                                          fetch_list=[tlogits], scope=tscope)
    with fluid.scope_guard(jscope):
        want, = fluid.Executor().run(main, feed={"img": jnp.asarray(x, jnp.bfloat16)},
                                     fetch_list=[logits])
    # bf16 over 17 convolutions: the JAX executor's fused XLA computation rounds at
    # other places than the port's op-by-op evaluation (a few bf16 ulps of logits ~1)
    np.testing.assert_allclose(got, _np(want), atol=0.1, rtol=0.05)


def _bf16_round(x):
    return torch.from_numpy(x).bfloat16().float().numpy()
