"""VGG-16 on the port against the JAX package, on the CPU: the image
chapter's training step and the served model, at 32 x 32 to stay small.

The chapter (``examples/image_classification.py``): VGG-16 with batch norm,
``dropout=0`` (the two packages draw other masks), at B 4, one Adam step
from the JAX startup state. The loss within ``rtol 1e-4`` (f32 sums in
other orders through 13 convolutions); the accuracy exactly. The update
is held as a relative L1 gap, sum|u_port - u_jax| / sum|u_jax| over every
parameter (u = the step's change), not element by element: Adam's first
update is lr * g / (|g| + eps), +-lr wherever |g| >> eps, so an element
whose gradient is near its rounding error (the conv biases before a batch
norm have a gradient of exactly 0 in exact arithmetic) flips by 2 lr.
1e-2 bounds those flips (measured on this model and batch: 2.8e-5).

``pool2d`` max ties: VGG's pools follow a ReLU, so windows of zeros tie
often. The port's gradient lands where the JAX package's does: both give
a tied window's gradient to its first maximum in row-major order
(``test_pool2d_gives_a_tied_windows_gradient_where_jax_does`` holds it
exactly, over windows of 0s and 1s). It is not left to ``relu`` to hide.

Served (``is_test=True``, 1000 classes): the port's ``Predictor`` on a
directory the JAX package saved gives the JAX ``Predictor``'s logits
within f32 ``rtol 1e-4, atol 1e-5``, and a directory the port saved loads
in the JAX ``Predictor`` to the same.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.models import vgg as jvgg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.models import vgg as tvgg
from paddle_tpu_torch.tools import book

UPDATE_REL_L1 = 1e-2
SERVE_TOL = dict(rtol=1e-4, atol=1e-5)


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


def test_the_image_chapter_step_matches_jax():
    jch = book.build_image_classification(fluid, jvgg, dropout=0)
    tch = book.build_image_classification(pt, tvgg, dropout=0)
    assert [b["ops"] for b in tch.main.to_dict()["blocks"]] == \
        [b["ops"] for b in jch.main.to_dict()["blocks"]]
    names = _persistables(jch.main)
    assert _persistables(tch.main) == names
    types = [op.type for op in tch.main.global_block().ops]
    assert (types.count("conv2d"), types.count("pool2d"), types.count("batch_norm")) == (13, 5, 13)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(4, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(jch.startup)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        jl, ja = exe.run(jch.main, feed=feed, fetch_list=jch.fetch)
        jfinal = {n: np.asarray(scope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        tl, ta = pt.Executor(pt.CPUPlace()).run(tch.main, feed=feed, fetch_list=tch.fetch)
    np.testing.assert_allclose(float(tl), float(np.asarray(jl)), rtol=1e-4)
    assert float(ta) == float(np.asarray(ja))
    blk = tch.main.global_block()
    params = [n for n in names if isinstance(blk.var(n), pt.Parameter) and blk.var(n).trainable]
    assert len(params) == 13 * 2 + 13 * 2 + 3 * 2     # conv w, b; bn scale, shift; fc w, b
    num = den = 0.0
    for n in params:
        u_port = tscope.find_var(n).numpy().astype(np.float64) - init[n]
        u_jax = jfinal[n].astype(np.float64) - init[n]
        num += np.abs(u_port - u_jax).sum()
        den += np.abs(u_jax).sum()
    assert den > 0 and num / den < UPDATE_REL_L1, num / den
    # the running statistics (no gradient) to f32 rounding
    for n in names:
        if n.startswith("batch_norm") and n not in params and "moment" not in n \
                and "pow_acc" not in n:
            np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=1e-5,
                                       rtol=1e-4, err_msg=n)


def test_pool2d_gives_a_tied_windows_gradient_where_jax_does():
    x = np.random.RandomState(0).randint(0, 2, (2, 3, 8, 8)).astype("float32")
    attrs = {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0],
             "data_format": "NCHW"}
    out = np.asarray(jreg.get("pool2d").lower(jreg.LowerCtx(dict(attrs)),
                                              {"X": [jnp.asarray(x)]})["Out"][0])
    cot = np.random.RandomState(1).randn(*out.shape).astype("float32")
    gattrs = dict(attrs, __fwd_attrs__=dict(attrs), __fwd_out_slots__=["Out"], __fwd_out0__="o")
    ins = {"X": [x], "Out": [out], "Out@GRAD": [cot]}
    want = jreg.get("pool2d_grad").lower(
        jreg.LowerCtx(dict(gattrs)), {k: [jnp.asarray(a) for a in v] for k, v in ins.items()})
    got = treg.get("pool2d_grad").lower(
        treg.LowerCtx(dict(gattrs)), {k: [torch.from_numpy(a) for a in v] for k, v in ins.items()})
    a, b = np.asarray(want["X@GRAD"][0]), got["X@GRAD"][0].numpy()
    assert (b != 0).sum() == out.size            # one index of each window, ties or not
    np.testing.assert_array_equal(b, a)


def _vgg_infer(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, 32, 32], "float32")
        logits = model.vgg16(img, None, is_test=True)
    return main, startup, logits


@pytest.fixture(scope="module")
def jax_saved_vgg(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("vgg_jax"))
    main, startup, logits = _vgg_infer(fluid, jvgg)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        fluid.io.save_inference_model(d, ["img"], [logits], exe, main_program=main)
    return d


def _images(batch, seed):
    return {"img": np.random.RandomState(seed).rand(batch, 3, 32, 32).astype("float32")}


def test_a_jax_saved_vgg16_serves_in_the_port(jax_saved_vgg):
    pred, jpred = Predictor(jax_saved_vgg, device="cpu"), JaxPredictor(jax_saved_vgg)
    types = [op.type for op in pred.program.global_block().ops]
    assert "dropout" not in types and types.count("conv2d") == 13
    for batch in (1, 3):
        feed = _images(batch, batch)
        got, = pred.run(feed)
        want, = jpred.run(feed)
        assert got.shape == (batch, 1000) and np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(want), **SERVE_TOL)


def test_a_port_saved_vgg16_serves_in_jax(tmp_path):
    main, startup, logits = _vgg_infer(pt, tvgg)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        pt.io.save_inference_model(str(tmp_path), ["img"], [logits], exe, main_program=main)
    feed = _images(2, 7)
    got, = Predictor(str(tmp_path), device="cpu").run(feed)
    want, = JaxPredictor(str(tmp_path)).run(feed)
    np.testing.assert_allclose(got, np.asarray(want), **SERVE_TOL)
