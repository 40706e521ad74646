"""The vision op types the port adds in its eighteenth slice (``depthwise_conv2d``,
``conv3d``, ``conv3d_transpose``, ``pool3d``, ``group_norm``,
``instance_norm``, ``prelu``, ``sync_batch_norm``, ``space_to_depth``, and
``fsp`` for ``contrib.slim``), their layers and the NCHW space-to-depth
ResNet stem, against the JAX package on the CPU, on the same seeded numpy
inputs.

Op cases (``paddle_tpu_torch/tools/vision_cases.py``): every output slot of
the forward and every input gradient of the generic ``<op>_grad`` (the same
seeded cotangents) at the case's f32 tolerance ``atol 1e-5, rtol 1e-5``
(convolutions and statistics summed in other orders). The JAX lowerings run
as ``tests/test_ops.py`` runs them on the CPU (no Pallas kernel lies on
these ops). Layers and models: the same op types, slots, attrs and
parameter names, then the same outputs (``rtol 1e-5``) from the JAX startup
state carried across by name (``convert.py``); the ResNet step's loss
within ``rtol 1e-5`` and its state within ``test_torch_resnet.py``'s
bounds.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import resnet as jres
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.tools import vision_cases as vc
from paddle_tpu_torch.tools.op_cases import numpy_outs

CASES = sorted(vc.CASES)
CPU = pt.CPUPlace()


def _jax(c, ins_np, attrs, op):
    return jreg.get(op).lower(jreg.LowerCtx(dict(attrs)),
                              {s: [jnp.asarray(a) for a in v] for s, v in ins_np.items()})


def _close(got, want, tol, what):
    got, want = numpy_outs({"x": [got]})["x"][0], numpy_outs({"x": [want]})["x"][0]
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


@pytest.mark.parametrize("name", CASES)
def test_vision_op_matches_jax(name):
    """Forward, every output slot; then the generic grad against the JAX
    package's vjp with the same cotangents."""
    c = vc.CASES[name]
    jouts = _jax(c, c.ins, c.attrs, c.op)
    touts = vc.forward(c, "cpu")
    assert sorted(touts) == sorted(jouts)
    for slot in jouts:
        _close(touts[slot][0], jouts[slot][0], c.tol, f"{name} {slot}")
    gins, gattrs = vc.grad_inputs(c, jouts)
    jg = _jax(c, gins, gattrs, c.op + "_grad")
    tg = vc.grad(c, "cpu", jouts)
    float_slots = [s for s, v in c.ins.items() if np.asarray(v[0]).dtype.kind == "f"
                   and s not in treg.get(c.op).nondiff_inputs]
    assert float_slots and sorted(tg) == sorted(s + "@GRAD" for s in float_slots)
    for s in float_slots:
        _close(tg[s + "@GRAD"][0], jg[s + "@GRAD"][0], c.grad_tol, f"{name} {s}@GRAD")


def test_every_vision_type_has_a_case_and_the_jax_flags():
    assert {c.op for c in vc.CASES.values()} == vc.VISION_TYPES
    assert set(vc.card_cases()) == set(vc.CASES)
    for op in vc.VISION_TYPES:
        t, j = treg.get(op), jreg.get(op)
        assert (t.grad is None) == (j.grad is None), op
        assert t.nondiff_inputs == j.nondiff_inputs, op
        assert t.nondiff_outputs == j.nondiff_outputs, op


# ---------------------------------------------------------------------------- layers

def _layer_program(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [8, 6, 6], "float32")
        out = build(pkg.layers, x)
    return main, startup, out


LAYERS = {
    "adaptive_pool2d-max": lambda L, x: L.adaptive_pool2d(x, 3, "max"),
    "adaptive_pool2d-avg": lambda L, x: L.adaptive_pool2d(x, [2, 3], "avg"),
    "group_norm": lambda L, x: L.group_norm(x, 4, act="relu"),
    "group_norm-no-affine": lambda L, x: L.group_norm(x, 2, param_attr=False, bias_attr=False),
    "instance_norm": lambda L, x: L.instance_norm(x),
    "prelu-all": lambda L, x: L.prelu(x, "all"),
    "prelu-channel": lambda L, x: L.prelu(x, "channel"),
    "prelu-element": lambda L, x: L.prelu(x, "element"),
    "space_to_depth": lambda L, x: L.space_to_depth(x, 2),
    "fsp_matrix": lambda L, x: L.fsp_matrix(x, L.scale(x, 2.0)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_and_runs_as_jax(name):
    jm, js, jo = _layer_program(fluid, LAYERS[name])
    tm, ts, to = _layer_program(pt, LAYERS[name])
    for jp, tp in ((jm, tm), (js, ts)):
        jd, td = jp.to_dict(), tp.to_dict()
        assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
        assert ({v["name"]: (v["shape"], v["dtype"]) for v in td["blocks"][0]["vars"]}
                == {v["name"]: (v["shape"], v["dtype"]) for v in jd["blocks"][0]["vars"]})
    feed = {"x": np.random.RandomState(1).randn(2, 8, 6, 6).astype("float32")}
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        state = {n: np.asarray(scope.find_var(n)) for n, v in jm.global_block().vars.items()
                 if v.persistable}
        want = np.asarray(exe.run(jm, feed=feed, fetch_list=[jo])[0])
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(state, device="cpu"))
    with pt.scope_guard(tscope):
        got = pt.Executor(CPU).run(tm, feed=feed, fetch_list=[to])[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- the NCHW s2d ResNet

def _resnet(pkg, res, image, classes):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, image, image], "float32")
        label = pkg.data("label", [1], "int64")
        loss, _, _ = res.resnet50(img, label, num_classes=classes, data_format="NCHW",
                                  conv1_space_to_depth=True)
        pkg.optimizer.Momentum(1e-3, 0.9).minimize(loss)
    return main, startup, loss


def test_nchw_space_to_depth_resnet50_builds_the_jax_program():
    jm, _, _ = _resnet(fluid, jres, 224, 1000)
    tm, _, _ = _resnet(pt, tres, 224, 1000)
    jd, td = jm.to_dict(), tm.to_dict()
    assert td["blocks"][0]["ops"] == jd["blocks"][0]["ops"]
    stem = [o for o in td["blocks"][0]["ops"] if o["type"] == "space_to_depth"]
    assert len(stem) == 1 and stem[0]["attrs"]["blocksize"] == 2
    ops = tm.global_block().ops
    at = [o.type for o in ops].index("space_to_depth")
    stem_conv = next(o for o in ops[at:] if o.type == "conv2d")
    assert tm.global_block().var(stem_conv.inputs["Filter"][0]).shape == (64, 12, 4, 4)


def test_nchw_space_to_depth_resnet_step_matches_jax(monkeypatch):
    """One bottleneck a stage, 64 x 64, batch 2: one Momentum step from the
    JAX startup state. (At 32 x 32 the last stage's batch norms reduce 2
    values a channel, whose E[x^2] - E[x]^2 cancels: the two packages' f32
    sums part the loss by 7e-5 there, by 9e-7 at 64 x 64.)"""
    monkeypatch.setitem(jres._DEPTHS, 50, [1, 1, 1, 1])
    monkeypatch.setitem(tres._DEPTHS, 50, [1, 1, 1, 1])
    jm, js, jl = _resnet(fluid, jres, 64, 10)
    tm, _, tl = _resnet(pt, tres, 64, 10)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(2, 3, 64, 64).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    exe, jscope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jloss = float(np.asarray(exe.run(jm, feed=feed, fetch_list=[jl])[0]).reshape(()))
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        tloss = float(np.asarray(pt.Executor(CPU).run(tm, feed=feed, fetch_list=[tl])[0])
                      .reshape(()))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for n in names:
        got, want = tscope.find_var(n).numpy(), jfinal[n]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max(),
                                   err_msg=n)
