"""``paddle_tpu_torch.contrib.slim`` (pruning and distillation) against the
JAX package's ``contrib.slim`` on the CPU.

The cases of ``tests/test_slim.py`` on the port, each beside the JAX run:
the pruners' indices and tensors equal; masks computed from the same
weights equal, bit for bit (both rank the same numpy values); a pruned
convnet's finetune steps from the JAX state with the JAX masks, losses
``rtol 1e-5`` and state ``atol 5e-5`` (f32 sums in other orders, as
``tests/test_torch_training.py``), every pruned entry exactly 0 in both;
the distillers' programs op for op and their losses ``rtol 1e-5``.

Then the bf16 mask write: on a bf16 model the JAX package's in-place
``elementwise_mul`` by the float32 mask widens the parameter to float32
(ROADMAP 3.27, held here so that a change shows), where the port's rewrite
casts the product back, so the parameter stays bf16 with the same values.
Last, ``examples/prune_finetune.py``'s program (its convnet and constants,
fewer images) trains, prunes and finetunes on the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.contrib import slim as jslim
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import slim as tslim

PKGS = {"jax": (fluid, jslim), "port": (pt, tslim)}
LOSS_RTOL, STATE_ATOL = 1e-5, 5e-5


def _exe(pkg):
    return fluid.Executor() if pkg is fluid else pt.Executor(pt.CPUPlace())


def _value(pkg, scope, name):
    v = scope.find_var(name)
    return np.asarray(v) if pkg is fluid else v.float().numpy().copy()


def _convnet(pkg, seed=5, image=16, widths=(16, 32), opt=None, dtype="float32"):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, image, image], dtype)
        label = pkg.data("label", [1], "int64")
        h = pkg.layers.conv2d(img, widths[0], 3, padding=1, act="relu")
        h = pkg.layers.pool2d(h, 2, "max", 2)
        h = pkg.layers.conv2d(h, widths[1], 3, padding=1, act="relu")
        h = pkg.layers.pool2d(h, 2, "max", 2)
        logits = pkg.layers.fc(h, 10)
        if dtype != "float32":
            logits = pkg.layers.cast(logits, "float32")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        acc = pkg.layers.accuracy(logits, label)
        (opt or (lambda: pkg.optimizer.Momentum(0.05, 0.9)))().minimize(loss)
    return main, startup, loss, acc


def _data(rng, n=16, image=16):
    img = rng.rand(n, 3, image, image).astype("float32")
    label = (img.mean(axis=(1, 2, 3)) * 10).astype("int64").clip(0, 9)[:, None]
    return {"img": img, "label": label}


def _steps(pkg, exe, main, loss, feed, k):
    return [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss])[0]).reshape(()))
            for _ in range(k)]


def _persistables(main):
    return sorted(n for n, v in main.global_block().vars.items() if v.persistable)


def test_structure_pruner_matches_jax():
    w = np.array([[1.0, 1.0], [0.1, 0.1], [5.0, 5.0], [0.2, 0.2]], "float32")
    outs = {}
    for label, (_, slim) in PKGS.items():
        p = slim.StructurePruner({"*": 0})
        idx = p.cal_pruned_idx("w", w, 0.5)
        outs[label] = (idx, p.prune_tensor(w, idx, 0, lazy=True),
                       p.prune_tensor(w, idx, 0, lazy=False))
    assert sorted(outs["port"][0]) == [1, 3]
    assert outs["port"][0] == outs["jax"][0]
    for a, b in zip(outs["port"][1:], outs["jax"][1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("structured", [False, True])
def test_pruned_finetune_equals_jax(structured):
    """2 Momentum steps, the masks from the JAX weights (the port's own
    masks from the same weights equal them), 2 finetune steps."""
    feed = _data(np.random.RandomState(0))
    kw = dict(ratio=0.25, params=[r"conv2d_0\.w_0"], structured_axis=0) if structured \
        else dict(ratio=0.5)
    jm, js, jl, _ = _convnet(fluid)
    tm, _, tl, _ = _convnet(pt)
    names = _persistables(jm)
    exe, jscope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jpre = _steps(fluid, exe, jm, jl, feed, 2)
        trained = {n: np.asarray(jscope.find_var(n)) for n in names}
        masks = jslim.compute_magnitude_masks(jscope, jm, **kw)
        jslim.apply_pruning_masks(jm, jscope, masks)
        jsparsity = jslim.sparsity(jscope, masks)
        jfine = _steps(fluid, exe, jm, jl, feed, 2)
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in _persistables(jm)}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy({n: a.copy() for n, a in init.items()},
                                                        device="cpu"))
    texe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(tscope):
        tpre = _steps(pt, texe, tm, tl, feed, 2)
        for n in names:
            np.testing.assert_allclose(tscope.find_var(n).numpy(), trained[n], rtol=0,
                                       atol=STATE_ATOL, err_msg=n)
    own = tslim.compute_magnitude_masks(_scope_of(trained), tm, **kw)
    assert sorted(own) == sorted(masks)
    for n in masks:
        np.testing.assert_array_equal(own[n], masks[n])
    with pt.scope_guard(tscope):
        tslim.apply_pruning_masks(tm, tscope, masks)
        assert tslim.sparsity(tscope, masks) == pytest.approx(jsparsity, abs=1e-3)
        tfine = _steps(pt, texe, tm, tl, feed, 2)
    np.testing.assert_allclose(tpre + tfine, jpre + jfine, rtol=LOSS_RTOL)
    assert [op.type for op in tm.global_block().ops] == [op.type for op in jm.global_block().ops]
    for n in _persistables(tm):
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], rtol=0,
                                   atol=STATE_ATOL, err_msg=n)
    for n, mask in masks.items():
        for w in (tscope.find_var(n).numpy(), jfinal[n]):
            assert np.abs(w[np.asarray(mask) == 0]).max() == 0.0, n
    if structured:
        zero_rows = (masks["conv2d_0.w_0"].reshape(16, -1) == 0).all(axis=1)
        assert zero_rows.sum() == 4


def _scope_of(arrays):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(
        {n: a.copy() for n, a in arrays.items()}, device="cpu"))
    return scope


def test_a_second_rewrite_is_refused_in_both():
    for pkg, slim in PKGS.values():
        main, startup, _, _ = _convnet(pkg)
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            _exe(pkg).run(startup)
            masks = slim.compute_magnitude_masks(scope, main, 0.5, params=[r"fc_0\.w_0"])
            slim.apply_pruning_masks(main, scope, masks)
            with pytest.raises(ValueError, match="already has pruning masks"):
                slim.apply_pruning_masks(main, scope, masks)


def _distill(pkg, slim):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [8], "float32")
        teacher = pkg.layers.fc(x, 4, param_attr=pkg.ParamAttr(name="teacher_w"))
        student = pkg.layers.fc(x, 4, param_attr=pkg.ParamAttr(name="student_w"))
        l2 = slim.L2Distiller("student", "teacher").distiller_loss(student, teacher)
        soft = slim.SoftLabelDistiller(student_temperature=2.0,
                                       teacher_temperature=2.0).distiller_loss(student, teacher)
        total = pkg.layers.elementwise_add(l2, soft)
        pkg.optimizer.SGD(0.2).minimize(total)
    return main, startup, total


def _fsp(pkg, slim):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, 8, 8], "float32")
        s0 = pkg.layers.conv2d(img, 4, 3, padding=1)
        s1 = pkg.layers.conv2d(s0, 4, 3, padding=1)
        t0 = pkg.layers.conv2d(img, 4, 3, padding=1)
        t1 = pkg.layers.conv2d(t0, 4, 3, padding=1)
        loss = slim.FSPDistiller([("s0", "s1")], [("t0", "t1")]).distiller_loss(
            [(s0, s1)], [(t0, t1)])
        pkg.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("which", ["l2_soft_label", "fsp"])
def test_distillers_match_jax_and_freeze_the_teacher(which):
    build = _distill if which == "l2_soft_label" else _fsp
    rng = np.random.RandomState(2)
    feed = ({"x": rng.randn(32, 8).astype("float32")} if which == "l2_soft_label"
            else {"img": rng.randn(2, 3, 8, 8).astype("float32")})
    runs = {}
    for label, (pkg, slim) in PKGS.items():
        main, startup, loss = build(pkg, slim)
        runs[label] = main
        scope = pkg.Scope()
        with pkg.scope_guard(scope):
            if pkg is fluid:
                _exe(pkg).run(startup)
                init = {n: np.asarray(scope.find_var(n)) for n in _persistables(main)}
            else:
                convert.load_state(scope, convert.state_from_numpy(
                    {n: a.copy() for n, a in init.items()}, device="cpu"))
            teacher = {n: _value(pkg, scope, n) for n in _persistables(main)
                       if n == "teacher_w" or n.startswith("conv2d_2") or n.startswith("conv2d_3")}
            runs[label] = (main, _steps(pkg, _exe(pkg), main, loss, feed, 5))
            for n, v in teacher.items():
                np.testing.assert_array_equal(_value(pkg, scope, n), v, err_msg=f"{label} {n}")
    (jm, jl), (tm, tl) = runs["jax"], runs["port"]
    assert [b["ops"] for b in tm.to_dict()["blocks"]] == [b["ops"] for b in jm.to_dict()["blocks"]]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]


def test_a_bf16_mask_write_keeps_the_port_parameter_bf16():
    """One Momentum step of a pruned bf16 convnet: the JAX package writes the
    float32 product into the bf16 parameter (ROADMAP 3.27); the port's
    ``cast`` keeps it bf16, with the same values, pruned entries exactly 0,
    over 3 steps."""
    feed = _data(np.random.RandomState(1), n=4, image=8)
    names = ["conv2d_0.w_0", "conv2d_1.w_0", "fc_0.w_0"]
    jm, js, jl, _ = _convnet(fluid, image=8, widths=(4, 8), dtype="bfloat16")
    tm, _, tl, _ = _convnet(pt, image=8, widths=(4, 8), dtype="bfloat16")
    jfeed = dict(feed, img=jnp.asarray(feed["img"], jnp.bfloat16))
    exe, jscope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in _persistables(jm)}
        tags = {n: "bfloat16" for n, a in init.items() if str(a.dtype) == "bfloat16"}
        masks = jslim.compute_magnitude_masks(jscope, jm, 0.5)
        assert sorted(masks) == names
        jslim.apply_pruning_masks(jm, jscope, masks)
        assert all(str(jscope.find_var(n).dtype) == "bfloat16" for n in names)
        exe.run(jm, feed=jfeed, fetch_list=[jl])
        widened = {n: str(jscope.find_var(n).dtype) for n in names}
        jstep = {n: np.asarray(jscope.find_var(n), np.float32) for n in names}
    assert widened == {n: "float32" for n in names}          # ROADMAP 3.27
    init = {n: (a.view(np.uint16) if n in tags else a.copy()) for n, a in init.items()}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu", dtype_tags=tags))
    texe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(tscope):
        tslim.apply_pruning_masks(tm, tscope, masks)
        for step in range(3):
            texe.run(tm, feed=dict(feed, img=torch.from_numpy(feed["img"]).to(torch.bfloat16)),
                     fetch_list=[tl])
            for n in names:
                w = tscope.find_var(n)
                assert str(w.dtype) == "torch.bfloat16", (step, n, w.dtype)
                assert (w.float().numpy()[masks[n] == 0] == 0).all(), (step, n)
            if step == 0:
                for n in names:
                    got = tscope.find_var(n).float().numpy()
                    # one bf16 ulp (2^-7 relative): the two sum the gradients in
                    # other orders before the bf16 update rounds
                    np.testing.assert_allclose(got, jstep[n], rtol=2 ** -7, atol=1e-6,
                                               err_msg=n)
    ops = [op.type for op in tm.global_block().ops]
    assert ops[-2 * len(names):] == ["elementwise_mul", "cast"] * len(names)


def test_the_prune_finetune_example_runs_on_the_port():
    """``examples/prune_finetune.py``'s convnet and constants (32 x 32,
    widths 32 / 64, Momentum 0.02, batch 64) on 128 synthetic images: train,
    prune half the weights, finetune; the pruned weights stay exactly 0 and
    the finetune lowers the loss."""
    rng = np.random.RandomState(0)
    imgs = rng.rand(128, 3, 32, 32).astype("float32")
    labels = (imgs.mean(axis=(1, 2, 3)) * 10).astype("int64").clip(0, 9)[:, None]
    main, startup, loss, acc = _convnet(pt, seed=0, image=32, widths=(32, 64),
                                        opt=lambda: pt.optimizer.Momentum(0.02, 0.9))
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    batches = [{"img": imgs[i:i + 64], "label": labels[i:i + 64]} for i in (0, 64)]
    with pt.scope_guard(scope):
        exe.run(startup)
        for _ in range(2):
            for feed in batches:
                exe.run(main, feed=feed, fetch_list=[loss, acc])
        masks = tslim.compute_magnitude_masks(scope, main, ratio=0.5)
        assert sorted(masks) == ["conv2d_0.w_0", "conv2d_1.w_0", "fc_0.w_0"]
        tslim.apply_pruning_masks(main, scope, masks)
        assert abs(tslim.sparsity(scope, masks) - 0.5) < 0.02
        fine = [float(exe.run(main, feed=feed, fetch_list=[loss, acc])[0])
                for _ in range(3) for feed in batches]
        for name, mask in masks.items():
            assert np.abs(scope.find_var(name).numpy()[mask == 0]).max() == 0.0
    assert np.isfinite(fine).all() and fine[-1] < fine[0]
