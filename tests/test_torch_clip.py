"""The clip classes (``clip.py``) and the regularizers (``regularizer.py``)
of the port on the CPU: one step of a tiny MLP under each, its program and
its parameters held against the JAX package's on the same numpy inputs.

Tolerances: the loss ``rtol 1e-5``; every parameter after the step ``atol
1e-6, rtol 1e-5`` (SGD: lr times a gradient that the two frameworks sum in
other orders, about 1e-7 relative); under Adam the first update is lr g /
(|g| + eps), which the same rounding moves by far less than 1e-6 at lr
1e-2.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import mnist as jmnist
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import mnist as tmnist
from tests.test_torch_ctr import IMG, _mlp_feeds, _persistables, _train_jax, _train_port


def _mlp(pkg, model, opt, clip=None, grad_clip=None, param_reg=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 3
    startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [IMG], "float32")
        label = pkg.data("label", [1], "int64")
        if param_reg is not None:            # a per-parameter regularizer on the first fc
            h = pkg.layers.fc(img, 16, act="relu",
                              param_attr=pkg.ParamAttr(name="w_reg",
                                                       regularizer=param_reg(pkg)))
            loss, acc, _ = model.mlp(h, label, hidden=(8,))
        else:
            loss, acc, _ = model.mlp(img, label, hidden=(16, 8))
        if clip is not None:
            clip(pkg)
        _, params_grads = opt(pkg).minimize(
            loss, grad_clip=grad_clip(pkg) if grad_clip is not None else None)
    return main, startup, loss, acc, params_grads


def _sgd(pkg):
    return pkg.optimizer.SGD(0.1)


def _set_clip(make):
    return lambda pkg: pkg.clip.set_gradient_clip(make(pkg))


def _two_global_norm_groups(pkg):
    """Two ByGlobalNorm groups: the first fc's weight alone, the rest."""
    params = pkg.default_main_program().all_parameters()
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.05, group_name="a"),
                               param_list=[params[0]])
    pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.2, group_name="b"),
                               param_list=[p.name for p in params[1:]])


# id -> keyword arguments of _mlp (each a function of the package)
VARIANTS = {
    "sgd": dict(opt=_sgd),
    "clip-by-value": dict(opt=_sgd, clip=_set_clip(
        lambda pkg: pkg.clip.GradientClipByValue(0.01))),
    "clip-by-value-min": dict(opt=_sgd, clip=_set_clip(
        lambda pkg: pkg.clip.GradientClipByValue(0.02, min=-0.005))),
    "clip-by-norm": dict(opt=_sgd, clip=_set_clip(
        lambda pkg: pkg.clip.GradientClipByNorm(0.05))),
    "clip-by-global-norm": dict(opt=_sgd, clip=_set_clip(
        lambda pkg: pkg.clip.GradientClipByGlobalNorm(0.1))),
    "clip-by-global-norm-two-groups": dict(opt=_sgd, clip=_two_global_norm_groups),
    "minimize-grad-clip": dict(opt=_sgd, grad_clip=lambda pkg:
                               pkg.clip.GradientClipByGlobalNorm(0.1)),
    "l2-decay": dict(opt=lambda pkg: pkg.optimizer.SGD(
        0.1, regularization=pkg.regularizer.L2Decay(0.5))),
    "l1-decay": dict(opt=lambda pkg: pkg.optimizer.SGD(
        0.1, regularization=pkg.regularizer.L1Decay(0.01))),
    "param-regularizer-wins": dict(
        opt=lambda pkg: pkg.optimizer.SGD(0.1, regularization=pkg.regularizer.L2Decay(0.5)),
        param_reg=lambda pkg: pkg.regularizer.L1Decay(0.01)),
    "adam-clip-and-decay": dict(
        opt=lambda pkg: pkg.optimizer.Adam(0.01, regularization=pkg.regularizer.L2Decay(0.1)),
        clip=_set_clip(lambda pkg: pkg.clip.GradientClipByNorm(0.05))),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_one_step_of_a_clipped_or_decayed_mlp_matches_jax(variant):
    """One step of a tiny MLP under each clip class and regularizer: the same
    program as the JAX package's, and every parameter after the step."""
    kw = VARIANTS[variant]
    jm, js, jl, _, jpg = _mlp(fluid, jmnist, **kw)
    tm, _, tl, _, tpg = _mlp(pt, tmnist, **kw)
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]
    assert [(p.name, g.name) for p, g in tpg] == [(p.name, g.name) for p, g in jpg]
    names = _persistables(jm)
    init, jouts, jfinal = _train_jax(jm, js, [jl], [_mlp_feeds()], 1, names)
    touts, tscope = _train_port(tm, [tl], [_mlp_feeds()], 1, init)
    np.testing.assert_allclose(touts[0][0], jouts[0][0], rtol=1e-5)
    moved = 0
    for n in names:
        got, want = tscope.find_var(n).numpy(), jfinal[n]
        np.testing.assert_allclose(got, want, err_msg=n, atol=1e-6, rtol=1e-5)
        moved += int(not np.array_equal(want, init[n]))
    assert moved >= 1


def test_clip_and_decay_ops_are_in_the_program():
    """What each variant appends, counted (the JAX programs hold the same)."""
    count = lambda variant, t: [op.type for op in _mlp(
        pt, tmnist, **VARIANTS[variant])[0].global_block().ops].count(t)
    n_params = 6
    assert count("clip-by-value", "clip") == n_params
    assert count("clip-by-norm", "clip_by_norm") == n_params
    assert count("clip-by-global-norm", "squared_l2_norm") == n_params
    assert count("clip-by-global-norm", "sqrt") == 1
    assert count("clip-by-global-norm-two-groups", "sqrt") == 2
    assert count("l2-decay", "scale") == n_params and count("l1-decay", "sign") == n_params
    # the per-parameter L1 on w_reg wins over the optimizer's L2
    assert count("param-regularizer-wins", "sign") == 1
    assert count("sgd", "sgd") == n_params


def test_error_clip_and_the_null_clip_hold_what_the_jax_ones_hold():
    """``ErrorClipByValue`` records its bounds (min defaults to -max) and
    ``NullGradientClipAttr`` passes the gradient through, as in the JAX
    package."""
    for pkg in (fluid, pt):
        e = pkg.clip.ErrorClipByValue(2.0)
        assert (e.max, e.min) == (2.0, -2.0)
        assert pkg.clip.ErrorClipByValue(2.0, min=-1.0).min == -1.0
        assert pkg.clip.NullGradientClipAttr()._create_operators("p", "g") == ("p", "g")
