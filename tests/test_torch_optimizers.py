"""The optimizer surface of the port (``ops/optimizer_ops.py``,
``optimizer.py``, ``initializer.py``, ``contrib/extend_optimizer.py``) held
against the JAX package on the CPU, on the same numpy inputs.

Tolerances, each with its reason:
- update ops: the case's (``tools/op_cases.py``): f32 ``atol 1e-5, rtol
  1e-5`` (the two sides round square roots, powers and sums in other
  orders, a few ulps); a bf16 parameter ``atol 1e-2, rtol 1e-2`` (one bf16
  ulp is 2^-8 relative);
- ``dpsgd``: its noise comes from each package's own generator, so it is
  held by its statistics (``op_cases.noise_stats``);
- programs: op types, attrs, parameter and accumulator names exactly;
- training runs from one state in f32: losses ``rtol 1e-5`` and every state
  tensor ``atol 5e-5`` over a few steps (sums in other orders, about 1e-6 a
  step; an early adaptive update divides by about |grad|);
- the quadratic problem's converge bound is the JAX suite's
  (``tests/test_optimizers.py``: final loss under 2e-2).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import resnet as jres
from paddle_tpu.contrib import extend_with_decoupled_weight_decay as jextend
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.contrib import extend_with_decoupled_weight_decay as textend
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor import capture_refusal
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.tools import op_cases
from paddle_tpu_torch.tools.op_cases import CASES

CPU = pt.CPUPlace()
UPDATE_CASES = sorted(k for k, c in CASES.items() if c.op in op_cases.UPDATE_OPS)


# ------------------------------------------------------------------ the update ops

def _jax_in(a, dtype):
    a = np.array(a)
    return jnp.asarray(a, jnp.bfloat16) if (dtype == "bfloat16" and a.dtype.kind == "f") \
        else jnp.asarray(a)


def test_the_fourteen_update_ops_are_registered():
    ops = op_cases.UPDATE_OPS + tuple(op_cases.NOISE_CASES)
    assert len(set(ops)) == 14
    for op in ops:
        assert treg.get(op).grad is None and jreg.get(op).grad is None, op
        assert treg.get(op).host_rng == (op == "dpsgd"), op
    assert {CASES[k].op for k in UPDATE_CASES} == set(op_cases.UPDATE_OPS)


@pytest.mark.parametrize("name", UPDATE_CASES)
def test_update_op_matches_jax_lowering(name):
    c = CASES[name]
    jouts = jreg.get(c.op).lower(jreg.LowerCtx(dict(c.attrs)), {
        s: [_jax_in(a, op_cases.slot_dtype(c, s)) for a in v] for s, v in c.ins.items()})
    touts = op_cases.forward(name, "cpu")
    assert sorted(touts) == sorted(jouts)
    for slot, vals in touts.items():
        want = op_cases.numpy_outs({"x": [jouts[slot][0]]})["x"][0]
        got = vals[0]
        # ParamOut keeps the parameter's dtype, the state stays f32
        src = "Param" if slot == "ParamOut" else None
        if src is not None:
            assert str(got.dtype)[6:] == op_cases.slot_dtype(c, src), slot
        got = op_cases.numpy_outs({"x": [got]})["x"][0]
        assert got.shape == want.shape, slot
        np.testing.assert_allclose(got, want, err_msg=f"{name} {slot}", **c.tol)


def test_dpsgd_noise_holds_its_distribution():
    ins, attrs = op_cases.NOISE_CASES["dpsgd"]
    jout = jreg.get("dpsgd").lower(jreg.LowerCtx(dict(attrs)),
                                   {s: [jnp.asarray(a) for a in v] for s, v in ins.items()})
    tout = treg.get("dpsgd").lower(treg.LowerCtx(dict(attrs), seed=3, counter=1),
                                   {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()})
    for out in (np.asarray(jout["ParamOut"][0]), tout["ParamOut"][0].numpy()):
        why = op_cases.noise_stats("dpsgd", out)
        assert why is None, why


# ------------------------------------------------------------------ the classes

def _factories(pkg):
    o = pkg.optimizer
    excl = lambda p: p.name.endswith(".b_0")
    return {
        "sgd": lambda: o.SGD(0.5), "momentum": lambda: o.Momentum(0.1, 0.9),
        "nesterov": lambda: o.Momentum(0.1, 0.9, use_nesterov=True),
        "adam": lambda: o.Adam(0.1), "adamw": lambda: o.AdamW(0.1),
        "adagrad": lambda: o.Adagrad(0.5), "adamax": lambda: o.Adamax(0.1),
        "adadelta": lambda: o.Adadelta(1.0, rho=0.9, epsilon=0.1),
        "rmsprop": lambda: o.RMSProp(0.05),
        "rmsprop_centered": lambda: o.RMSProp(0.05, momentum=0.5, centered=True),
        "lamb": lambda: o.Lamb(0.1, lamb_weight_decay=0.0),
        "lamb_excluding": lambda: o.Lamb(0.1, exclude_from_weight_decay_fn=excl),
        "decayed_adagrad": lambda: o.DecayedAdagrad(0.05, decay=0.5),
        "ftrl": lambda: o.Ftrl(0.5), "lars": lambda: o.LarsMomentum(1.0, 0.9, lars_coeff=0.01),
        "dpsgd": lambda: o.Dpsgd(0.1, sigma=0.0),
        "adamw_long_name": lambda: o.AdamWOptimizer(0.1, weight_decay=0.02),
    }


FACTORY_IDS = sorted(_factories(fluid))
#: the JAX suite's converge cases (``tests/test_optimizers.py``), by factory id
CONVERGE_IDS = ["sgd", "momentum", "nesterov", "adam", "adamw", "adagrad", "adamax",
                "adadelta", "rmsprop", "lamb", "decayed_adagrad", "ftrl", "lars"]


def _mlp(pkg, make_opt):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 2
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [16], "float32")
        label = pkg.data("label", [1], "int64")
        h = pkg.layers.fc(x, 8, act="relu")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(h, 4), label))
        out = make_opt(pkg)
        opt = out.minimize(loss) if hasattr(out, "minimize") else None
    return main, startup, loss, opt


def _feeds(seed=0, B=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 16).astype("float32")
    W = rng.randn(16, 4).astype("float32")
    return {"x": x, "label": np.argmax(x @ W, 1)[:, None].astype("int64")}


def _program_summary(program):
    blk = program.global_block()
    return ([(op.type, sorted((k, v) for k, v in op.attrs.items()
                              if not k.startswith("__") and k != "op_device"))
             for op in blk.ops],
            sorted(n for n, v in blk.vars.items() if v.persistable))


@pytest.mark.parametrize("name", FACTORY_IDS)
def test_minimize_builds_the_jax_program(name):
    """Each class's ``minimize``: the same ops with the same attrs in the
    same order, and the same persistable names (parameters, learning rate,
    accumulators from ``unique_name``)."""
    jm, js, _, _ = _mlp(fluid, lambda pkg: _factories(pkg)[name]())
    tm, ts, _, _ = _mlp(pt, lambda pkg: _factories(pkg)[name]())
    assert _program_summary(tm) == _program_summary(jm)
    assert [op.type for op in ts.global_block().ops] == [op.type for op in js.global_block().ops]


def _quadratic(pkg, opt_factory, steps=150):
    """||w - target||^2 minimised by the optimizer (``tests/test_optimizers.py``)."""
    main, startup = pkg.Program(), pkg.Program()
    target = np.arange(6, dtype="float32").reshape(2, 3) / 6.0
    with pkg.program_guard(main, startup):
        w = pkg.layers.create_parameter([2, 3], "float32", name="w")
        t = pkg.layers.assign(target)
        loss = pkg.layers.reduce_mean(pkg.layers.square(w - t))
        opt_factory().minimize(loss)
    exe = pt.Executor(CPU)
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(steps):
            lossv, = exe.run(main, fetch_list=[loss])
    return float(np.asarray(lossv).reshape(()))


@pytest.mark.parametrize("name", CONVERGE_IDS)
def test_optimizer_converges(name):
    final = _quadratic(pt, _factories(pt)[name])
    assert final < 2e-2, f"did not converge: {final}"


def _run_both(jm, js, jl, tm, tl, feeds, steps, fetch_extra=()):
    """``steps`` runs of the JAX program from its startup state, then of the
    port's from the same state: (JAX losses, port losses, JAX final state,
    port scope, the names)."""
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    exe = fluid.Executor()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jl_ = [float(exe.run(jm, feed=feeds, fetch_list=[jl])[0].reshape(-1)[0])
               for _ in range(steps)]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        texe = pt.Executor(CPU)
        tl_ = [float(texe.run(tm, feed=feeds, fetch_list=[tl])[0].reshape(-1)[0])
               for _ in range(steps)]
    return jl_, tl_, jfinal, tscope, names


@pytest.mark.parametrize("name", ["adamw", "adamax", "rmsprop_centered", "ftrl",
                                  "lamb_excluding", "lars", "adadelta", "adagrad",
                                  "decayed_adagrad"])
def test_steps_match_jax(name):
    """Five steps of the MLP from one state under the class: losses and every
    state tensor against the JAX package's. The JAX package's startup state
    (every accumulator: ``moment``, ``inf_norm``, ``avg_squared_*``,
    ``mean_square``, ``mean_grad``, ``squared``, ``linear``, ``velocity``)
    carries into the port by name through ``convert.state_from_numpy``."""
    jm, js, jl, _ = _mlp(fluid, lambda pkg: _factories(pkg)[name]())
    tm, _, tl, _ = _mlp(pt, lambda pkg: _factories(pkg)[name]())
    jls, tls, jfinal, tscope, names = _run_both(jm, js, jl, tm, tl, _feeds(), 5)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=5e-5,
                                   err_msg=n)


def test_lars_trains_a_tiny_resnet_like_jax(monkeypatch):
    """Three ``LarsMomentum`` steps of the one-block-per-stage ResNet at
    64 x 64 (32 x 32 splits the packages after a step: ROADMAP fault 3.7)."""
    from paddle_tpu.contrib import fuse_conv_bn_stats as jfuse
    from paddle_tpu_torch.contrib import fuse_conv_bn_stats as tfuse
    monkeypatch.setitem(jres._DEPTHS, 50, [1, 1, 1, 1])
    monkeypatch.setitem(tres._DEPTHS, 50, [1, 1, 1, 1])

    def build(pkg, res, fuse_fn):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 0
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            img = pkg.data("img", [64, 64, 3], "float32")
            label = pkg.data("label", [1], "int64")
            loss, _, _ = res.resnet50(img, label, num_classes=10, data_format="NHWC",
                                      conv1_space_to_depth=True)
            for op in main.global_block().ops:
                if op.type == "batch_norm":
                    op.attrs["fuse_stats"] = True
            fuse_fn(main)
            pkg.optimizer.LarsMomentum(0.1, 0.9).minimize(loss)
        return main, startup, loss

    jm, js, jl = build(fluid, jres, jfuse)
    tm, _, tl = build(pt, tres, tfuse)
    assert _program_summary(tm) == _program_summary(jm)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(2, 64, 64, 3).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    jls, tls, jfinal, tscope, names = _run_both(jm, js, jl, tm, tl, feed, 3)
    # the ResNet suite's tolerances (tests/test_torch_resnet.py): convolutions
    # and batch norms sum in other orders through 50 layers' worth of ops
    np.testing.assert_allclose(tls, jls, rtol=1e-4)
    for n in names:
        got, want = tscope.find_var(n).numpy(), jfinal[n]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4 * np.abs(want).max(),
                                   err_msg=n)


# ------------------------------------------------------------------ the wrappers

def _wrapped(pkg, kind):
    """The MLP under ``kind`` (ema / model_average / lookahead) over SGD(0.5),
    as ``tests/test_training_utils.py`` builds it."""
    held = {}

    def make(p):
        if kind == "lookahead":
            return p.optimizer.LookaheadOptimizer(p.optimizer.SGD(0.2), alpha=0.5, k=3)

        class Then:
            def minimize(self, loss):
                out = p.optimizer.SGD(0.5).minimize(loss)
                held["w"] = (p.optimizer.ExponentialMovingAverage(0.5) if kind == "ema"
                             else p.optimizer.ModelAverage())
                held["w"].update()
                return out
        return Then()

    main, startup, loss, _ = _mlp(pkg, make)
    return main, startup, loss, held.get("w")


@pytest.mark.parametrize("kind,steps", [("ema", 5), ("model_average", 4), ("lookahead", 9)])
def test_wrapper_matches_jax(kind, steps):
    """The wrapper's program (its in-graph ops) and ``steps`` steps from one
    state against the JAX package's; then ``apply()`` writes the JAX
    package's values into the parameters and ``restore()`` (on leaving the
    guard) puts back the trained ones, bit for bit."""
    jm, js, jl, jw = _wrapped(fluid, kind)
    tm, _, tl, tw = _wrapped(pt, kind)
    assert _program_summary(tm) == _program_summary(jm)
    feeds = _feeds()
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    exe = fluid.Executor()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jls = [float(exe.run(jm, feed=feeds, fetch_list=[jl])[0][0]) for _ in range(steps)]
        japplied = None
        if jw is not None:
            with jw.apply():
                japplied = {p.name: np.asarray(jscope.find_var(p.name)).copy()
                            for p in jm.all_parameters()}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        texe = pt.Executor(CPU)
        tls = [float(texe.run(tm, feed=feeds, fetch_list=[tl])[0][0]) for _ in range(steps)]
        if kind == "lookahead":
            assert tls[-1] < tls[0]
        if tw is None:
            np.testing.assert_allclose(tls, jls, rtol=1e-5)
            return
        trained = {n: tscope.find_var(n).clone() for n in japplied}
        held = {n: tscope.find_var(n) for n in japplied}
        with tw.apply():
            for n, want in japplied.items():
                assert tscope.find_var(n) is held[n]      # written in place
                np.testing.assert_allclose(tscope.find_var(n).numpy(), want, rtol=1e-5,
                                           atol=1e-6, err_msg=n)
                assert not torch.equal(tscope.find_var(n), trained[n])
        for n, t in trained.items():
            assert torch.equal(tscope.find_var(n), t), n
    np.testing.assert_allclose(tls, jls, rtol=1e-5)


def test_ema_apply_is_numpy_over_the_scope():
    """``apply`` writes shadow / (1 - decay^t) exactly as numpy computes it
    from the scope's values (the shadows start at 0)."""
    tm, ts, tl, ema = _wrapped(pt, "ema")
    with pt.scope_guard(pt.Scope()):
        scope = pt.global_scope()
        exe = pt.Executor(CPU)
        exe.run(ts)
        for _ in range(3):
            exe.run(tm, feed=_feeds(), fetch_list=[tl])
        pw = np.float32(scope.find_var(ema._decay_pow_name).numpy()[0])
        assert pw == np.float32(0.5) ** 3
        want = {p: scope.find_var(s).numpy() / (np.float32(1.0) - pw)
                for p, s in ema._shadow.items()}
        with ema.apply():
            for p, w in want.items():
                np.testing.assert_array_equal(scope.find_var(p).numpy(), w)


def test_decoupled_weight_decay_matches_jax():
    """``extend_with_decoupled_weight_decay(Adam)``: the same program (the
    decay's ``scale``, ``elementwise_sub`` and ``assign`` before the update)
    and three steps against the JAX package's."""
    def make(pkg, ext):
        return ext(pkg.optimizer.Adam)(weight_decay=0.1, learning_rate=0.05,
                                       apply_decay_param_fun=lambda n: n.endswith(".w_0"))
    jm, js, jl, _ = _mlp(fluid, lambda pkg: make(pkg, jextend))
    tm, _, tl, _ = _mlp(pt, lambda pkg: make(pkg, textend))
    assert _program_summary(tm) == _program_summary(jm)
    assert "elementwise_sub" in [op.type for op in tm.global_block().ops]
    jls, tls, jfinal, tscope, names = _run_both(jm, js, jl, tm, tl, _feeds(), 3)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=5e-5, err_msg=n)
    with pytest.raises(TypeError):
        textend(object)


def test_dgc_momentum_raises_as_the_jax_package_does():
    for pkg in (fluid, pt):
        with pytest.raises(NotImplementedError):
            pkg.optimizer.DGCMomentumOptimizer(0.1, 0.9)


def test_a_dpsgd_program_is_not_captured():
    """``dpsgd`` draws from a host-seeded generator: the executor refuses to
    capture its program (a replay would draw the captured run's noise) and
    ``run_fused`` refuses it; it runs eagerly."""
    tm, ts, tl, _ = _mlp(pt, lambda pkg: pkg.optimizer.Dpsgd(0.1, sigma=1.0))
    assert "dpsgd" in capture_refusal(tm)
    plain, _, _, _ = _mlp(pt, lambda pkg: pkg.optimizer.SGD(0.1))
    assert capture_refusal(plain) is None
    exe = pt.Executor(CPU)
    with pt.scope_guard(pt.Scope()):
        exe.run(ts)
        with pytest.raises(ValueError, match="dpsgd"):
            exe.run_fused(tm, feeds=[_feeds()] * 2, fetch_list=[tl])
        a = exe.run(tm, feed=_feeds(), fetch_list=[tl])[0]
        assert np.isfinite(a).all()


def test_a_jax_saved_lamb_state_resumes_in_the_port(tmp_path):
    """Two LAMB steps in the JAX package, its persistables saved with
    ``save_persistables`` (moments, beta powers, learning rate under the
    same ``unique_name`` names), loaded by the port, and a third step in
    each package: the same loss and state."""
    make = lambda pkg: _factories(pkg)["lamb_excluding"]()
    jm, js, jl, _ = _mlp(fluid, make)
    tm, _, tl, _ = _mlp(pt, make)
    feeds = _feeds()
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    assert any(n.endswith("_moment2_0") for n in names)
    exe = fluid.Executor()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        for _ in range(2):
            exe.run(jm, feed=feeds, fetch_list=[jl])
        fluid.io.save_persistables(exe, str(tmp_path), jm)
        jloss = float(exe.run(jm, feed=feeds, fetch_list=[jl])[0][0])
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    with pt.scope_guard(tscope):
        texe = pt.Executor(CPU)
        pt.io.load_persistables(texe, str(tmp_path), tm)
        assert sorted(tscope.var_names()) == names
        tloss = float(texe.run(tm, feed=feeds, fetch_list=[tl])[0][0])
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=5e-5, err_msg=n)


# ------------------------------------------------------------------ initializers, ops

@pytest.mark.parametrize("name", ["TruncatedNormal", "MSRA", "MSRA_normal", "NumpyArray",
                                  "Bilinear"])
def test_initializer_matches_jax(name):
    """The startup op each initializer appends (type and attrs) equals the
    JAX package's; the values the port draws hold the distribution (the
    generators differ) or equal the JAX package's (the constants)."""
    shape = [8, 4, 3, 3] if name in ("Bilinear", "MSRA", "MSRA_normal") else [64, 80]

    def build(pkg):
        init = pkg.initializer
        make = {"TruncatedNormal": lambda: init.TruncatedNormal(0.5, 2.0, seed=3),
                "MSRA": lambda: init.MSRA(seed=3),
                "MSRA_normal": lambda: init.MSRAInitializer(uniform=False, seed=3),
                "NumpyArray": lambda: init.NumpyArrayInitializer(
                    np.arange(64 * 80, dtype="float32").reshape(64, 80) / 7.0),
                "Bilinear": lambda: init.Bilinear()}[name]
        main, startup = pkg.Program(), pkg.Program()
        startup.random_seed = 1
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            w = pkg.layers.create_parameter(shape, "float32", name="w",
                                            default_initializer=make())
        return startup, w

    js, _ = build(fluid)
    ts, _ = build(pt)
    jops, tops = js.global_block().ops, ts.global_block().ops
    assert [(o.type, o.attrs) for o in tops] == [(o.type, o.attrs) for o in jops]
    exe = pt.Executor(CPU)
    with pt.scope_guard(pt.Scope()):
        exe.run(ts)
        got = pt.global_scope().find_var("w").numpy()
    jexe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        jexe.run(js)
        want = np.asarray(fluid.global_scope().find_var("w"))
    assert got.shape == want.shape == tuple(shape)
    if name in ("NumpyArray", "Bilinear"):
        np.testing.assert_array_equal(got, want)
    elif name == "TruncatedNormal":
        z = (got.astype(np.float64) - 0.5) / 2.0
        assert np.abs(z).max() <= 2.0 + 1e-6 and abs(z.mean()) < 0.1
    else:
        fan_in = 4 * 3 * 3
        if name == "MSRA":
            limit = np.sqrt(6.0 / fan_in)
            assert np.abs(got).max() <= limit and np.abs(got).max() > 0.9 * limit
        else:
            assert abs(got.std() / np.sqrt(2.0 / fan_in) - 1) < 0.15
    assert pt.initializer.force_init_on_cpu() is False
    with pt.initializer.init_on_cpu():
        pass


def test_prepend_and_remove_op():
    """``Block.prepend_op`` puts the op first (after its shape inference) and
    ``remove_op`` deletes by index, each bumping the program's version, as
    the JAX package's."""
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.data("x", [3], "float32")
            pkg.layers.scale(x, 2.0)
        blk = main.global_block()
        v0 = main._version
        op = blk.prepend_op("scale", inputs={"X": [x.name]}, outputs={"Out": ["y0"]},
                            attrs={"scale": 3.0})
        assert blk.ops[0] is op and [o.type for o in blk.ops] == ["scale", "scale"]
        assert tuple(blk.var("y0").shape) == tuple(x.shape)
        blk.remove_op(0)
        assert [o.attr("scale") for o in blk.ops] == [2.0]
        assert main._version > v0


def test_ftrl_divides_zero_by_zero_as_the_reference_does():
    """The reference's Ftrl (``paddle_tpu/ops/optimizer_ops.py``) gives NaN
    where a gradient element and its squared accumulator are both 0 and l2
    is 0 (0 / 0; Paddle's own kernel writes 0 there): the port keeps the
    reference's arithmetic (ROADMAP fault 3.9), and l2 > 0 avoids it."""
    ins = {"Param": [np.ones(3, "float32")], "Grad": [np.array([0.0, 1.0, -1.0], "float32")],
           "SquaredAccumulator": [np.zeros(3, "float32")],
           "LinearAccumulator": [np.zeros(3, "float32")], "LearningRate": [np.array([0.1], "float32")]}
    for attrs in ({}, {"l2": 1e-4}):
        j = np.asarray(jreg.get("ftrl").lower(jreg.LowerCtx(dict(attrs)), {
            k: [jnp.asarray(a) for a in v] for k, v in ins.items()})["ParamOut"][0])
        t = treg.get("ftrl").lower(treg.LowerCtx(dict(attrs)), {
            k: [torch.from_numpy(a) for a in v] for k, v in ins.items()})["ParamOut"][0].numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, equal_nan=True)
        assert np.isnan(t[0]) == (not attrs)
