"""The port's control flow (``ops/control_flow.py``: ``while``,
``conditional_block``, ``array_write``, ``array_read``, ``is_empty``,
``print``, ``assert``; ``layers/control_flow.py``: ``While``, ``Switch``,
``IfElse``, ``DynamicRNN``, the TensorArray layers, ``Print``,
``StaticRNN``) against the JAX package on the CPU.

Each program of ``tests/test_control_flow_dsl.py`` is built by both
packages' DSLs (the same ops, slots and attrs in every block), run from the
JAX startup state carried across by name, and its fetches compared:
``rtol 1e-5, atol 1e-6`` (f32 sums in other orders; a few Adam steps of a
loop that trains a parameter in its body stay within it). The errors the
JAX DSL raises are raised by the port's too. Then the port's own: the two
``while`` lowerings agree, a gradient through a ``while`` without
``max_iters`` is refused as in the JAX package, ``capture_refusal`` names
a ``while`` without ``max_iters`` and a ``print``, and a bounded ``while``,
``IfElse``, ``Switch`` and ``DynamicRNN`` run through the executor's
captured step (``tests/test_torch_graph_step.py``'s CPU stand-in for a
CUDA graph) bit for bit to the eager run.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor import capture_refusal
from tests.test_torch_graph_step import stand_in  # noqa: F401  (fixture)

TOL = dict(rtol=1e-5, atol=1e-6)
XV = np.array([[1.0, 2.0, 0.5, 3.0]], "float32")


def _counted_while(L, pkg, max_iters=None, grad=False, limit=3.0):
    x = pkg.data("x", [4], "float32")
    x.stop_gradient = not grad
    i = L.fill_constant([1], "float32", 0)
    lim = L.fill_constant([1], "float32", limit)
    acc = L.fill_constant_batch_size_like(x, [-1, 4], "float32", 1.0)
    cond = L.less_than(i, lim)
    w = L.While(cond, max_iters=max_iters)
    with w.block():
        L.assign(L.elementwise_mul(acc, x), acc)
        L.increment(i, in_place=True)
        L.less_than(i, lim, cond=cond)
    if not grad:
        return [acc, i], {"x": XV}
    loss = L.reduce_sum(acc)
    return [loss, pkg.gradients(loss, [x])[0]], {"x": XV}


def _array_in_while(L, pkg):
    x = pkg.data("x", [4], "float32")
    x.stop_gradient = False
    arr = L.create_array("float32", capacity=4)
    i = L.fill_constant([1], "float32", 0)
    lim = L.fill_constant([1], "float32", 3)
    acc = L.fill_constant_batch_size_like(x, [-1, 4], "float32", 0.0)
    cond = L.less_than(i, lim)
    w = L.While(cond, max_iters=4)
    with w.block():
        L.assign(L.elementwise_add(acc, x), acc)
        L.array_write(acc, i, array=arr)
        L.increment(i, in_place=True)
        L.less_than(i, lim, cond=cond)
    last = L.array_read(arr, L.fill_constant([1], "int32", 2))
    loss = L.reduce_sum(last)
    whole, sizes = L.tensor_array_to_tensor(arr, axis=1)
    return [last, L.array_length(arr), pkg.gradients(loss, [x])[0], whole, sizes], {"x": XV}


def _switch(L, pkg, s=3.0, default=True):
    sv = L.reshape(L.reduce_mean(pkg.data("s", [1], "float32")), [1])
    lr = L.fill_constant([1], "float32", 0.7)
    c1 = L.less_than(sv, L.fill_constant([1], "float32", 5.0))
    c2 = L.less_than(sv, L.fill_constant([1], "float32", 8.0))
    with L.Switch() as switch:
        with switch.case(c1):
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        with switch.case(c2):
            L.assign(L.fill_constant([1], "float32", 0.2), lr)
        if default:
            with switch.default():
                L.assign(L.fill_constant([1], "float32", 0.3), lr)
    return [lr], {"s": np.full((1, 1), s, "float32")}


def _ifelse(L, pkg):
    x = pkg.data("x", [3], "float32")
    x.stop_gradient = False
    m = pkg.data("m", [1], "float32")
    ie = L.IfElse(L.cast(m, "bool"))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), 1.0, bias=1.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), 2.0))
    out, = ie()
    loss = L.reduce_sum(out)
    return [out, pkg.gradients(loss, [x])[0]], {
        "x": np.arange(12, dtype="float32").reshape(4, 3),
        "m": np.array([[1.0], [0.0], [1.0], [0.0]], "float32")}


def _dynamic_rnn(L, pkg):
    x = pkg.data("x", [5, 4], "float32")
    lens = pkg.data("lens", [1], "int64")
    drnn = L.DynamicRNN()
    with drnn.block():
        w = drnn.step_input(x, lengths=lens)
        prev = drnn.memory(shape=[4], value=0.0)
        h = L.elementwise_add(w, prev)
        drnn.update_memory(prev, h)
        drnn.output(h)
    return [drnn()], {"x": np.random.RandomState(0).randn(3, 5, 4).astype("float32"),
                      "lens": np.array([[2], [5], [3]], "int64")}


def _switch_in_while(L, pkg):
    i = L.fill_constant([1], "float32", 0)
    lim = L.fill_constant([1], "float32", 4)
    acc = L.fill_constant([1], "float32", 0.0)
    cond = L.less_than(i, lim)
    w = L.While(cond)
    with w.block():
        c1 = L.less_than(i, L.fill_constant([1], "float32", 2))
        c2 = L.less_than(i, L.fill_constant([1], "float32", 3))
        with L.Switch() as switch:
            for c, v in ((c1, 1.0), (c2, 10.0), (None, 100.0)):
                with (switch.case(c) if c is not None else switch.default()):
                    L.assign(L.elementwise_add(acc, L.fill_constant([1], "float32", v)), acc)
        L.increment(i, in_place=True)
        L.less_than(i, lim, cond=cond)
    return [acc], {}


def _needs_like(L, pkg):
    x = pkg.data("x", [4], "float32")
    arr = L.create_array("float32", capacity=3, like=x)
    i = L.fill_constant([1], "float32", 0)
    lim = L.fill_constant([1], "float32", 3)
    cond = L.less_than(i, lim)
    w = L.While(cond, max_iters=3)
    with w.block():
        L.array_write(L.elementwise_add(x, x), i, array=arr)
        L.increment(i, in_place=True)
        L.less_than(i, lim, cond=cond)
    return [L.array_read(arr, L.fill_constant([1], "int32", 1))], {
        "x": np.ones((2, 4), "float32")}


def _is_empty_and_print(L, pkg):
    x = pkg.data("x", [4], "float32")
    return [L.is_empty(x), L.Print(L.scale(x, 3.0), message="x3: ")], {"x": XV}


def _trains_in_body(L, pkg):
    x = pkg.data("x", [8], "float32")
    target = pkg.data("target", [8], "float32")
    h = L.fill_constant_batch_size_like(x, [-1, 8], "float32", 0.0)
    i = L.fill_constant([1], "float32", 0)
    lim = L.fill_constant([1], "float32", 3)
    cond = L.less_than(i, lim)
    w = L.While(cond, max_iters=3)
    with w.block():
        step = L.fc(L.elementwise_add(h, x), 8, act="tanh",
                    param_attr=pkg.ParamAttr(name="loop_w"))
        L.assign(step, h)
        L.increment(i, in_place=True)
        L.less_than(i, lim, cond=cond)
    loss = L.reduce_mean(L.square(L.elementwise_sub(h, target)))
    pkg.optimizer.Adam(0.05).minimize(loss)
    rng = np.random.RandomState(1)
    return [loss], {"x": rng.randn(4, 8).astype("float32"),
                    "target": rng.randn(4, 8).astype("float32") * 0.1}


def _drnn_trains(L, pkg):
    x = pkg.data("x", [4, 6], "float32")
    lens = pkg.data("lens", [1], "int64")
    target = pkg.data("target", [8], "float32")
    drnn = L.DynamicRNN()
    with drnn.block():
        w = drnn.step_input(x, lengths=lens)
        prev = drnn.memory(shape=[8], value=0.0)
        h = L.fc(L.concat([w, prev], axis=1), 8, act="tanh",
                 param_attr=pkg.ParamAttr(name="drnn_w"))
        drnn.update_memory(prev, h)
        drnn.output(h)
    out = drnn()
    loss = L.reduce_mean(L.square(L.elementwise_sub(out[:, 3], target)))
    pkg.optimizer.Adam(0.05).minimize(loss)
    rng = np.random.RandomState(3)
    return [loss], {"x": rng.randn(5, 4, 6).astype("float32"),
                    "lens": np.array([[4], [2], [3], [4], [1]], "int64"),
                    "target": (rng.randn(5, 8) * 0.1).astype("float32")}


#: name -> (builder(layers, package) -> (fetches, feed), steps)
PROGRAMS = {
    "while-forward": (lambda L, p: _counted_while(L, p), 1),
    "while-max_iters-grad": (lambda L, p: _counted_while(L, p, max_iters=5, grad=True), 1),
    "while-tensor_array": (_array_in_while, 1),
    "switch-first-case": (lambda L, p: _switch(L, p, 3.0), 1),
    "switch-second-case": (lambda L, p: _switch(L, p, 6.0), 1),
    "switch-default": (lambda L, p: _switch(L, p, 9.0), 1),
    "switch-no-match-keeps-value": (lambda L, p: _switch(L, p, 9.0, default=False), 1),
    "ifelse-rowwise-grad": (_ifelse, 1),
    "dynamic_rnn-masked": (_dynamic_rnn, 1),
    "switch-inside-while": (_switch_in_while, 1),
    "tensor_array-like": (_needs_like, 1),
    "is_empty-print": (_is_empty_and_print, 1),
    "while-trains-param-in-body": (_trains_in_body, 4),
    "dynamic_rnn-trains-body-param": (_drnn_trains, 4),
}


def _build(pkg, builder):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 9
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        fetches, feed = builder(pkg.layers, pkg)
    return main, startup, fetches, feed


def _run_jax(main, startup, fetches, feed, steps):
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        state = {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
                 if v.persistable and scope.find_var(n) is not None}
        outs = [[np.asarray(o) for o in exe.run(main, feed=feed, fetch_list=fetches)]
                for _ in range(steps)]
    return state, outs


def _run_port(main, fetches, feed, steps, state, exe=None):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy({k: v.copy() for k, v in state.items()},
                                                       device="cpu"))
    exe = exe or pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        return [[np.asarray(o) for o in exe.run(main, feed=feed, fetch_list=fetches)]
                for _ in range(steps)]


def _ops(program):
    return [b["ops"] for b in program.to_dict()["blocks"]]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_builds_and_runs_as_jax(name):
    builder, steps = PROGRAMS[name]
    jm, js, jf, feed = _build(fluid, builder)
    tm, ts, tf, _ = _build(pt, builder)
    assert _ops(tm) == _ops(jm) and _ops(ts) == _ops(js)
    state, jouts = _run_jax(jm, js, jf, feed, steps)
    touts = _run_port(tm, tf, feed, steps, state)
    for k, (j, t) in enumerate(zip(jouts, touts)):
        for i, (a, b) in enumerate(zip(j, t)):
            assert b.shape == a.shape, (name, k, i)
            if a.dtype.kind in "biu":
                np.testing.assert_array_equal(b, a.astype(b.dtype), err_msg=f"{name} {k} {i}")
            else:
                np.testing.assert_allclose(b, a, err_msg=f"{name} step {k} fetch {i}", **TOL)
    if steps > 1:
        assert touts[-1][0] < touts[0][0], (name, [t[0] for t in touts])


def test_print_prints_at_every_run(capsys):
    tm, _, tf, feed = _build(pt, _is_empty_and_print)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        for _ in range(2):
            exe.run(tm, feed=feed, fetch_list=tf)
    assert capsys.readouterr().out.count("x3: [[3.  6.  1.5 9. ]]") == 2


# --------------------------------------------------------------------- the refusals

def _raises_in_both(build, err, match):
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pytest.raises(err, match=match):
            with pkg.unique_name.guard(), pkg.program_guard(main, startup):
                build(pkg.layers, pkg)


def test_while_requires_cond_rewrite_in_both():
    def build(L, pkg):
        i = L.fill_constant([1], "float32", 0)
        w = L.While(L.less_than(i, L.fill_constant([1], "float32", 3)))
        with w.block():
            L.increment(i, in_place=True)
    _raises_in_both(build, ValueError, "rewrites the condition")


def test_create_array_requires_capacity_in_both():
    def build(L, pkg):
        L.array_write(pkg.data("x", [4], "float32"), L.fill_constant([1], "int32", 0),
                      array=L.create_array("float32"))
    _raises_in_both(build, ValueError, "capacity")


def test_a_body_value_needs_like_in_both():
    def build(L, pkg):
        x = pkg.data("x", [4], "float32")
        arr = L.create_array("float32", capacity=3)
        i = L.fill_constant([1], "float32", 0)
        cond = L.less_than(i, L.fill_constant([1], "float32", 3))
        w = L.While(cond, max_iters=3)
        with w.block():
            L.array_write(L.elementwise_add(x, x), i, array=arr)
            L.increment(i, in_place=True)
            L.less_than(i, L.fill_constant([1], "float32", 3), cond=cond)
    _raises_in_both(build, ValueError, "like")


def test_a_persistable_written_in_a_sub_block_must_escape_in_both():
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [4], "float32")
            p = main.global_block().create_var("trap_p", (1,), "float32")
            p.persistable = True
            sub = main._create_block()
            sub.append_op("fill_constant", outputs={"Out": ["trap_p"]},
                          attrs={"shape": [1], "value": 1.0, "dtype": "float32"},
                          infer_shape=False)
            main._rollback()
            c = pkg.layers.fill_constant([1], "bool", 1)
            main.global_block().append_op(
                "conditional_block", inputs={"Cond": [c.name], "X": []}, outputs={"Out": []},
                attrs={"sub_block": sub.idx, "x_names": [], "out_names": []},
                infer_shape=False)
            y = pkg.layers.scale(x, 2.0)
        exe = fluid.Executor() if pkg is fluid else pt.Executor(pt.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            with pytest.raises(RuntimeError, match="persistable.*sub-block"):
                exe.run(main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[y])


def test_a_gradient_through_an_unbounded_while_is_refused_in_both():
    for pkg in (fluid, pt):
        main, startup, fetches, feed = _build(pkg, lambda L, p: _counted_while(L, p, grad=True))
        exe = fluid.Executor() if pkg is fluid else pt.Executor(pt.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            with pytest.raises(Exception, match="max_iters"):
                exe.run(main, feed=feed, fetch_list=fetches)


def test_the_two_while_lowerings_agree():
    """The masked loop (max_iters 5, 3 live runs) and the host-read loop give
    the same values, bit for bit."""
    outs = []
    for max_iters in (None, 5):
        tm, _, tf, feed = _build(pt, lambda L, p: _counted_while(L, p, max_iters=max_iters))
        with pt.scope_guard(pt.Scope()):
            outs.append(pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=tf))
    for a, b in zip(*outs):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    np.testing.assert_array_equal(outs[0][0], XV ** 3)


def test_capture_refusal_names_an_unbounded_while_and_a_print():
    refused = {"while-forward": "'while' has no max_iters",
               "switch-inside-while": "'while' has no max_iters",
               "is_empty-print": "'print' prints on the host"}
    for name, (builder, _) in sorted(PROGRAMS.items()):
        tm, _, _, _ = _build(pt, builder)
        why = capture_refusal(tm)
        if name in refused:
            assert why is not None and refused[name] in why, (name, why)
        else:
            assert why is None, (name, why)


@pytest.mark.parametrize("name", ["while-max_iters-grad", "while-tensor_array",
                                  "ifelse-rowwise-grad", "switch-second-case",
                                  "dynamic_rnn-trains-body-param",
                                  "while-trains-param-in-body", "while-forward"])
def test_the_captured_step_equals_the_eager_run(name, stand_in):  # noqa: F811
    """Bounded control flow runs through the stand-in graph bit for bit to
    the eager executor; an unbounded ``while`` warns and runs eagerly."""
    builder, steps = PROGRAMS[name]
    tm, ts, tf, feed = _build(pt, builder)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(ts)
    state = {n: scope.find_var(n).numpy() for n, v in tm.global_block().vars.items()
             if v.persistable and scope.find_var(n) is not None}
    eager_exe = pt.Executor(pt.CPUPlace())
    eager_exe._use_graphs = False
    eager = _run_port(tm, tf, feed, steps + 2, state, eager_exe)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        graph = _run_port(tm, tf, feed, steps + 2, state)
    for a, b in zip(eager, graph):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes(), name
    if name == "while-forward":
        assert stand_in.captures == 0
        assert any("'while' has no max_iters" in str(w.message) for w in caught)
    else:
        assert stand_in.captures == 1


# ------------------------------------------------------------------ the array ops

@pytest.mark.parametrize("index", [0, 2, 5, -1])
def test_array_ops_match_jax_and_clamp_the_index(index):
    rng = np.random.RandomState(4)
    arr, x = rng.randn(3, 2, 4).astype("float32"), rng.randn(2, 4).astype("float32")
    ins = {"Array": [arr], "X": [x], "I": [np.array([index], "int32")],
           "ALen": [np.array([1], "int32")]}
    j = jreg.get("array_write").lower(jreg.LowerCtx({}), {s: [jnp.asarray(a) for a in v]
                                                         for s, v in ins.items()})
    t = treg.get("array_write").lower(treg.LowerCtx({}), {s: [torch.from_numpy(a) for a in v]
                                                         for s, v in ins.items()})
    np.testing.assert_array_equal(t["Out"][0].numpy(), np.asarray(j["Out"][0]))
    np.testing.assert_array_equal(t["OutLen"][0].numpy(), np.asarray(j["OutLen"][0]))
    rins = {"Array": [arr], "I": [np.array([index], "int32")]}
    j = jreg.get("array_read").lower(jreg.LowerCtx({}), {s: [jnp.asarray(a) for a in v]
                                                        for s, v in rins.items()})
    t = treg.get("array_read").lower(treg.LowerCtx({}), {s: [torch.from_numpy(a) for a in v]
                                                        for s, v in rins.items()})
    np.testing.assert_array_equal(t["Out"][0].numpy(), np.asarray(j["Out"][0]))


def test_the_control_flow_types_are_registered_with_the_jax_flags():
    for op in ("while", "conditional_block", "array_write", "array_read", "is_empty",
               "print", "assert"):
        t, j = treg.get(op), jreg.get(op)
        assert (t.grad is None) == (j.grad is None), op
        assert t.nondiff_inputs == j.nondiff_inputs, op
    assert treg.get("assert").lower(treg.LowerCtx({}), {}) == {}
    assert pt.layers.StaticRNN is pt.layers.Scan
    with pytest.raises(NotImplementedError):
        pt.layers.reorder_lod_tensor_by_rank(None, None)
