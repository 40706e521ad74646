"""The learning-rate schedules and the Variable arithmetic they are built
with, against the JAX package.

Each of the eight schedules of ``layers/learning_rate_scheduler.py``, alone
and nested, drives a tiny model's ``SGD`` in both packages from the same
weights: the learning rate fetched at each of 6 steps of ``Executor.run``,
and over two ``run_fused(K=3)`` calls through the CPU stand-in graph of
``tests/test_torch_graph_step.py``, equals the JAX package's, and so does
the step counter ``@LR_DECAY_COUNTER@`` (JAX runs with x64 off, so its
counter is int32: values are compared). A nested schedule advances the
counter once per schedule a run, in both packages (the JAX package's
behaviour, ROADMAP fault 3.8). The learning rates are f32 values computed
by the same op sequence: ``rtol 1e-6`` (a few f32 roundings; ``pow`` and
``exp`` may round one ulp apart).
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from tests import test_torch_graph_step as tg
from tests import test_torch_training as tt
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.models import bert as tbert

LR_TOL = dict(rtol=1e-6, atol=0.0)
COUNTER = "@LR_DECAY_COUNTER@"

SCHEDULES = {
    "noam": lambda L: L.noam_decay(16, 4),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential-staircase": lambda L: L.exponential_decay(0.1, 2, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 2, 0.3),
    "inverse_time-staircase": lambda L: L.inverse_time_decay(0.1, 2, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 4, 0.01, power=2.0),
    "polynomial-cycle": lambda L: L.polynomial_decay(0.1, 2, 0.01, power=1.0, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 4], [0.1, 0.05, 0.01]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 4),
    "linear_warmup": lambda L: L.linear_lr_warmup(0.1, 3, 0.0, 0.1),
    # the probe of ROADMAP fault 3.8: the counter reads 2, 4, 6 and the LR 0.2, 0.4, 0.6
    "warmup-over-polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(1.0, 100, 0.0), 10, 0.0, 1.0),
    "warmup-over-noam": lambda L: L.linear_lr_warmup(L.noam_decay(16, 2), 4, 0.0, 0.05),
}


def _build(pkg, schedule):
    """A tiny regression (fc 4 -> 1, mean square error) under ``SGD`` with
    the schedule's learning rate. Returns (main, startup, loss, lr)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [4], "float32")
        y = pkg.data("y", [1], "float32")
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pkg.layers.fc(x, 1), y))
        lr = schedule(pkg.layers)
        pkg.optimizer.SGD(lr).minimize(loss)
    return main, startup, loss, lr


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 4).astype("float32"), "y": rng.randn(8, 1).astype("float32")}


def _jax_run(schedule, steps=6, fused=None, state=None):
    """(lr per step, counter per step, final numpy state) in the JAX package."""
    main, startup, loss, lr = _build(fluid, schedule)
    exe = fluid.Executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for n, a in (state or {}).items():
            scope.set_var(n, a)
        if fused:
            outs = [exe.run_fused(main, feeds=[_feed()] * fused, fetch_list=[lr, COUNTER],
                                  return_numpy=True) for _ in range(steps // fused)]
            lrs = np.concatenate([o[0].reshape(-1) for o in outs])
            cs = np.concatenate([o[1].reshape(-1) for o in outs])
        else:
            outs = [exe.run(main, feed=_feed(), fetch_list=[lr, COUNTER]) for _ in range(steps)]
            lrs = np.array([float(o[0].reshape(-1)[0]) for o in outs])
            cs = np.array([int(o[1].reshape(-1)[0]) for o in outs])
        final = {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
                 if v.persistable and scope.find_var(n) is not None}
    return lrs, cs, final, main


def _port_run(schedule, jax_state, steps=6, fused=None, exe=None):
    """The same in the port, from the JAX package's startup state."""
    main, startup, loss, lr = _build(pt, schedule)
    exe = exe or pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(jax_state, "cpu"))
    with pt.scope_guard(scope):
        if fused:
            outs = [exe.run_fused(main, feeds=[_feed()] * fused, fetch_list=[lr, COUNTER],
                                  return_numpy=True) for _ in range(steps // fused)]
            lrs = np.concatenate([o[0].reshape(-1) for o in outs])
            cs = np.concatenate([o[1].reshape(-1) for o in outs])
        else:
            outs = [exe.run(main, feed=_feed(), fetch_list=[lr, COUNTER]) for _ in range(steps)]
            lrs = np.array([float(o[0].reshape(-1)[0]) for o in outs])
            cs = np.array([int(o[1].reshape(-1)[0]) for o in outs])
    return lrs, cs, scope, main


def _startup_state(schedule):
    main, startup, _, _ = _build(fluid, schedule)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor().run(startup)
        return {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_over_run(name):
    init = _startup_state(SCHEDULES[name])
    jl, jc, jfinal, jmain = _jax_run(SCHEDULES[name], state=init)
    tl, tc, scope, tmain = _port_run(SCHEDULES[name], init)
    np.testing.assert_allclose(tl, jl, **LR_TOL)
    assert tc.tolist() == jc.tolist()
    per_run = sum(op.type == "increment" for op in tmain.global_block().ops)
    assert tc.tolist() == [per_run * (i + 1) for i in range(6)]
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    np.testing.assert_allclose(scope.find_var("fc_0.w_0").numpy(), jfinal["fc_0.w_0"],
                               rtol=1e-5, atol=1e-6)


def test_nested_schedule_advances_the_counter_per_schedule():
    """ROADMAP fault 3.8, kept as the JAX package has it: two schedules, two
    increments a run; warmup 10 over a counter of 2, 4, 6 reads 0.2, 0.4,
    0.6."""
    init = _startup_state(SCHEDULES["warmup-over-polynomial"])
    tl, tc, _, _ = _port_run(SCHEDULES["warmup-over-polynomial"], init, steps=3)
    assert tc.tolist() == [2, 4, 6]
    np.testing.assert_allclose(tl, [0.2, 0.4, 0.6], rtol=1e-6)


@pytest.mark.parametrize("name", ["noam", "piecewise", "warmup-over-polynomial", "cosine"])
def test_schedule_matches_jax_run_fused_through_the_captured_step(name, stand_in):
    """Two ``run_fused(K=3)`` calls through the executor's cache of graphs
    (the CPU stand-in): the counter advances inside each replay and is
    copied back to the scope's tensor; LR and counter equal the JAX
    package's ``run_fused``."""
    init = _startup_state(SCHEDULES[name])
    jl, jc, _, _ = _jax_run(SCHEDULES[name], fused=3, state=init)
    exe = pt.Executor(pt.CPUPlace())
    tl, tc, scope, main = _port_run(SCHEDULES[name], init, fused=3, exe=exe)
    np.testing.assert_allclose(tl, jl, **LR_TOL)
    assert tc.tolist() == jc.tolist()
    assert stand_in.captures == 1
    step, = exe._cache.values()
    assert scope.find_var(COUNTER) is step.state[COUNTER]
    assert int(step.state[COUNTER].item()) == jc[-1]


def test_captured_replays_equal_eager_runs(stand_in):
    """Six steps through the cache (warm-up, capture, replays) against six
    eager steps: LR, counter and weights bit for bit."""
    init = _startup_state(SCHEDULES["warmup-over-noam"])
    g = _port_run(SCHEDULES["warmup-over-noam"], init)
    exe = pt.Executor(pt.CPUPlace())
    exe._use_graphs = False
    e = _port_run(SCHEDULES["warmup-over-noam"], init, exe=exe)
    assert g[0].tolist() == e[0].tolist() and g[1].tolist() == e[1].tolist()
    assert torch.equal(g[2].find_var("fc_0.w_0"), e[2].find_var("fc_0.w_0"))


def _save_resume(tmp_path, name, saver):
    """3 steps, a save, a fresh scope loaded from it, 3 more steps: the LRs
    of the resumed steps against the JAX package's unbroken 6."""
    init = _startup_state(SCHEDULES[name])
    jl, jc, _, _ = _jax_run(SCHEDULES[name], state=init)
    d = str(tmp_path / "ckpt")
    saver(d, init)
    main, startup, loss, lr = _build(pt, SCHEDULES[name])
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe.run(startup)
        pt.io.load_persistables(exe, d, main)
        assert scope.find_var(COUNTER).dtype == torch.int64   # the program's width
        outs = [exe.run(main, feed=_feed(), fetch_list=[lr, COUNTER]) for _ in range(3)]
    np.testing.assert_allclose([float(o[0][0]) for o in outs], jl[3:], **LR_TOL)
    assert [int(o[1][0]) for o in outs] == jc[3:].tolist()


def test_resume_mid_warmup_from_the_ports_save(tmp_path):
    def saver(d, init):
        main, startup, loss, lr = _build(pt, SCHEDULES["warmup-over-polynomial"])
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            for _ in range(3):
                exe.run(main, feed=_feed(), fetch_list=[lr])
            pt.io.save_persistables(exe, d, main)
        assert np.load(os.path.join(d, COUNTER + ".npy")).tolist() == [6]
    _save_resume(tmp_path, "warmup-over-polynomial", saver)


def test_resume_mid_warmup_from_the_jax_packages_save(tmp_path):
    """The JAX package saves its counter as int32 (x64 off); the port's load
    widens it to the program's int64 and resumes at the same LR."""
    def saver(d, init):
        main, startup, loss, lr = _build(fluid, SCHEDULES["warmup-over-polynomial"])
        exe = fluid.Executor()
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            for n, a in init.items():
                scope.set_var(n, a)
            for _ in range(3):
                exe.run(main, feed=_feed(), fetch_list=[lr])
            fluid.io.save_persistables(exe, d, main)
    _save_resume(tmp_path, "warmup-over-polynomial", saver)


def test_a_jax_counter_carries_through_convert():
    """``convert.state_from_numpy`` of the JAX scope after 3 steps (its
    int32 counter among them): the port's next 3 steps give the JAX
    package's LRs."""
    sched = SCHEDULES["warmup-over-noam"]
    init = _startup_state(sched)
    jl, jc, _, _ = _jax_run(sched, state=init)
    _, _, mid, _ = _jax_run(sched, steps=3, state=init)
    assert mid[COUNTER].dtype == np.int32 and int(mid[COUNTER][0]) == 6
    tl, tc, _, _ = _port_run(sched, mid, steps=3)
    np.testing.assert_allclose(tl, jl[3:], **LR_TOL)
    assert tc.tolist() == jc[3:].tolist()


def test_tiny_bert_under_berts_nested_schedule_matches_jax():
    """BERT's recipe (warmup over linear decay, as chip_smoke.py's phase 17
    runs it at full size) on the tiny BERT of ``tests/test_torch_training.py``,
    with the counter preset so that the 6 steps cross the warmup's end:
    the LR, the counter and the loss of every step equal the JAX package's
    (losses at the training tests' ``rtol 1e-5``)."""
    def recipe(L):
        return L.linear_lr_warmup(L.polynomial_decay(1e-3, 100, 0.0, 1.0), 10, 0.0, 1e-3)

    got = {}
    for key, pkg, bert in (("jax", fluid, jbert), ("port", pt, tbert)):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 1
        cfg = bert.BertConfig(vocab_size=tt.VOCAB, hidden=64, n_layers=2, n_heads=2,
                              max_seq_len=tt.S, dropout=0.0)
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            ins = [pkg.data(n, [tt.S], t) for n, t in (
                ("src_ids", "int64"), ("pos_ids", "int64"), ("sent_ids", "int64"),
                ("input_mask", "float32"))]
            ins += [pkg.data(n, [1], "int64") for n in ("mask_pos", "mask_label", "nsp_label")]
            total, _, _ = bert.pretrain(*ins, cfg)
            lr = recipe(pkg.layers)
            pkg.optimizer.Adam(lr).minimize(total)
        got[key] = (main, startup, total, lr)
    jmain, jstartup, jtotal, jlr = got["jax"]
    scope = fluid.Scope()
    jexe = fluid.Executor()
    with fluid.scope_guard(scope):
        jexe.run(jstartup)
        scope.set_var(COUNTER, np.array([4], np.int32))    # steps read 6, 8, 10, 12, ...
        init = {n: np.asarray(scope.find_var(n)) for n, v in jmain.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}
        jouts = [jexe.run(jmain, feed=tt._feeds(), fetch_list=[jtotal, jlr, COUNTER])
                 for _ in range(6)]
    tmain, _, ttotal, tlr = got["port"]
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, "cpu"))
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(tscope):
        touts = [exe.run(tmain, feed=tt._feeds(), fetch_list=[ttotal, tlr, COUNTER])
                 for _ in range(6)]
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t[1], j[1], **LR_TOL)
        assert int(t[2][0]) == int(j[2][0])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    assert [int(t[2][0]) for t in touts] == [6, 8, 10, 12, 14, 16]
    # the warmup's last steps, then linear decay from the inner schedule's count
    assert float(touts[1][1][0]) == pytest.approx(8e-4, rel=1e-6)
    assert float(touts[3][1][0]) == pytest.approx(1e-3 * (1 - 11 / 100), rel=1e-6)


# ------------------------------------------------------------------ the sugar


def _sugar_program(pkg):
    main = pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
        x = pkg.data("x", [4, 5], "float32", append_batch_size=False)
        y = pkg.data("y", [4, 5], "float32", append_batch_size=False)
        outs = [x + 1, x < 2.0, -x, x[1:3], x[2], 2.0 - x, x * y, x / 4, 3 / x, x ** 2.0,
                x >= y, x == y, x != 1.5, x[:, 1:]]
    return main, outs


def test_sugar_builds_the_jax_packages_ops():
    """``var + 1``, ``var < 2.0``, ``-var``, ``var[1:3]`` and the rest build
    the same ops (types, slots, attrs, output dtypes and shapes) as in the
    JAX package."""
    (jm, jouts), (tm, touts) = _sugar_program(fluid), _sugar_program(pt)
    assert [op.to_dict() for op in tm.global_block().ops] == \
        [op.to_dict() for op in jm.global_block().ops]
    for j, t in zip(jouts, touts):
        assert (t.name, t.dtype, t.shape) == (j.name, j.dtype, j.shape)


def test_variable_hash_is_identity_and_eq_builds_an_op():
    main, _ = _sugar_program(pt)
    with pt.program_guard(main, pt.Program()):
        v = main.global_block().var("x")
        n_ops = len(main.global_block().ops)
        eq = v == v
        assert isinstance(eq, pt.Variable) and eq.dtype == "bool"
        assert len(main.global_block().ops) == n_ops + 1
        assert hash(v) == id(v) and {v: 1}[v] == 1
        assert (v == "x") is False                     # not a Variable or a number


def test_counter_layers_match_jax():
    """``layers.autoincreased_step_counter`` (begin 1) and ``layers.increment``
    in place: the values of three runs in both packages."""
    got = {}
    for key, pkg in (("jax", fluid), ("port", pt)):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            c = pkg.layers.autoincreased_step_counter(begin=1, step=2)
            g = pkg.layers.create_global_var([1], 5.0, "float32", persistable=True, name="g")
            pkg.layers.increment(g, value=0.5)
        exe = pkg.Executor() if pkg is fluid else pkg.Executor(pkg.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            got[key] = [[float(np.asarray(a).reshape(-1)[0]) for a in
                         exe.run(main, fetch_list=[c, g])] for _ in range(3)]
    assert got["port"] == got["jax"] == [[1.0, 5.5], [3.0, 6.0], [5.0, 6.5]]


stand_in = tg.stand_in


@pytest.mark.parametrize("which", ["bert", "noam"])
def test_the_card_schedules_and_their_closed_forms_match_jax(which):
    """The two schedules ``chip_smoke.py``'s phase 17 trains under
    (``train_profile.bert_schedule``, ``noam_schedule``) from its preset
    counters, 4 steps: the JAX package's learning rate and counter, and the
    float64 closed forms it holds the card to (``bert_schedule_lr``,
    ``noam_schedule_lr``), within ``rtol 1e-6``."""
    from paddle_tpu_torch.tools import train_profile as tp
    sched, closed, c0, per_run = {
        "bert": (tp.bert_schedule, tp.bert_schedule_lr, 9994, 2),
        "noam": (tp.noam_schedule, tp.noam_schedule_lr, 3997, 1)}[which]
    init = _startup_state(sched)
    init[COUNTER] = np.array([c0], np.int32)
    jl, jc, _, _ = _jax_run(sched, steps=4, state=init)
    tl, tc, _, _ = _port_run(sched, init, steps=4)
    np.testing.assert_allclose(tl, jl, **LR_TOL)
    assert tc.tolist() == jc.tolist() == [c0 + per_run * (i + 1) for i in range(4)]
    np.testing.assert_allclose(tl, [closed(c0 + per_run * i) for i in range(4)], rtol=1e-6)
