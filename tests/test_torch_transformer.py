"""The Transformer NMT slice of the port on the CPU: the op lowerings it
adds, its sub-block IR, and three Adam steps of the tiny Transformer of
tests/test_models.py, each held against the JAX package on the same numpy
inputs.

Tolerances. Op lowerings: float32 ``atol 1e-6, rtol 1e-5``, the reductions
``1e-5`` (their sums run in another order); the grads ``atol 1e-5, rtol
1e-5`` (as tests/test_torch_grad.py). Training, 3 steps in float32 with
dropout 0: losses ``rtol 1e-5``, every parameter and optimizer moment ``atol
5e-5``: the two frameworks sum in other orders (about 1e-6 a step), and
Adam's early updates divide by sqrt(v), about |grad|, so a grad's rounding
moves a small parameter's update by up to that much relative to the
learning rate of 1e-2 (as tests/test_torch_training.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import transformer as jtrans
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor import Executor
from paddle_tpu_torch.models import transformer as ttrans

TOL = dict(atol=1e-6, rtol=1e-5)
SUM_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


def _r(*shape, scale=1.0, seed=None):
    seed = sum(shape) if seed is None else seed
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale, "float32")


def _ids(shape, hi, seed=1):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


def _soft_labels(n, v, seed=7):
    p = np.abs(_r(n, v, seed=seed)) + 0.01
    return (p / p.sum(-1, keepdims=True)).astype("float32")


# id -> (op type, inputs, attrs, output slots whose float grads are held, tolerance)
CASES = {
    "elementwise_sub-trailing": ("elementwise_sub", {"X": [_r(2, 3, 4)], "Y": [_r(4)]},
                                 {"axis": -1}, ("Out",), TOL),
    "elementwise_sub-axis1": ("elementwise_sub", {"X": [_r(2, 3, 4)], "Y": [_r(3, 1)]},
                              {"axis": 1}, ("Out",), TOL),
    "elementwise_mul-axis0": ("elementwise_mul", {"X": [_r(4, 1)], "Y": [_r(4)]},
                              {"axis": 0}, ("Out",), TOL),
    "elementwise_mul-scalar-like": ("elementwise_mul", {"X": [_r(3, 5)], "Y": [_r(1)]},
                                    {"axis": -1}, ("Out",), TOL),
    "elementwise_mul-int64": ("elementwise_mul", {"X": [_ids((6, 5), 30)],
                                                  "Y": [np.zeros(1, "int64")]},
                              {"axis": -1}, (), TOL),
    "elementwise_div": ("elementwise_div", {"X": [_r(2, 6)], "Y": [_r(6) + 3.0]},
                        {"axis": -1}, ("Out",), TOL),
    "elementwise_div-0d": ("elementwise_div", {"X": [np.array(7.5, "float32")],
                                               "Y": [np.array(3.0, "float32")]},
                           {"axis": -1}, ("Out",), TOL),
    "elementwise_div-int32": ("elementwise_div", {"X": [_ids((4, 3), 9).astype("int32")],
                                                  "Y": [np.array([2, 4, 5], "int32")]},
                              {"axis": -1}, (), TOL),
    "elementwise_add-int64-rows": ("elementwise_add", {"X": [_ids((5, 7), 3)],
                                                       "Y": [_ids((1, 7), 9, seed=2)]},
                                   {"axis": -1}, (), TOL),
    "reduce_sum-all": ("reduce_sum", {"X": [_r(4, 6, 5)]},
                       {"dim": [0], "keep_dim": False, "reduce_all": True}, ("Out",), SUM_TOL),
    "reduce_sum-all-keep": ("reduce_sum", {"X": [_r(4, 6)]},
                            {"dim": [0], "keep_dim": True, "reduce_all": True}, ("Out",),
                            SUM_TOL),
    "reduce_sum-dims": ("reduce_sum", {"X": [_r(3, 4, 5)]},
                        {"dim": [0, -1], "keep_dim": False, "reduce_all": False}, ("Out",),
                        SUM_TOL),
    "reduce_sum-keep": ("reduce_sum", {"X": [_r(3, 4, 5)]},
                        {"dim": [1], "keep_dim": True, "reduce_all": False}, ("Out",), SUM_TOL),
    "one_hot": ("one_hot", {"X": [_ids((6, 1), 5)]}, {"depth": 5}, (), TOL),
    "one_hot-out-of-range": ("one_hot", {"X": [np.array([[0], [3], [9], [-1]], "int64")]},
                             {"depth": 4}, (), TOL),
    "label_smooth": ("label_smooth", {"X": [np.eye(5, dtype="float32")[[1, 0, 4]]]},
                     {"epsilon": 0.1}, ("Out",), TOL),
    "label_smooth-prior": ("label_smooth",
                           {"X": [np.eye(4, dtype="float32")[[3, 2]]],
                            "PriorDist": [np.array([0.1, 0.2, 0.3, 0.4], "float32")]},
                           {"epsilon": 0.2}, ("Out",), TOL),
    "assign_value-f32": ("assign_value", {},
                         {"shape": [1, 1, 3, 3], "dtype": "float32",
                          "values": np.triu(np.full((3, 3), -1e4, "float32"), 1)
                          .reshape(-1).tolist()}, (), TOL),
    "assign_value-int32": ("assign_value", {},
                           {"shape": [1, 5], "dtype": "int32", "values": [0, 1, 2, 3, 4]},
                           (), TOL),
    "assign_value-int64": ("assign_value", {},
                           {"shape": [2], "dtype": "int64", "values": [7, -3]}, (), TOL),
    "expand": ("expand", {"X": [_r(2, 1, 3)]}, {"expand_times": [1, 4, 2]}, ("Out",), TOL),
    "expand-int": ("expand", {"X": [_ids((3, 1, 2), 5)]}, {"expand_times": [1, 3, 1]},
                   (), TOL),
    "squeeze2": ("squeeze2", {"X": [_r(4, 1, 6)]}, {"axes": [1]}, ("Out",), TOL),
    "squeeze2-not-one": ("squeeze2", {"X": [_r(4, 2, 1)]}, {"axes": [1, -1]}, ("Out",), TOL),
    "squeeze2-all": ("squeeze2", {"X": [_r(1, 3, 1)]}, {"axes": []}, ("Out",), TOL),
    "less_than-int64": ("less_than", {"X": [_ids((4, 6), 6)], "Y": [np.array([3], "int64")]},
                        {}, (), TOL),
    "less_than-f32": ("less_than", {"X": [_r(3, 4)], "Y": [_r(3, 4, seed=5)]}, {}, (), TOL),
    **{f"{c}-int64": (c, {"X": [_ids((4, 6), 6)], "Y": [np.array([3], "int64")]}, {}, (), TOL)
       for c in ("less_equal", "greater_than", "greater_equal", "equal", "not_equal")},
    "log_softmax": ("log_softmax", {"X": [_r(3, 4, 9, scale=3.0)]}, {"axis": -1}, ("Out",),
                    TOL),
    "log_softmax-axis1": ("log_softmax", {"X": [_r(3, 7, 2, scale=3.0)]}, {"axis": 1},
                          ("Out",), TOL),
    # the training loss at transformer-base's vocabulary width (rows do not change
    # the per-row numerics): soft labels, the label-smoothed one-hot targets
    "softmax_with_cross_entropy-soft-32000": (
        "softmax_with_cross_entropy",
        {"Logits": [_r(64, 32000, scale=2.0)], "Label": [_soft_labels(64, 32000)]},
        {"soft_label": True, "axis": -1}, ("Loss",), SUM_TOL),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _lower(reg, arr, op_type, ins, attrs):
    return reg.get(op_type).lower(reg.LowerCtx(dict(attrs)),
                                  {s: [arr(a) for a in v] for s, v in ins.items()})


def _grad_inputs(op_type, ins, attrs, jouts, cot_slots):
    """The grad op's inputs and attrs, as ``append_backward`` builds them:
    forward inputs, forward outputs, a seeded cotangent for each float
    output of ``cot_slots``."""
    gins = {s: list(v) for s, v in ins.items()}
    for s, vals in jouts.items():
        gins[s] = [None if v is None else np.asarray(v) for v in vals]
        if s in cot_slots:
            gins[s + "@GRAD"] = [_r(*np.shape(v), seed=100 + i).reshape(np.shape(v))
                                 for i, v in enumerate(vals)]
    gattrs = dict(attrs, __fwd_attrs__=dict(attrs), __fwd_out_slots__=sorted(jouts),
                  __fwd_out0__="out0")
    return gins, gattrs


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_grad_match_jax(case):
    """Forward outputs (values; JAX's integers are 32-bit with x64 off) and,
    for a float op, the generic grad of every float input."""
    op_type, ins, attrs, cot_slots, tol = CASES[case]
    jouts = _lower(jreg, jnp.asarray, op_type, ins, attrs)
    touts = _lower(treg, lambda a: torch.from_numpy(np.array(a)), op_type, ins, attrs)
    compared = 0
    for slot, tvals in touts.items():
        for j, t in zip(jouts[slot], tvals):
            if j is None or t is None:
                continue
            a, b = _np(j), _np(t)
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            assert a.dtype.kind == b.dtype.kind, (slot, a.dtype, b.dtype)
            np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                       err_msg=f"{case} {slot}", **tol)
            compared += 1
    assert compared >= 1
    if not cot_slots:
        return
    gins, gattrs = _grad_inputs(op_type, ins, attrs, jouts, cot_slots)
    jg = _lower(jreg, lambda a: None if a is None else jnp.asarray(a), op_type + "_grad",
                gins, gattrs)
    tg = _lower(treg, lambda a: None if a is None else torch.from_numpy(np.array(a)),
                op_type + "_grad", gins, gattrs)
    held = 0
    for slot, tvals in tg.items():
        src = ins[slot[:-len("@GRAD")]]
        for a, j, t in zip(src, jg[slot], tvals):
            if np.asarray(a).dtype.kind != "f":
                continue
            np.testing.assert_allclose(_np(t), _np(j), err_msg=f"{case} {slot}", **GRAD_TOL)
            held += 1
    assert held >= 1


# -- the sub-block IR ------------------------------------------------------------------

def _scan_program(pkg):
    """x [2, 4, 3] scanned by h = tanh(fc(x_t)) + fc(h_prev), h0 zeros."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [2, 4, 3], "float32", append_batch_size=False)
        h0 = pkg.layers.fill_constant([2, 5], "float32", 0.0)
        scan = pkg.layers.Scan()
        with scan.step():
            xt = scan.step_input(x)
            h = scan.memory(h0)
            nh = pkg.layers.fc(xt, 5, act="tanh", bias_attr=False)
            nh = pkg.layers.elementwise_add(nh, pkg.layers.fc(h, 5, bias_attr=False))
            scan.update_memory(h, nh)
            scan.step_output(nh)
        out = scan()
    return main, startup, out


def test_sub_block_program_round_trips():
    """A program with a scan body: the same blocks, vars and ops as the JAX
    package's, through to_dict / from_dict / clone and the JSON form, and
    each package loads the other's."""
    jmain, _, _ = _scan_program(fluid)
    tmain, _, _ = _scan_program(pt)
    assert len(tmain.blocks) == 2 and tmain.blocks[1].parent_idx == 0
    assert tmain.current_block().idx == 0           # rolled back after the body
    td, jd = tmain.to_dict(), jmain.to_dict()
    for tb, jb in zip(td["blocks"], jd["blocks"]):
        assert [o["type"] for o in tb["ops"]] == [o["type"] for o in jb["ops"]]
        assert tb["ops"] == jb["ops"]
    again = pt.Program.from_json(tmain.to_json())
    assert again.to_dict() == td
    assert tmain.clone().to_dict() == td
    assert pt.Program.from_json(jmain.to_json()).to_dict()["blocks"][1]["ops"] == \
        td["blocks"][1]["ops"]
    scan_op = tmain.global_block().ops[-1]
    assert scan_op.type == "scan" and scan_op.attr("sub_block") == 1
    pruned = tmain._prune(["x"], [scan_op.output("Out")[0]])
    assert [o.type for o in pruned.global_block().ops] == ["fill_constant", "scan"]


def test_state_of_a_scan_body_comes_from_its_static_inputs():
    """``Executor._state_names`` reads the global block only: the parameters
    a body reads are there as the scan op's Static inputs."""
    main, _, _ = _scan_program(pt)
    body_reads = {n for op in main.blocks[1].ops for n in op.input_arg_names()}
    params = {n for n, v in main.global_block().vars.items() if v.persistable}
    assert params and params <= body_reads
    state_in, state_out = Executor._state_names(main, {"x": None})
    assert set(state_in) == params and not state_out
    assert set(main.global_block().ops[-1].input("Static")) == params


# -- Transformer training ----------------------------------------------------------------

S, B, VOCAB = 8, 4, 64


def _build(pkg, model, dropout=0.0):
    cfg = model.TransformerConfig(src_vocab=VOCAB, trg_vocab=VOCAB, hidden=32, n_layers=2,
                                  n_heads=4, ffn_hidden=64, max_len=12, dropout=dropout)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 4
    startup.random_seed = 4
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ins = [pkg.data(n, [S], t) for n, t in (
            ("src", "int64"), ("spos", "int64"), ("smask", "float32"), ("trg", "int64"),
            ("tpos", "int64"), ("tmask", "float32"), ("lbl", "int64"))]
        loss, _ = model.transformer(*ins, cfg, label_smooth_eps=0.1)
        _, params_grads = pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss, params_grads


def _feeds():
    rng = np.random.RandomState(0)
    pos = np.tile(np.arange(S), (B, 1)).astype("int64")
    return {"src": rng.randint(0, VOCAB, (B, S)).astype("int64"), "spos": pos,
            "smask": np.ones((B, S), "float32"),
            "trg": rng.randint(0, VOCAB, (B, S)).astype("int64"), "tpos": pos,
            "tmask": np.ones((B, S), "float32"),
            "lbl": rng.randint(0, VOCAB, (B, S)).astype("int64")}


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


@pytest.fixture(scope="module")
def programs():
    return _build(fluid, jtrans), _build(pt, ttrans)


def test_training_program_matches_jax(programs):
    """The same op types in order (forward, grad ops, Adam), the same
    (param, grad) pairs and the same persistable state names."""
    (jm, _, _, jpg), (tm, _, _, tpg) = programs
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert [(p.name, g.name) for p, g in tpg] == [(p.name, g.name) for p, g in jpg]
    assert _persistables(tm) == _persistables(jm)
    grad_types = {op.type for op in tm.global_block().ops if op.type.endswith("_grad")}
    assert {"elementwise_mul_grad", "elementwise_div_grad", "reduce_sum_grad",
            "softmax_with_cross_entropy_grad"} <= grad_types
    assert "label_smooth_grad" not in grad_types and "one_hot_grad" not in grad_types


def test_three_adam_steps_match_jax(programs):
    (jm, js, jl, _), (tm, _, tl, _) = programs
    feeds = _feeds()
    names = _persistables(jm)
    exe = fluid.Executor()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jlosses = [float(np.asarray(exe.run(jm, feed=feeds, fetch_list=[jl])[0]))
                   for _ in range(3)]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        texe = pt.Executor(pt.CPUPlace())
        tlosses = [float(texe.run(tm, feed=feeds, fetch_list=[tl])[0]) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[2] < tlosses[0]
    for n in names:
        got = tscope.find_var(n)
        assert tuple(got.shape) == jfinal[n].shape, n
        np.testing.assert_allclose(got.numpy(), jfinal[n], atol=5e-5, err_msg=n)


def test_loss_falls_with_dropout():
    """Dropout 0.1 on the port alone (the two packages' RNGs differ): finite
    losses that fall over 8 Adam steps on one batch."""
    main, startup, loss, _ = _build(pt, ttrans, dropout=0.1)
    assert sum(op.type == "dropout" for op in main.global_block().ops) == 2 * 3 + 2 + 2 * 5
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        losses = [float(exe.run(main, feed=_feeds(), fetch_list=[loss])[0])
                  for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_a_refused_capture_says_why(monkeypatch):
    """On the card a startup program (host-seeded draws) is not captured, and
    its first run warns why; the Transformer's training and decode programs
    are captured."""
    from paddle_tpu_torch.core.executor import capture_refusal
    monkeypatch.setattr(Executor, "_captures", lambda self: True)
    main, startup, _, _ = _build(pt, ttrans, dropout=0.1)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        with pytest.warns(UserWarning, match="not captured.*host-seeded"):
            exe.run(startup)
    step, = exe._cache.values()
    assert step.graph is None and "host-seeded" in step.refusal
    dec = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(dec, pt.Program()):
        src, pos, mask = (pt.data(n, [S], t) for n, t in
                          (("src", "int64"), ("pos", "int64"), ("mask", "float32")))
        ttrans.beam_decode(src, pos, mask, ttrans.TransformerConfig(
            src_vocab=VOCAB, trg_vocab=VOCAB, hidden=32, n_layers=2, n_heads=4,
            ffn_hidden=64, max_len=12, dropout=0.0), beam_size=2, max_len=3)
    assert capture_refusal(main) is None and capture_refusal(dec) is None


def test_a_step_leaves_no_cycle_holding_its_env(monkeypatch):
    """The env of a run (every intermediate, when none is freed early) goes
    with the run, by reference counting: the sub-block runner every op's
    context holds keeps no cycle back to it."""
    import gc
    import weakref
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        loss = pt.layers.mean(pt.layers.scale(x, scale=3.0))
    made = []
    lower = treg.get("scale").lower

    def recording(ctx, ins):
        outs = lower(ctx, ins)
        made.append(weakref.ref(outs["Out"][0]))
        return outs

    monkeypatch.setattr(treg.get("scale"), "lower", recording)
    exe = pt.Executor(pt.CPUPlace())
    exe._free_dead = False
    gc.disable()
    try:
        exe.run(main, feed={"x": np.ones((2, 4), "float32")}, fetch_list=[loss])
        assert made and made[0]() is None
    finally:
        gc.enable()
