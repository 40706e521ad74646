"""The sequence, CRF and loss ops of the book chapters, and training
through ``scan`` (LSTM and GRU layers), held against the JAX package on
the CPU.

Ops, in the style of ``tests/test_torch_ops.py::CASES``: each op type's
forward against the JAX lowering, and the port's generic grad against the
JAX package's vjp, on the same numpy inputs. Sequences are padded
[B, T, ...] with ragged lengths that include 1 and T. Tie cases: MAX
pooling over equal maxima (both packages split the gradient evenly), and
Viterbi over a zero transition matrix and zero emissions, where every path
ties (both take the first maximum: tag 0 everywhere).

Training through ``scan``: the gradients of every parameter, the input
sequence and the first carries of a 2-layer ``simple_lstm``, a reverse
``dynamic_lstm`` and a ``dynamic_gru``, against the JAX program's
(``jax.vjp`` through ``lax.scan``) on equal weights, with a loss that
reads the final carries too (their cotangents flow back across every
iteration); three Adam steps; and the captured step on the CPU stand-in
graph of ``tests/test_torch_graph_step.py`` against eager, bit for bit.

Tolerances: float32 ``atol 1e-5, rtol 1e-5`` (sums in another order),
the gradients through ``scan`` and the Adam states included; ``atol 1e-4``
for the CRF's log-sum-exp chains; ids, lengths and Viterbi paths exact
(the JAX package's are int32 with x64 off, the port's int64: values are
compared).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from tests.test_torch_graph_step import stand_in  # noqa: F401  (a fixture)

TOL = dict(atol=1e-5, rtol=1e-5)
CRF_TOL = dict(atol=1e-4, rtol=1e-5)
B, T, D = 5, 6, 4
LENS = np.array([1, T, 3, 4, T - 1], "int64")


def _r(*shape, scale=1.0, seed=None):
    seed = sum(shape) if seed is None else seed
    return (np.random.RandomState(seed).randn(*shape) * scale).astype("float32")


def _ids(shape, hi, seed=1):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


def _ties(seed=2):
    """[B, T, D] with repeated maxima in each row's valid steps."""
    x = np.random.RandomState(seed).randint(0, 3, (B, T, D)).astype("float32")
    x[:, 1] = x[:, 0]
    return x


N_TAGS = 4
# id -> (op type, forward inputs, attrs, output slots that get a cotangent or
# None (no gradient), tolerance)
CASES = {
    "square_error_cost": ("square_error_cost", {"X": [_r(6, 1)], "Y": [_r(6, 1, seed=3)]},
                          {}, ("Out",), TOL),
    "square_error_cost-3d": ("square_error_cost", {"X": [_r(2, 3, 4)], "Y": [_r(2, 3, 4, seed=4)]},
                             {}, ("Out",), TOL),
    "cos_sim": ("cos_sim", {"X": [_r(7, 5)], "Y": [_r(7, 5, seed=9)]}, {}, ("Out",), TOL),
    "fill_constant_batch_size_like": ("fill_constant_batch_size_like", {"Input": [_r(5, 3)]},
                                      {"shape": [-1, 4], "dtype": "float32", "value": 0.5,
                                       "input_dim_idx": 0, "output_dim_idx": 0}, None, TOL),
    "fill_constant_batch_size_like-int64": ("fill_constant_batch_size_like",
                                            {"Input": [_r(2, 7)]},
                                            {"shape": [3, -1], "dtype": "int64", "value": 7.0,
                                             "input_dim_idx": 1, "output_dim_idx": 1},
                                            None, TOL),
    "sequence_unpad": ("sequence_unpad", {"X": [_r(B, T, D)], "Length": [LENS]}, {},
                       ("Out",), TOL),
    "sequence_reverse": ("sequence_reverse", {"X": [_r(B, T, D)], "Length": [LENS]}, {},
                         ("Y",), TOL),
    "sequence_reverse-2d": ("sequence_reverse", {"X": [_r(B, T)], "Length": [LENS]}, {},
                            ("Y",), TOL),
    "sequence_conv": ("sequence_conv", {"X": [_r(B, T, D)], "Filter": [_r(3 * D, 5)],
                                        "Length": [LENS]},
                      {"context_length": 3, "context_start": -1}, ("Out",), TOL),
    "sequence_conv-start0-nolength": ("sequence_conv", {"X": [_r(B, T, D)],
                                                        "Filter": [_r(2 * D, 3)]},
                                      {"context_length": 2, "context_start": 0}, ("Out",), TOL),
    "sequence_conv-wide": ("sequence_conv", {"X": [_r(B, T, D)], "Filter": [_r(5 * D, 3)],
                                             "Length": [LENS]},
                           {"context_length": 5, "context_start": -3}, ("Out",), TOL),
    "linear_chain_crf": ("linear_chain_crf",
                         {"Emission": [_r(B, T, N_TAGS)], "Transition": [_r(N_TAGS + 2, N_TAGS)],
                          "Label": [_ids((B, T), N_TAGS)], "Length": [LENS]},
                         {}, ("LogLikelihood",), CRF_TOL),
    "linear_chain_crf-zero-transition": ("linear_chain_crf",
                                         {"Emission": [_r(B, T, N_TAGS, seed=5)],
                                          "Transition": [np.zeros((N_TAGS + 2, N_TAGS),
                                                                  "float32")],
                                          "Label": [_ids((B, T), N_TAGS, seed=6)],
                                          "Length": [LENS]},
                                         {}, ("LogLikelihood",), CRF_TOL),
    "crf_decoding": ("crf_decoding", {"Emission": [_r(B, T, N_TAGS)],
                                      "Transition": [_r(N_TAGS + 2, N_TAGS)],
                                      "Length": [LENS]}, {}, None, CRF_TOL),
    # every path ties: the first maximum (tag 0) everywhere
    "crf_decoding-ties": ("crf_decoding", {"Emission": [np.zeros((B, T, N_TAGS), "float32")],
                                           "Transition": [np.zeros((N_TAGS + 2, N_TAGS),
                                                                   "float32")],
                                           "Length": [LENS]}, {}, None, CRF_TOL),
    "crf_decoding-int-ties": ("crf_decoding",
                              {"Emission": [_ids((B, T, N_TAGS), 2, seed=8).astype("float32")],
                               "Transition": [_ids((N_TAGS + 2, N_TAGS), 2, seed=9)
                                              .astype("float32")],
                               "Length": [LENS]}, {}, None, CRF_TOL),
}
for _p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
    CASES[f"sequence_pool-{_p}"] = ("sequence_pool", {"X": [_r(B, T, D)], "Length": [LENS]},
                                    {"pooltype": _p}, ("Out",), TOL)
CASES["sequence_pool-MAX-ties"] = ("sequence_pool", {"X": [_ties()], "Length": [LENS]},
                                   {"pooltype": "MAX"}, ("Out",), TOL)
CASES["sequence_pool-SUM-4d"] = ("sequence_pool", {"X": [_r(B, T, 2, 3)], "Length": [LENS]},
                                 {"pooltype": "SUM"}, ("Out",), TOL)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lower_jax(op_type, attrs, ins):
    return jreg.get(op_type).lower(jreg.LowerCtx(dict(attrs)),
                                   {s: [None if a is None else jnp.asarray(a) for a in v]
                                    for s, v in ins.items()})


def _lower_port(op_type, attrs, ins):
    return treg.get(op_type).lower(treg.LowerCtx(dict(attrs)),
                                   {s: [None if a is None else torch.from_numpy(np.array(a))
                                        for a in v] for s, v in ins.items()})


def _compare(jouts, touts, tol, case):
    compared = 0
    for slot, tvals in touts.items():
        for j, t in zip(jouts[slot], tvals):
            if j is None:
                continue
            a, b = _np(j), _np(t)
            assert a.shape == b.shape, (case, slot, a.shape, b.shape)
            assert a.dtype.kind == b.dtype.kind, (case, slot, a.dtype, b.dtype)
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(b, a, err_msg=f"{case} {slot}")
            else:
                np.testing.assert_allclose(b, a, err_msg=f"{case} {slot}", **tol)
            compared += 1
    assert compared >= 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_lowering(case):
    op_type, ins, attrs, _, tol = CASES[case]
    _compare(_lower_jax(op_type, attrs, ins), _lower_port(op_type, attrs, ins), tol, case)


@pytest.mark.parametrize("case", sorted(c for c in CASES if CASES[c][3] is not None))
def test_op_grad_matches_jax(case):
    """The grad op's inputs as ``make_grad_op_descs`` builds them (forward
    outputs from the JAX forward, a seeded cotangent for each float output
    of the cotangent slots); every input gradient compared."""
    op_type, ins, attrs, cot_slots, tol = CASES[case]
    fwd = _lower_jax(op_type, attrs, ins)
    gins = {s: list(v) for s, v in ins.items()}
    for s, vals in fwd.items():
        gins[s] = [None if v is None else np.asarray(v) for v in vals]
        if s in cot_slots:
            gins[s + "@GRAD"] = [_r(*np.shape(v), seed=100 + i) for i, v in enumerate(vals)]
    gattrs = dict(attrs, __fwd_attrs__=dict(attrs), __fwd_out_slots__=sorted(fwd),
                  __fwd_out0__="out0")
    jouts = _lower_jax(op_type + "_grad", gattrs, gins)
    touts = _lower_port(op_type + "_grad", gattrs, gins)
    assert sorted(touts) == sorted(jouts)
    _compare(jouts, touts, tol, case)
    assert all(np.abs(_np(g)).sum() > 0 for vs in touts.values() for g in vs)


def test_max_pooling_splits_a_tied_gradient_evenly():
    x = torch.tensor([[[2.0], [2.0], [1.0], [2.0]]], requires_grad=True)
    out = treg.get("sequence_pool").lower(treg.LowerCtx({"pooltype": "MAX"}),
                                          {"X": [x], "Length": [torch.tensor([3])]})["Out"][0]
    out.sum().backward()
    assert x.grad.reshape(-1).tolist() == [0.5, 0.5, 0.0, 0.0]


def test_viterbi_ties_take_the_first_maximum():
    outs = _lower_port("crf_decoding", {}, CASES["crf_decoding-ties"][1])
    path = outs["ViterbiPath"][0]
    assert path.dtype == torch.int64 and not path.any()


def test_no_host_read_in_the_sequence_ops():
    """Every loop runs over the static T: the ops run on meta tensors (no
    values at all), which a length read on the host would fail on."""
    meta = torch.device("meta")
    for case in ("sequence_pool-LAST", "sequence_reverse", "sequence_conv", "linear_chain_crf",
                 "crf_decoding"):
        op_type, ins, attrs, _, _ = CASES[case]
        outs = treg.get(op_type).lower(
            treg.LowerCtx(dict(attrs), device=meta, abstract=True),
            {s: [torch.from_numpy(np.array(a)).to(meta) for a in v] for s, v in ins.items()})
        assert all(t.device == meta for vs in outs.values() for t in vs)


# -- the layers build the JAX package's programs ---------------------------------------

def _layers_program(pkg):
    """Every new layer of the slice, in one program."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        A = dict(append_batch_size=False)
        x = pkg.data("x", [-1, T, D], "float32", **A)
        y = pkg.data("y", [-1, T, D], "float32", **A)
        n = pkg.data("n", [-1], "int64", **A)
        lab = pkg.data("lab", [-1, T], "int64", **A)
        L = pkg.layers
        outs = [L.sequence_pool(x, p, length=n) for p in ("sum", "average", "sqrt", "max")]
        outs += [L.sequence_first_step(x, length=n), L.sequence_last_step(x, length=n),
                 L.sequence_reverse(x, length=n), L.sequence_unpad(x, length=n),
                 L.sequence_conv(x, 3, filter_size=3, length=n, act="tanh"),
                 L.square_error_cost(x, y), L.cos_sim(L.reshape(x, [-1, D]),
                                                      L.reshape(y, [-1, D])),
                 L.tanh(x), L.sum([x, y]),
                 L.fill_constant_batch_size_like(x, [-1, 3], "float32", 1.0)]
        h, c = L.dynamic_lstm(L.fc(x, 8, num_flatten_dims=2), 8, length=n, is_reverse=True)
        g = L.dynamic_gru(x, 3, length=n)
        attr = pkg.ParamAttr(name="crfw")
        em = L.fc(L.concat([h, g], axis=2), N_TAGS, num_flatten_dims=2)
        nll = L.linear_chain_crf(em, lab, param_attr=attr, length=n)
        path = L.crf_decoding(em, attr, length=n)
        outs += [h, c, g, nll, path]
    return main, startup, outs


def test_the_layers_build_the_jax_programs():
    """The same ops (types, slots, attrs), in every block, the same
    variables' shapes and dtypes, and the same parameters."""
    (jm, js, jo), (tm, ts, to) = _layers_program(fluid), _layers_program(pt)
    jd, td = jm.to_dict(), tm.to_dict()
    assert [b["ops"] for b in td["blocks"]] == [b["ops"] for b in jd["blocks"]]
    assert [b["ops"] for b in ts.to_dict()["blocks"]] == [b["ops"] for b in js.to_dict()["blocks"]]
    # the JAX package infers int32 where x64 is off (the Viterbi path): compare widths apart
    wide = {"int32": "int64"}
    assert [(tuple(v.shape), v.dtype) for v in to] == [(tuple(v.shape), wide.get(v.dtype, v.dtype))
                                                       for v in jo]
    params = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    assert sorted(n for n, v in tm.global_block().vars.items() if v.persistable) == params
    assert tm.global_block().var("crfw").shape == (N_TAGS + 2, N_TAGS)


def test_peepholes_are_refused_as_in_jax():
    for pkg in (fluid, pt):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            x = pkg.data("x", [-1, T, 8], "float32", append_batch_size=False)
            with pytest.raises(NotImplementedError):
                pkg.layers.dynamic_lstm(x, 8, use_peepholes=True)


# -- training through scan -------------------------------------------------------------

H = 5


def _rnn_program(pkg, kind):
    """A recurrence over x [B, T, D] with ragged lengths, the first carries
    fed (``h0``, ``c0``: their gradients cross every iteration), and a
    loss that reads the outputs and the final carries. Returns (main,
    startup, loss, gradient variables, the names they are of)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 4
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        A = dict(append_batch_size=False)
        x = pkg.data("x", [B, T, D], "float32", **A)
        n = pkg.data("n", [B], "int64", **A)
        h0 = pkg.data("h0", [B, H], "float32", **A)
        c0 = pkg.data("c0", [B, H], "float32", **A)
        for v in (x, h0, c0):
            v.stop_gradient = False
        L = pkg.layers
        if kind == "simple_lstm-2":
            h, c = L.simple_lstm(x, H, h0=h0, c0=c0, return_cell=True)
            out = L.simple_lstm(h, H, forget_bias=0.5)
        elif kind == "dynamic_lstm-reverse":
            out, c = L.dynamic_lstm(L.fc(x, 4 * H, num_flatten_dims=2), 4 * H, h_0=h0, c_0=c0,
                                    length=n, is_reverse=True)
        else:
            out = L.dynamic_gru(x, H, h_0=h0, length=n)
            c = out
        loss = L.mean(L.sequence_pool(out, "max", length=n))
        finals = [op for op in main.global_block().ops if op.type == "scan"][0]
        fin = [main.global_block().var(f) for f in finals.output("FinalCarry")]
        for f in fin:
            loss = L.elementwise_add(loss, L.mean(L.square(f)))
        loss = L.elementwise_add(loss, L.mean(L.square(c)))
        params = sorted(nm for nm, v in main.global_block().vars.items() if v.persistable)
        blk = main.global_block()
        wrt = ["x", "h0"] + (["c0"] if "lstm" in kind else []) + params
        grads = pkg.gradients(loss, [blk.var(nm) for nm in wrt])
    return main, startup, loss, grads, wrt


def _rnn_feed():
    rng = np.random.RandomState(11)
    return {"x": rng.randn(B, T, D).astype("float32"), "n": LENS,
            "h0": rng.randn(B, H).astype("float32") * 0.5,
            "c0": rng.randn(B, H).astype("float32") * 0.5}


def _jax_state(main, startup):
    names = sorted(n for n, v in main.global_block().vars.items() if v.persistable)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor().run(startup)
        return {n: np.asarray(scope.find_var(n)) for n in names}, scope


@pytest.mark.parametrize("kind", ["simple_lstm-2", "dynamic_lstm-reverse", "dynamic_gru"])
def test_gradient_through_scan_matches_jax(kind):
    jm, js, jl, jg, wrt = _rnn_program(fluid, kind)
    tm, _, tl, tg, twrt = _rnn_program(pt, kind)
    assert twrt == wrt
    assert [b["ops"] for b in tm.to_dict()["blocks"]] == [b["ops"] for b in jm.to_dict()["blocks"]]
    feed = _rnn_feed()
    if "lstm" not in kind:
        feed.pop("c0")
    state, jscope = _jax_state(jm, js)
    with fluid.scope_guard(jscope):
        jvals = fluid.Executor().run(jm, feed=feed, fetch_list=[jl] + jg)
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(state, device="cpu"))
    with pt.scope_guard(scope):
        tvals = pt.Executor(pt.CPUPlace()).run(tm, feed=feed, fetch_list=[tl] + tg)
    for what, a, b in zip(["loss"] + wrt, jvals, tvals):
        a = np.asarray(a)
        assert a.shape == b.shape, what
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5, err_msg=what)
        assert what == "loss" or np.abs(b).sum() > 0, what


def _lstm_train_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        A = dict(append_batch_size=False)
        x = pkg.data("x", [-1, T, D], "float32", **A)
        n = pkg.data("n", [-1], "int64", **A)
        label = pkg.data("label", [-1, 1], "int64", **A)
        L = pkg.layers
        h = L.simple_lstm(x, H)
        h, _ = L.dynamic_lstm(L.fc(h, 4 * H, num_flatten_dims=2), 4 * H, length=n,
                              is_reverse=True)
        logits = L.fc(L.sequence_pool(h, "max", length=n), 3)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        acc = L.accuracy(logits, label)
        pkg.optimizer.Adam(0.05).minimize(loss)
    return main, startup, loss, acc


def _lstm_feeds():
    rng = np.random.RandomState(12)
    return [{"x": rng.randn(B, T, D).astype("float32"), "n": LENS,
             "label": rng.randint(0, 3, (B, 1)).astype("int64")} for _ in range(3)]


def test_three_adam_steps_through_scan_match_jax():
    """A 2-layer LSTM (the second reverse, with lengths) trained 3 Adam
    steps from the JAX startup state: losses ``rtol 1e-5``, accuracy
    exactly, every state tensor (weights and Adam's accumulators) ``atol
    1e-5``."""
    jm, js, jl, ja = _lstm_train_program(fluid)
    tm, _, tl, ta = _lstm_train_program(pt)
    feeds = _lstm_feeds()
    state, jscope = _jax_state(jm, js)
    with fluid.scope_guard(jscope):
        jouts = [fluid.Executor().run(jm, feed=f, fetch_list=[jl, ja]) for f in feeds]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in state}
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(state, device="cpu"))
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        touts = [exe.run(tm, feed=f, fetch_list=[tl, ta]) for f in feeds]
    np.testing.assert_allclose([float(o[0]) for o in touts],
                               [float(np.asarray(o[0])) for o in jouts], rtol=1e-5)
    assert [float(o[1]) for o in touts] == [float(np.asarray(o[1])) for o in jouts]
    for n, want in jfinal.items():
        np.testing.assert_allclose(scope.find_var(n).numpy(), want, atol=1e-5, err_msg=n)
    assert not np.allclose(scope.find_var("fc_0.w_0").numpy(), state["fc_0.w_0"])


def test_the_captured_step_through_scan_equals_eager_bit_for_bit(stand_in):
    """The same LSTM trained 3 steps through the executor's graph cache (the
    CPU stand-in graph: capture, then replays) and eagerly, from the same
    state: losses and every state tensor ``torch.equal``."""
    tm, ts, tl, ta = _lstm_train_program(pt)
    feeds = _lstm_feeds()
    scope0 = pt.Scope()
    with pt.scope_guard(scope0):
        pt.Executor(pt.CPUPlace()).run(ts)
    names = sorted(n for n, v in tm.global_block().vars.items() if v.persistable)
    runs = {}
    for graphs in (True, False):
        exe = pt.Executor(pt.CPUPlace())
        exe._use_graphs = graphs
        scope = pt.Scope()
        for n in names:
            scope.set_var(n, scope0.find_var(n).clone())
        tm._rng_run_counter = 0
        with pt.scope_guard(scope):
            outs = [exe.run(tm, feed=f, fetch_list=[tl, ta], return_numpy=False)
                    for f in feeds]
        runs[graphs] = ([o[0].clone() for o in outs], {n: scope.find_var(n) for n in names})
    assert stand_in.captures == 1
    (gl, gs), (el, es) = runs[True], runs[False]
    assert all(torch.equal(a, b) for a, b in zip(gl, el))
    assert [n for n in names if not torch.equal(gs[n], es[n])] == []
