"""Beam search and ``scan`` through the port on the CPU, held against the
JAX package: the beam ops on the cases of tests/test_beam_search.py and on
ties, a ``Scan`` recurrence forward and backward through the sub-block
runner, and ``beam_decode`` of a toy Transformer on weights carried from
the JAX startup.

Tolerances: float32 ``atol 1e-5`` for values summed in another order (the
decode's scores are sums of log-softmax outputs over 5 steps; the scan's
loss and gradients go through 4 steps of fc + tanh); ids and parents exact.
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
from paddle_tpu_torch.core.executor import trace_block
from paddle_tpu_torch.models import transformer as ttrans

ATOL = 1e-5


def _run_port(main, feed, fetches, state=None, startup=None):
    scope = pt.Scope()
    if state is not None:
        convert.load_state(scope, convert.state_from_numpy(state, device="cpu"))
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        if startup is not None:
            exe.run(startup)
        return exe.run(main, feed=feed, fetch_list=fetches)


def _run_jax(main, feed, fetches, startup=None, state_names=()):
    """(fetches, the startup's state of ``state_names``)."""
    exe = fluid.Executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        if startup is not None:
            exe.run(startup)
        state = {n: np.asarray(scope.find_var(n)) for n in state_names}
        return exe.run(main, feed=feed, fetch_list=fetches), state


# -- the beam ops ------------------------------------------------------------------------

def _lower_both(op_type, ins, attrs):
    j = jreg.get(op_type).lower(jreg.LowerCtx(dict(attrs)),
                                {s: [jnp.asarray(a) for a in v] for s, v in ins.items()})
    t = treg.get(op_type).lower(treg.LowerCtx(dict(attrs)),
                                {s: [torch.from_numpy(np.array(a)) for a in v]
                                 for s, v in ins.items()})
    return j, t


def _logp(rows):
    return np.log(np.asarray(rows, "float32"))


# id -> (op type, inputs, attrs): the JAX lowering's outputs are the reference
BEAM_CASES = {
    # tests/test_beam_search.py::test_beam_search_op_semantics
    "step0": ("beam_search", {"PreIds": [np.zeros((1, 2), "int64")],
                              "PreScores": [np.array([[0.0, -1e9]], "float32")],
                              "Scores": [_logp([[[0.1, 0.2, 0.3, 0.4],
                                                 [0.25, 0.25, 0.25, 0.25]]])],
                              "Finished": [np.zeros((1, 2), bool)]},
              {"beam_size": 2, "end_id": 0}),
    # ::test_beam_search_finished_freeze
    "finished-freeze": ("beam_search", {"PreIds": [np.zeros((1, 2), "int64")],
                                        "PreScores": [np.array([[-0.5, -0.1]], "float32")],
                                        "Scores": [np.full((1, 2, 3), np.log(1 / 3), "float32")],
                                        "Finished": [np.array([[False, True]])]},
                        {"beam_size": 2, "end_id": 2}),
    # a tie in beam 0: tokens 1 and 3 score alike; JAX's top_k takes 1 first
    "tie-beam0": ("beam_search", {"PreIds": [np.zeros((2, 3), "int64")],
                                  "PreScores": [np.array([[0.0, -1e9, -1e9],
                                                          [-0.2, -0.7, -1e9]], "float32")],
                                  "Scores": [_logp([[[0.1, 0.3, 0.2, 0.3]] * 3,
                                                    [[0.4, 0.2, 0.2, 0.2],
                                                     [0.2, 0.5, 0.2, 0.1],
                                                     [0.25, 0.25, 0.25, 0.25]]])],
                                  "Finished": [np.zeros((2, 3), bool)]},
                  {"beam_size": 3, "end_id": 1}),
    # step 0 with fewer live candidates than beams: the dead beams tie at -1e9
    # (f32: -1e9 + logp rounds to -1e9) and go in index order
    "dead-beam-ties": ("beam_search", {"PreIds": [np.zeros((1, 4), "int64")],
                                       "PreScores": [np.array([[0.0] + [-1e9] * 3], "float32")],
                                       "Scores": [_logp([[[0.6, 0.4]] * 4])],
                                       "Finished": [np.zeros((1, 4), bool)]},
                       {"beam_size": 4, "end_id": 1}),
    # flat [B*K, V] scores, straight out of the decoder
    "flat-scores": ("beam_search", {"PreIds": [np.zeros((2, 2), "int64")],
                                    "PreScores": [np.array([[-1.0, -1.5], [-0.3, -2.0]],
                                                           "float32")],
                                    "Scores": [_logp(np.random.RandomState(2).dirichlet(
                                        np.ones(5), 4))],
                                    "Finished": [np.array([[False, True], [True, False]])]},
                    {"beam_size": 2, "end_id": 3}),
    # ::test_beam_search_decode_backtrack
    "decode-backtrack": ("beam_search_decode",
                         {"Ids": [np.array([[[5, 6], [7, 8]]], "int64")],
                          "Parents": [np.array([[[0, 0], [1, 1]]], "int64")],
                          "Scores": [np.array([[-1.0, -2.0]], "float32")]}, {"end_id": 1}),
    # unsorted scores with a tie, an end token mid-sentence, int32 parents
    "decode-sort-and-end": ("beam_search_decode",
                            {"Ids": [np.array([[[4, 1, 2], [1, 5, 6], [7, 8, 9]]], "int64")],
                             "Parents": [np.array([[[0, 0, 0], [2, 0, 1], [1, 1, 0]]],
                                                  "int32")],
                             "Scores": [np.array([[-3.0, -1.0, -3.0]], "float32")]},
                            {"end_id": 1}),
    # ::test_beam_append_reorders_and_writes
    "append": ("beam_append", {"IdsBuf": [np.array([[[0, 9, 9], [0, 5, 9]]], "int64")],
                               "Parent": [np.array([[1, 1]], "int64")],
                               "NewIds": [np.array([[7, 8]], "int64")],
                               "StepIdx": [np.array([2], "int32")]}, {}),
    "init": ("beam_init", {"BatchRef": [np.zeros((3, 5), "int64")]},
             {"beam_size": 4, "buf_len": 6, "bos_id": 0}),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_beam_op_matches_jax(case):
    op_type, ins, attrs = BEAM_CASES[case]
    jouts, touts = _lower_both(op_type, ins, attrs)
    assert sorted(touts) == sorted(jouts)
    for slot in touts:
        for j, t in zip(jouts[slot], touts[slot]):
            a, b = np.asarray(j), t.numpy()
            assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (slot, a, b)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f"{case} {slot}")
            else:
                np.testing.assert_array_equal(b, a, err_msg=f"{case} {slot}")


def test_beam_layers_through_the_executor():
    """The values of tests/test_beam_search.py, through the port's DSL and
    Executor: the step-0 selection and a tie in beam 0 resolved to the lower
    token, as JAX's top_k resolves it."""
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        ps = pt.data("ps", [2], "float32")
        lp = pt.data("lp", [2, 4], "float32")
        fin = pt.data("fin", [2], "bool")
        ids, scores, parent, fout = pt.layers.beam_search(ps, ps, lp, fin, beam_size=2,
                                                          end_id=0)
    assert tuple(ids.shape) == (-1, 2) and parent.dtype == "int32"
    feed = {"ps": np.array([[0.0, -1e9]], "float32"),
            "lp": _logp([[[0.1, 0.2, 0.3, 0.4], [0.25] * 4]]), "fin": np.zeros((1, 2), bool)}
    iv, sv, pv, fv = _run_port(main, feed, [ids, scores, parent, fout])
    np.testing.assert_array_equal(iv, [[3, 2]])
    np.testing.assert_array_equal(pv, [[0, 0]])
    np.testing.assert_allclose(sv, np.log([[0.4, 0.3]]), rtol=1e-5)
    assert not fv.any()
    feed["lp"] = _logp([[[0.1, 0.35, 0.2, 0.35], [0.25] * 4]])
    iv, _, pv, _ = _run_port(main, feed, [ids, scores, parent, fout])
    np.testing.assert_array_equal(iv, [[1, 3]])
    np.testing.assert_array_equal(pv, [[0, 0]])


# -- scan ----------------------------------------------------------------------------------

def _scan_program(pkg, time_major=False):
    """h_t = tanh(fc(x_t)) + fc(h_{t-1}), h0 = 0.5, over 4 steps; the loss is
    sum(h_t * h_t) over the stacked outputs. Returns (main, startup, loss,
    out, final carry, [d loss / d x, d loss / d each parameter], params)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        shape = [4, 2, 3] if time_major else [2, 4, 3]
        x = pkg.data("x", shape, "float32", append_batch_size=False)
        x.stop_gradient = False
        h0 = pkg.layers.fill_constant([2, 5], "float32", 0.5)
        scan = pkg.layers.Scan(time_major=time_major)
        with scan.step():
            xt = scan.step_input(x)
            h = scan.memory(h0)
            nh = pkg.layers.fc(xt, 5, act="tanh")
            nh = pkg.layers.elementwise_add(nh, pkg.layers.fc(h, 5, bias_attr=False))
            scan.update_memory(h, nh)
            scan.step_output(nh)
        out = scan()
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(out, out))
        params = sorted(n for n, v in main.global_block().vars.items() if v.persistable)
        blk = main.global_block()
        grads = pkg.gradients(loss, [blk.var("x")] + [blk.var(n) for n in params])
    return main, startup, loss, out, scan.finals[0], grads, params


@pytest.mark.parametrize("time_major", [False, True], ids=["batch-major", "time-major"])
def test_scan_forward_and_gradient_match_jax(time_major):
    jm, js, jl, jo, jf, jg, names = _scan_program(fluid, time_major)
    tm, _, tl, to, tf, tg, tnames = _scan_program(pt, time_major)
    assert tnames == names and len(names) == 3
    assert [op.type for op in tm.global_block().ops] == [op.type for op in jm.global_block().ops]
    x = np.random.RandomState(5).randn(*tm.global_block().var("x").shape).astype("float32")
    jvals, state = _run_jax(jm, {"x": x}, [jl, jo, jf] + jg, js, names)
    tvals = _run_port(tm, {"x": x}, [tl, to, tf] + tg, state)
    assert tvals[1].shape == ((4, 2, 5) if time_major else (2, 4, 5))
    for what, a, b in zip(["loss", "out", "final", "dx"] + names, jvals, tvals):
        assert a.shape == b.shape, what
        np.testing.assert_allclose(b, a, atol=ATOL, rtol=1e-5, err_msg=what)
    assert all(np.abs(g).sum() > 0 for g in tvals[3:])


def test_scan_needs_the_executors_block_runner():
    """``trace_block`` given no block runner (as the Predictor calls it, and
    as the JAX Predictor calls its own) refuses a scan: decode runs through
    ``Executor.run``."""
    main, _, loss, *_ = _scan_program(pt)
    env = {"x": torch.zeros(2, 4, 3)}
    env.update({n: torch.zeros(v.shape) for n, v in main.global_block().vars.items()
                if v.persistable})
    with pytest.raises(RuntimeError, match="block runner"):
        trace_block(main.global_block(), env, "cpu")


# -- beam_decode -------------------------------------------------------------------------

S = 6
TOY = dict(src_vocab=16, trg_vocab=16, hidden=16, n_layers=1, n_heads=2, ffn_hidden=32,
           max_len=32, dropout=0.0)


def _toy_nmt(pkg, model, beam_size):
    """tests/test_beam_search.py::_toy_nmt: vocab 16, hidden 16, 1 layer, 2
    heads, FFN 32, max_len 5, source length 6, dropout 0."""
    cfg = model.TransformerConfig(**TOY)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        src = pkg.data("src", [S], "int64")
        pos = pkg.data("pos", [S], "int64")
        mask = pkg.data("mask", [S], "float32")
        ids, scores = model.beam_decode(src, pos, mask, cfg, beam_size=beam_size, max_len=5,
                                        bos_id=0, eos_id=1)
    return main, startup, ids, scores


def _decode_feed():
    rng = np.random.RandomState(3)
    mask = np.ones((2, S), "float32")
    mask[1, 4:] = 0.0                      # a ragged second sentence
    return {"src": rng.randint(2, 16, (2, S)).astype("int64"),
            "pos": np.tile(np.arange(S), (2, 1)).astype("int64"), "mask": mask}


@pytest.mark.parametrize("beam_size", [4, 1])
def test_beam_decode_matches_jax(beam_size):
    jm, js, jids, jscores = _toy_nmt(fluid, jtrans, beam_size)
    tm, _, tids, tscores = _toy_nmt(pt, ttrans, beam_size)
    for jb, tb in zip(jm.blocks, tm.blocks):
        assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
    names = sorted(n for n, v in tm.global_block().vars.items() if v.persistable)
    (jiv, jsv), state = _run_jax(jm, _decode_feed(), [jids, jscores], js, names)
    tiv, tsv = _run_port(tm, _decode_feed(), [tids, tscores], state)
    assert tiv.shape == (2, beam_size, 5) and tiv.dtype == np.int64
    np.testing.assert_array_equal(tiv, jiv)
    np.testing.assert_allclose(tsv, jsv, atol=ATOL)
    assert (tsv[:, :-1] >= tsv[:, 1:]).all()          # best-first


def test_decode_parameters_are_the_training_programs():
    """Every parameter of the decode program is named as in the training
    program of the same configuration, so trained weights carry across by
    name (the unique_name counters run in the same order in both)."""
    cfg = ttrans.TransformerConfig(**TOY)
    train = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(train, pt.Program()):
        ins = [pt.data(n, [S], t) for n, t in (
            ("src", "int64"), ("spos", "int64"), ("smask", "float32"), ("trg", "int64"),
            ("tpos", "int64"), ("tmask", "float32"), ("lbl", "int64"))]
        loss, _ = ttrans.transformer(*ins, cfg)
        pt.optimizer.Adam(1e-3).minimize(loss)
    decode, _, _, _ = _toy_nmt(pt, ttrans, 4)
    dparams = {n for n, v in decode.global_block().vars.items() if v.persistable}
    tstate = {n for n, v in train.global_block().vars.items() if v.persistable}
    assert dparams and dparams <= tstate
    assert {n for n in tstate if not n.startswith(("learning_rate", "@"))
            and "_moment" not in n and "_pow_acc" not in n} == dparams
    body_params = {n for op in decode.blocks[1].ops for n in op.input_arg_names()} & dparams
    assert "proj_w" in body_params and "trg_emb" in body_params
