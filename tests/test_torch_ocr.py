"""CRNN-CTC text recognition (``paddle_tpu_torch/tools/ocr.py``) against the
JAX package on the CPU, at the small cut ``ocr.SMALL``: [1, 16, 64] images,
two conv groups, hidden 16, 11 classes, batch 4, T 32, labels padded to 6.

Both packages build the same programs from public layers (the same op types,
slots, attrs and names); the port starts from the JAX startup state carried
across by name (``convert.py``). Tolerances: the summed CTC loss of each of 3
Momentum steps ``rtol 1e-5`` (a 32-step recursion through two 32-step GRUs,
summed in other orders); the state after them ``rtol 1e-4`` with an absolute
floor of 1e-5 of each tensor's scale (the three steps' rounding, amplified by
the batch norms over 4 images); decoded ids, their lengths and edit
distances exactly.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.tools import ocr

CFG = ocr.SMALL
BATCH = 4
CPU = pt.CPUPlace()


def _vars(program_dict):
    """name -> (shape, dtype) of block 0, int64 read as int32 (the JAX
    package infers int32 with x64 off)."""
    return {v["name"]: (v["shape"], "int32" if v["dtype"] == "int64" else v["dtype"])
            for v in program_dict["blocks"][0]["vars"]}


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's 3 training steps from its startup state, then its
    decode program on the trained weights, saved by ``save_inference_model``
    (pixel and logits_length fed, the decode fetched): (startup state,
    losses, final state, the decode state, a fresh batch, the decode
    outputs on it, the saved model's directory). The source initialises the
    batch norms' scales from N(0, 0.01), so the untrained net's logits are
    near uniform and decode one token alike in every row: the decode runs on
    ``ocr.random_state``, a seeded state at a trained net's scales."""
    train = ocr.build_crnn_ctc(fluid, CFG)
    dec = ocr.build_crnn_ctc(fluid, CFG, train=False)
    names = _persistables(train.main)
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(train.startup)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        losses = [float(np.asarray(exe.run(train.main, feed=ocr.crnn_feed(CFG, BATCH, s),
                                           fetch_list=[train.loss])[0]).reshape(()))
                  for s in range(3)]
        final = {n: np.asarray(scope.find_var(n)) for n in names}
        decode_state = ocr.random_state(final, seed=5)
        for n, v in decode_state.items():
            scope.set_var(n, v)
        feed = ocr.crnn_feed(CFG, BATCH, 9)
        outs = [np.asarray(v) for v in exe.run(
            dec.main, feed=feed, fetch_list=[dec.logits, dec.decoded, dec.decoded_length,
                                             dec.distance])]
        saved = str(tmp_path_factory.mktemp("crnn"))
        fluid.io.save_inference_model(saved, ["pixel", "logits_length"],
                                      [dec.decoded, dec.decoded_length], exe,
                                      main_program=dec.main)
    return init, losses, final, decode_state, feed, outs, saved


def _port_scope(state):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(state, device="cpu"))
    return scope


@pytest.mark.parametrize("train", [True, False])
def test_crnn_programs_are_the_jax_programs(train):
    j = ocr.build_crnn_ctc(fluid, CFG, train=train)
    t = ocr.build_crnn_ctc(pt, CFG, train=train)
    for jp, tp in ((j.main, t.main), (j.startup, t.startup)):
        jd, td = jp.to_dict(), tp.to_dict()
        assert [b["ops"] for b in td["blocks"]] == [b["ops"] for b in jd["blocks"]]
        assert _vars(td) == _vars(jd)
    types = [op.type for op in t.main.global_block().ops]
    assert "im2sequence" in types and types.count("scan") == 2
    assert ("warpctc" in types) == train and ("ctc_align" in types) != train


def test_three_momentum_steps_match_jax(jax_runs):
    init, jlosses, jfinal, _, _, _, _ = jax_runs
    train = ocr.build_crnn_ctc(pt, CFG)
    scope = _port_scope(init)
    exe = pt.Executor(CPU)
    with pt.scope_guard(scope):
        losses = [float(np.asarray(exe.run(train.main, feed=ocr.crnn_feed(CFG, BATCH, s),
                                           fetch_list=[train.loss])[0]).reshape(()))
                  for s in range(3)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert np.isfinite(losses).all() and losses[0] > 0
    for n, want in jfinal.items():
        got = scope.find_var(n).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * max(np.abs(want).max(), 1e-3),
                                   err_msg=n)
    # the velocities moved: Momentum ran on every parameter
    moved = [n for n in jfinal if "velocity" in n and np.abs(jfinal[n]).max() > 0]
    assert len(moved) == len([n for n in jfinal if "velocity" in n]) > 0


def test_decode_and_edit_distance_match_jax(jax_runs):
    """The port's decode program on the JAX-trained weights: logits within
    rtol 1e-5, then ids, lengths and (normalised) edit distances exactly; and
    the port's ``ctc_align`` on the JAX logits equals the JAX decode."""
    _, _, _, state, feed, (jlogits, jdec, jlen, jdist), _ = jax_runs
    assert jlen.max() > 1 and len(set(jlen.tolist())) > 1, (jlen, jdec)
    dec = ocr.build_crnn_ctc(pt, CFG, train=False)
    with pt.scope_guard(_port_scope(state)):
        logits, decoded, length, dist = pt.Executor(CPU).run(
            dec.main, feed=feed, fetch_list=[dec.logits, dec.decoded, dec.decoded_length,
                                             dec.distance])
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-6)
    align = treg.get("ctc_align").lower(
        treg.LowerCtx({"blank": CFG.blank, "padding_value": 0}, "cpu"),
        {"Input": [torch.from_numpy(jlogits)],
         "InputLength": [torch.from_numpy(feed["logits_length"])]})
    np.testing.assert_array_equal(align["Output"][0].numpy(), jdec)
    np.testing.assert_array_equal(align["OutputLength"][0].numpy(), jlen)
    np.testing.assert_array_equal(np.asarray(decoded), jdec)
    np.testing.assert_array_equal(np.asarray(length), jlen)
    np.testing.assert_array_equal(np.asarray(dist), jdist)
    for b in range(BATCH):
        ref = feed["label"][b, :feed["label_length"][b]]
        want = ocr.levenshtein(jdec[b, :jlen[b]], ref) / max(len(ref), 1)
        assert np.float32(want) == dist[b, 0]


@pytest.mark.parametrize("normalized", [True, False])
def test_edit_distance_equals_jax_and_numpy_exactly(normalized):
    """Random id rows with lengths 0..T against the JAX lowering and the
    numpy Levenshtein, exactly."""
    rng = np.random.RandomState(3)
    B, T1, T2 = 16, 9, 7
    hyps, refs = rng.randint(0, 4, (B, T1)), rng.randint(0, 4, (B, T2))
    hl, rl = rng.randint(0, T1 + 1, B), rng.randint(0, T2 + 1, B)
    ins = {"Hyps": [hyps], "Refs": [refs], "HypsLength": [hl], "RefsLength": [rl]}
    attrs = {"normalized": normalized}
    want = np.asarray(jreg.get("edit_distance").lower(
        jreg.LowerCtx(attrs), {k: [np.asarray(v[0], "int32")] for k, v in ins.items()})["Out"][0])
    got = treg.get("edit_distance").lower(
        treg.LowerCtx(attrs, "cpu"),
        {k: [torch.from_numpy(np.asarray(v[0], "int64"))] for k, v in ins.items()})["Out"][0]
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(B):
        d = ocr.levenshtein(hyps[b, :hl[b]], refs[b, :rl[b]])
        assert got[b, 0].item() == np.float32(d / max(rl[b], 1) if normalized else d)


def test_an_infeasible_row_gives_the_jax_loss_near_1e30():
    """A label that cannot fit its steps ([1, 1, 1] in 4 steps needs 5) gives
    a loss near 1e30 in both packages, not inf; the feasible row beside it
    agrees too."""
    def prog(pkg):
        main, startup = pkg.Program(), pkg.Program()
        A = dict(append_batch_size=False)
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [-1, 4, 3], "float32", **A)
            y = pkg.data("y", [-1, 3], "int64", **A)
            xl = pkg.data("xl", [-1], "int64", **A)
            yl = pkg.data("yl", [-1], "int64", **A)
            loss = pkg.layers.warpctc(x, y, blank=0, input_length=xl, label_length=yl)
        return main, loss
    feed = {"x": np.random.RandomState(0).randn(2, 4, 3).astype("float32"),
            "y": np.array([[1, 1, 1], [1, 2, 0]], "int64"), "xl": np.array([4, 4], "int64"),
            "yl": np.array([3, 2], "int64")}
    jm, jl = prog(fluid)
    want = np.asarray(fluid.Executor().run(jm, feed=feed, fetch_list=[jl])[0])
    tm, tl = prog(pt)
    got = pt.Executor(CPU).run(tm, feed=feed, fetch_list=[tl])[0]
    assert np.isfinite(got).all() and 1e29 < got[0, 0] < 1e31
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert 0 < got[1, 0] < 100


def test_a_jax_saved_crnn_serves_in_the_port(jax_runs):
    """The JAX-saved decode program (``edit_distance`` pruned away) loads in
    the port's Predictor, which runs the GRUs' scans through its block
    runner, and decodes as the JAX executor did, at batch 4 and 1."""
    from paddle_tpu_torch.inference import Predictor
    _, _, _, _, feed, (_, jdec, jlen, _), saved = jax_runs
    pred = Predictor(saved, device="cpu")
    types = {op.type for op in pred.program.global_block().ops}
    assert "scan" in types and "edit_distance" not in types
    ids, lens = pred.run({"pixel": feed["pixel"], "logits_length": feed["logits_length"]})
    np.testing.assert_array_equal(ids, jdec)
    np.testing.assert_array_equal(lens, jlen)
    one, one_len = pred.run({"pixel": feed["pixel"][1:2],
                             "logits_length": feed["logits_length"][1:2]})
    np.testing.assert_array_equal(one, jdec[1:2])
    np.testing.assert_array_equal(one_len, jlen[1:2])


def _gru_program(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [-1, 5, 6], "float32", append_batch_size=False)
        h = pkg.layers.dynamic_gru(x, 3, candidate_activation="relu")
    return main, startup, h


def test_3_28_dynamic_gru_applies_tanh_where_the_source_asks_relu_in_both_packages():
    """ROADMAP 3.28: ``candidate_activation='relu'`` (crnn_ctc_model.py's
    encoder) is taken and not used: the candidate goes through tanh in both
    packages. Held by the ops the layer builds and by a numpy GRU with tanh
    on the JAX weights."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 6).astype("float32")
    jm, js, jh = _gru_program(fluid)
    tm, _, th = _gru_program(pt)
    for prog in (jm, tm):
        body = [op.type for op in prog.blocks[1].ops]
        assert "tanh" in body and "relu" not in body, body
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(js)
        state = {n: np.asarray(scope.find_var(n)) for n in _persistables(jm)}
        want = np.asarray(exe.run(jm, feed={"x": x}, fetch_list=[jh])[0])
    with pt.scope_guard(_port_scope(state)):
        got = pt.Executor(CPU).run(tm, feed={"x": x}, fetch_list=[th])[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the two fc layers of gru_unit: [x, h] -> 2H (sigmoid), [x, r*h] -> H (tanh)
    ws = [state[n] for n in _persistables(jm) if n.endswith(".w_0")]
    bs = [state[n] for n in _persistables(jm) if n.endswith(".b_0")]
    (w1, w2), (b1, b2) = ws, bs
    sig = lambda v: 1 / (1 + np.exp(-v))
    h = np.zeros((2, 3), "float64")
    for t in range(5):
        zr = sig(np.concatenate([x[:, t], h], 1) @ w1 + b1)
        z, r = zr[:, :3], zr[:, 3:]
        cand = np.tanh(np.concatenate([x[:, t], r * h], 1) @ w2 + b2)
        h = z * h + (1 - z) * cand
        np.testing.assert_allclose(got[:, t], h, rtol=1e-4, atol=1e-5)
