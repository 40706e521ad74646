"""The CTR and MNIST slice of the port on the CPU: the ops DeepFM, the
MNIST MLP and the clip classes add (and their grads), the ``auc`` metric,
``sgd``, and training steps of a tiny DeepFM and of the MNIST models, each
held against the JAX package on the same numpy inputs
(tests/test_torch_clip.py holds the clip classes and the regularizers).

Tolerances. Op lowerings in float32: ``atol 1e-6, rtol 1e-5``, the
reductions (``squared_l2_norm``, ``clip_by_norm``'s norm, the normalized
loss) ``1e-5``: they sum in another order; the grads ``atol 1e-5, rtol
1e-5`` (as tests/test_torch_grad.py). ``sgd`` and the ``auc`` histograms bit
for bit: the same f32 operations, and whole counts. The AUC value ``rtol
1e-6``: a float32 sum of 4096 trapezoids in another order. Training in
float32, 3 steps: losses ``rtol 1e-5``, the AUC ``atol 1e-6``, every state
tensor ``atol 5e-5`` (Adam) or ``1e-6`` (SGD, whose update is lr times the
gradient): the frameworks sum in other orders (about 1e-6 a step), and
Adam's early updates divide by sqrt(v), about |grad|, so a grad's rounding
moves a small parameter's update by up to that much relative to the
learning rate (as tests/test_torch_training.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.models import mnist as jmnist
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.models import mnist as tmnist
from tests.test_torch_graph_step import stand_in  # noqa: F401  (the fixture)

TOL = dict(atol=1e-6, rtol=1e-5)
SUM_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
EXACT = dict(atol=0, rtol=0)


def _r(*shape, scale=1.0, seed=None):
    seed = sum(shape) if seed is None else seed
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale, "float32")


def _ids(shape, hi, seed=1):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


def _probs(n, c, seed=3):
    p = np.abs(_r(n, c, seed=seed)) + 0.05
    return (p / p.sum(-1, keepdims=True)).astype("float32")


def _labels01(shape, seed=4):
    return np.random.RandomState(seed).randint(0, 2, shape).astype("float32")


# id -> (op type, inputs, attrs, output slots whose float grads are held, tolerance)
CASES = {
    "sigmoid": ("sigmoid", {"X": [_r(4, 7, scale=4.0)]}, {}, ("Out",), TOL),
    "square": ("square", {"X": [_r(3, 5)]}, {}, ("Out",), TOL),
    "sqrt": ("sqrt", {"X": [np.abs(_r(6, 2)) + 0.1]}, {}, ("Out",), TOL),
    "sign": ("sign", {"X": [np.array([-2.5, 0.0, 3.0, -0.0, 1e-30], "float32")]}, {}, (),
             EXACT),
    "concat-axis1": ("concat", {"X": [_r(4, 3), _r(4, 5, seed=2), _r(4, 1, seed=3)]},
                     {"axis": 1}, ("Out",), TOL),
    "concat-axis0": ("concat", {"X": [_r(2, 3, 2), _r(5, 3, 2, seed=9)]}, {"axis": 0},
                     ("Out",), TOL),
    "concat-negative-axis": ("concat", {"X": [_r(2, 3), _r(2, 4, seed=5)]}, {"axis": -1},
                             ("Out",), TOL),
    "sigmoid_ce": ("sigmoid_cross_entropy_with_logits",
                   {"X": [_r(8, 1, scale=5.0)], "Label": [_labels01((8, 1))]},
                   {"ignore_index": -100, "normalize": False}, ("Out",), TOL),
    "sigmoid_ce-large-logits": ("sigmoid_cross_entropy_with_logits",
                                {"X": [np.array([[-80.0], [-3.0], [0.0], [3.0], [90.0]],
                                                "float32")],
                                 "Label": [np.array([[1], [0], [1], [1], [0]], "float32")]},
                                {}, ("Out",), TOL),
    "sigmoid_ce-ignore-normalize": ("sigmoid_cross_entropy_with_logits",
                                    {"X": [_r(6, 3, scale=2.0)],
                                     "Label": [np.array([[0, 1, 2], [1, 2, 0], [2, 2, 1],
                                                         [0, 0, 1], [1, 1, 1], [2, 0, 0]],
                                                        "float32")]},
                                    {"ignore_index": 2, "normalize": True}, ("Out",), SUM_TOL),
    "cross_entropy-hard": ("cross_entropy", {"X": [_probs(6, 5)], "Label": [_ids((6, 1), 5)]},
                           {"soft_label": False}, ("Y",), TOL),
    "cross_entropy-hard-ignore": ("cross_entropy",
                                  {"X": [_probs(6, 5)],
                                   "Label": [np.array([[0], [3], [3], [1], [4], [3]], "int64")]},
                                  {"soft_label": False, "ignore_index": 3}, ("Y",), TOL),
    "cross_entropy-soft": ("cross_entropy", {"X": [_probs(4, 6)], "Label": [_probs(4, 6, 8)]},
                           {"soft_label": True}, ("Y",), SUM_TOL),
    "clip": ("clip", {"X": [np.array([[-2.0, -0.5, 0.0], [0.5, 0.7, 3.0]], "float32")]},
             {"min": -0.5, "max": 0.7}, ("Out",), TOL),
    "clip-random": ("clip", {"X": [_r(5, 4)]}, {"min": -0.3, "max": 0.6}, ("Out",), TOL),
    "clip_by_norm-clipped": ("clip_by_norm", {"X": [_r(4, 6)]}, {"max_norm": 1.0}, ("Out",),
                             SUM_TOL),
    "clip_by_norm-kept": ("clip_by_norm", {"X": [_r(4, 6, scale=0.01)]}, {"max_norm": 1.0},
                          ("Out",), SUM_TOL),
    "squared_l2_norm": ("squared_l2_norm", {"X": [_r(7, 9)]}, {}, ("Out",), SUM_TOL),
    "elementwise_max": ("elementwise_max", {"X": [_r(3, 4)], "Y": [_r(3, 4, seed=11)]},
                        {"axis": -1}, ("Out",), TOL),
    "elementwise_max-broadcast": ("elementwise_max", {"X": [_r(2, 3, 4)], "Y": [_r(4)]},
                                  {"axis": -1}, ("Out",), TOL),
    "elementwise_max-one": ("elementwise_max", {"X": [np.array([0.5], "float32")],
                                                "Y": [np.array([1.0], "float32")]},
                            {"axis": -1}, ("Out",), TOL),
    "sgd": ("sgd", {"Param": [_r(5, 3)], "Grad": [_r(5, 3, seed=6)],
                    "LearningRate": [np.array([0.01], "float32")]}, {}, (), EXACT),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 else x.detach().numpy()
    return np.asarray(x)


def _lower(reg, arr, op_type, ins, attrs):
    return reg.get(op_type).lower(reg.LowerCtx(dict(attrs)),
                                  {s: [arr(a) for a in v] for s, v in ins.items()})


def _grad_inputs(ins, attrs, jouts, cot_slots):
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
    """Forward outputs and, for a float op, the generic grad of every float
    input (the same registration: which slots carry a gradient)."""
    op_type, ins, attrs, cot_slots, tol = CASES[case]
    assert treg.get(op_type).grad == jreg.get(op_type).grad
    assert treg.get(op_type).nondiff_inputs == jreg.get(op_type).nondiff_inputs
    jouts = _lower(jreg, jnp.asarray, op_type, ins, attrs)
    touts = _lower(treg, lambda a: torch.from_numpy(np.array(a)), op_type, ins, attrs)
    compared = 0
    for slot, tvals in touts.items():
        for j, t in zip(jouts[slot], tvals):
            a, b = _np(j), _np(t)
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            assert a.dtype.kind == b.dtype.kind, (slot, a.dtype, b.dtype)
            np.testing.assert_allclose(b, a, err_msg=f"{case} {slot}", **tol)
            compared += 1
    assert compared >= 1
    if not cot_slots:
        return
    gins, gattrs = _grad_inputs(ins, attrs, jouts, cot_slots)
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


def test_sgd_keeps_a_bf16_parameter_bf16():
    """The update computes in f32 and rounds ParamOut back to the
    parameter's dtype, as the JAX lowering does."""
    p = _r(4, 8)
    ins = {"Param": [torch.from_numpy(p).bfloat16()], "Grad": [torch.from_numpy(_r(4, 8, seed=3))],
           "LearningRate": [torch.tensor([0.5])]}
    out = treg.get("sgd").lower(treg.LowerCtx({}), ins)["ParamOut"][0]
    ref = _lower(jreg, jnp.asarray, "sgd", {"Param": [jnp.asarray(p, jnp.bfloat16)],
                                             "Grad": [_r(4, 8, seed=3)],
                                             "LearningRate": [np.array([0.5], "float32")]}, {})
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(ref["ParamOut"][0], "float32"))


# -- auc -------------------------------------------------------------------------------------

def _auc_inputs(n=600, nt=4095, seed=0):
    """Predictions spread over [0, 1] with exact bucket edges, 0 and 1 among
    them; labels in {0, 1}; histograms that already hold counts."""
    rng = np.random.RandomState(seed)
    p = rng.rand(n).astype("float32")
    p[:5] = [0.0, 1.0, 1.0 / nt, 2048.0 / nt, 0.5]
    pred = np.stack([1 - p, p], 1).astype("float32")
    label = rng.randint(0, 2, (n, 1)).astype("int64")
    pos = rng.randint(0, 3, nt + 1).astype("float32")
    neg = rng.randint(0, 3, nt + 1).astype("float32")
    return {"Predict": [pred], "Label": [label], "StatPos": [pos], "StatNeg": [neg]}


@pytest.mark.parametrize("nt", [4095, 200])
def test_auc_histograms_equal_jax_on_a_shared_predict(nt):
    ins = _auc_inputs(nt=nt)
    attrs = {"num_thresholds": nt}
    j = _lower(jreg, jnp.asarray, "auc", ins, attrs)
    t = _lower(treg, lambda a: torch.from_numpy(np.array(a)), "auc", ins, attrs)
    for slot in ("StatPosOut", "StatNegOut"):
        np.testing.assert_array_equal(_np(t[slot][0]), _np(j[slot][0]), err_msg=slot)
        assert t[slot][0].dtype == torch.float32
    added = _np(t["StatPosOut"][0]).sum() + _np(t["StatNegOut"][0]).sum() \
        - ins["StatPos"][0].sum() - ins["StatNeg"][0].sum()
    assert added == len(ins["Label"][0])
    assert t["AUC"][0].dtype == torch.float64 and tuple(t["AUC"][0].shape) == (1,)
    np.testing.assert_allclose(_np(t["AUC"][0]), _np(j["AUC"][0]).astype(np.float64),
                               rtol=1e-6)


def test_auc_of_fresh_histograms_is_the_bucketed_rank_statistic():
    """From empty histograms the AUC is the Mann-Whitney statistic of the
    bucket indices (pairs in one bucket count a half)."""
    ins = _auc_inputs(n=400, seed=3)
    nt = 4095
    ins["StatPos"] = [np.zeros(nt + 1, "float32")]
    ins["StatNeg"] = [np.zeros(nt + 1, "float32")]
    t = _lower(treg, lambda a: torch.from_numpy(np.array(a)), "auc", ins,
               {"num_thresholds": nt})
    p, lab = ins["Predict"][0][:, 1], ins["Label"][0][:, 0]
    b = np.clip((p * np.float32(nt)).astype(np.int32), 0, nt)
    bp, bn = b[lab > 0], b[lab == 0]
    pairs = (bp[:, None] > bn[None, :]).sum() + 0.5 * (bp[:, None] == bn[None, :]).sum()
    np.testing.assert_allclose(_np(t["AUC"][0]), pairs / (len(bp) * len(bn)), rtol=1e-6)


# -- the tiny DeepFM --------------------------------------------------------------------------

FIELDS, VOCAB, EMBED, DENSE, BATCH = 8, 1000, 8, 4, 16


def _deepfm(pkg, model, opt=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 2
    startup.random_seed = 2
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data("ids", [FIELDS], "int64")
        dense = pkg.data("dense", [DENSE], "float32")
        label = pkg.data("label", [1], "int64")
        loss, auc, prob = model.deepfm(ids, dense, label, num_fields=FIELDS, vocab_size=VOCAB,
                                       embed_dim=EMBED, hidden=(32, 32))
        _, params_grads = (opt or pkg.optimizer.Adam(0.01)).minimize(loss)
    return main, startup, loss, auc, prob, params_grads


def _deepfm_feeds(seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    return {"ids": rng.randint(0, VOCAB, (batch, FIELDS)).astype("int64"),
            "dense": rng.randn(batch, DENSE).astype("float32"),
            "label": rng.randint(0, 2, (batch, 1)).astype("int64")}


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


@pytest.fixture(scope="module")
def deepfm_programs():
    return _deepfm(fluid, jdeepfm), _deepfm(pt, tdeepfm)


def test_deepfm_program_matches_jax(deepfm_programs):
    """The same ops (types, slots, attrs) in order, the same (param, grad)
    pairs and the same persistable state, the AUC histograms among it."""
    (jm, *_, jpg), (tm, *_, tpg) = deepfm_programs
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]
    assert [(p.name, g.name) for p, g in tpg] == [(p.name, g.name) for p, g in jpg]
    assert _persistables(tm) == _persistables(jm)
    hist = [n for n in _persistables(tm) if n.startswith("auc")]
    assert len(hist) == 2 and all(tm.global_block().var(n).shape == (4096,) for n in hist)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("lookup_table_v2_grad") == 2 and types.count("adam") == len(tpg)


def _train_jax(main, startup, fetch, feeds, steps, names):
    exe = fluid.Executor()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        outs = [[np.asarray(v) for v in exe.run(main, feed=f, fetch_list=fetch)]
                for f in feeds[:steps]]
        final = {n: np.asarray(scope.find_var(n)) for n in names}
    return init, outs, final


def _train_port(main, fetch, feeds, steps, init, exe=None):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
    exe = exe or pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        outs = [exe.run(main, feed=f, fetch_list=fetch) for f in feeds[:steps]]
    return outs, scope


def test_three_adam_steps_of_the_tiny_deepfm_match_jax(deepfm_programs):
    """Losses, the AUC and every state tensor (tables, tower, Adam's
    accumulators, the AUC histograms) after 3 steps on two batches, from
    the JAX startup state carried across with ``convert.state_from_numpy``;
    ids fed as int64 to both (the JAX package computes them as int32)."""
    (jm, js, jl, ja, _, _), (tm, _, tl, ta, _, _) = deepfm_programs
    feeds = [_deepfm_feeds(0), _deepfm_feeds(1), _deepfm_feeds(0)]
    names = _persistables(jm)
    init, jouts, jfinal = _train_jax(jm, js, [jl, ja], feeds, 3, names)
    touts, tscope = _train_port(tm, [tl, ta], feeds, 3, init)
    np.testing.assert_allclose([o[0] for o in touts], [o[0] for o in jouts], rtol=1e-5)
    np.testing.assert_allclose([o[1] for o in touts], [o[1] for o in jouts], atol=1e-6)
    assert all(o[1].dtype == np.float64 for o in touts)
    for n in names:
        got = tscope.find_var(n)
        assert tuple(got.shape) == jfinal[n].shape, n
        tol = EXACT if n.startswith("auc") else dict(atol=5e-5)
        np.testing.assert_allclose(got.numpy(), jfinal[n], err_msg=n, **tol)
    hist = sum(float(tscope.find_var(n).sum()) for n in names if n.startswith("auc"))
    assert hist == 3 * BATCH


def test_the_deepfm_histograms_persist_through_the_captured_step(deepfm_programs,
                                                                  stand_in):
    """Five steps through the executor's cache (warm-up, capture + replay,
    replays; the stand-in graph of tests/test_torch_graph_step.py) against
    five eager steps: losses, AUCs and every state tensor bit for bit, and
    the histograms hold every batch the steps took."""
    _, (tm, ts, tl, ta, _, _) = deepfm_programs
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(ts)
    init = {n: scope.find_var(n).clone() for n in _persistables(tm)}
    feed = _deepfm_feeds(0)
    runs = {}
    for graphs in (True, False):
        exe = pt.Executor(pt.CPUPlace())
        exe._use_graphs = graphs
        sc = pt.Scope()
        for n, t in init.items():
            sc.set_var(n, t.clone())
        with pt.scope_guard(sc):
            outs = [exe.run(tm, feed=feed, fetch_list=[tl, ta], return_numpy=False)
                    for _ in range(5)]
        runs[graphs] = (outs, sc)
    assert stand_in.captures == 1
    (g, gs), (e, es) = runs[True], runs[False]
    for a, b in zip(g, e):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert [n for n in init if not torch.equal(gs.find_var(n), es.find_var(n))] == []
    hist = [n for n in init if n.startswith("auc")]
    assert sum(float(gs.find_var(n).sum()) for n in hist) == 5 * BATCH


def test_a_jax_saved_deepfm_serves_in_the_port(deepfm_programs, tmp_path):
    """``save_inference_model`` of the trained tiny DeepFM in the JAX package
    (ids and dense fed, prob fetched: the loss and ``auc`` pruned away)
    loads in the port's Predictor on the CPU and answers as the JAX
    Predictor does."""
    from paddle_tpu.inference import Predictor as JPredictor
    from paddle_tpu_torch.inference import Predictor
    (jm, js, jl, _, jp, _), _ = deepfm_programs
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(js)
        exe.run(jm, feed=_deepfm_feeds(0), fetch_list=[jl])
        fluid.io.save_inference_model(str(tmp_path), ["ids", "dense"], [jp], exe,
                                      main_program=jm)
    pred = Predictor(str(tmp_path), device="cpu")
    assert {op.type for op in pred.program.global_block().ops}.isdisjoint(
        {"auc", "sigmoid_cross_entropy_with_logits", "adam"})
    for batch in (16, 3):
        f = _deepfm_feeds(5, batch)
        feed = {"ids": f["ids"], "dense": f["dense"]}
        got, = pred.run(feed)
        want, = JPredictor(str(tmp_path)).run(feed)
        assert got.shape == (batch, 1)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


# -- the MNIST MLP ------------------------------------------------------------------------------

IMG = 784


def _mlp_feeds(seed=0, batch=32):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(batch, IMG).astype("float32"),
            "label": rng.randint(0, 10, (batch, 1)).astype("int64")}


def test_three_sgd_steps_of_the_mnist_mlp_match_jax():
    """The MNIST MLP (784 -> 128 -> 64 -> 10, relu, softmax cross-entropy,
    accuracy) with ``SGD(0.01)``: losses, accuracies and every parameter
    after 3 steps on 3 batches."""
    def build(pkg, model):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 0
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            img = pkg.data("img", [IMG], "float32")
            label = pkg.data("label", [1], "int64")
            loss, acc, _ = model.mlp(img, label)
            pkg.optimizer.SGD(0.01).minimize(loss)
        return main, startup, loss, acc
    jm, js, jl, ja = build(fluid, jmnist)
    tm, _, tl, ta = build(pt, tmnist)
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]
    feeds = [_mlp_feeds(i, 64) for i in range(3)]
    names = _persistables(jm)
    init, jouts, jfinal = _train_jax(jm, js, [jl, ja], feeds, 3, names)
    touts, tscope = _train_port(tm, [tl, ta], feeds, 3, init)
    np.testing.assert_allclose([o[0] for o in touts], [o[0] for o in jouts], rtol=1e-5)
    np.testing.assert_array_equal([o[1] for o in touts], [o[1] for o in jouts])
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=1e-6, err_msg=n)


def test_the_mnist_conv_net_trains_like_jax():
    """``conv_net`` (two conv + pool stages) on 28 x 28 images: one SGD
    step's loss and parameters."""
    def build(pkg, model):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 0
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            img = pkg.data("img", [1, 28, 28], "float32")
            label = pkg.data("label", [1], "int64")
            loss, _, _ = model.conv_net(img, label)
            pkg.optimizer.SGD(0.01).minimize(loss)
        return main, startup, loss
    jm, js, jl = build(fluid, jmnist)
    tm, _, tl = build(pt, tmnist)
    rng = np.random.RandomState(0)
    feed = {"img": rng.rand(4, 1, 28, 28).astype("float32"),
            "label": rng.randint(0, 10, (4, 1)).astype("int64")}
    names = _persistables(jm)
    init, jouts, jfinal = _train_jax(jm, js, [jl], [feed], 1, names)
    touts, tscope = _train_port(tm, [tl], [feed], 1, init)
    np.testing.assert_allclose(touts[0][0], jouts[0][0], rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=1e-6, err_msg=n)
