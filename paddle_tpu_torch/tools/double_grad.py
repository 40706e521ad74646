"""Second-order gradients as a Program builds them: the 12 op cases of the
JAX package's double-gradient checks and its gradient-penalty objective.

    from paddle_tpu_torch.tools import double_grad
    values = double_grad.run("conv2d", "cpu")        # [obj, d obj / d each input]

``CASES`` holds the op cases of ``tests/test_double_grad.py`` (mul,
matmul, conv2d, tanh, sigmoid, relu, leaky_relu, square, elementwise_mul,
softmax, layer_norm, batch_norm) with their inputs drawn from the same
seeds. ``build(pkg, name)`` builds a case's program in ``pkg`` (this
package, or the JAX package in the tests) as ``OpTest.check_double_grad``
builds it: the op over data variables, ``mean`` of the output, a first
``gradients`` pass, the objective sum(grad * v) over a fixed random v for
each checked input, and a second ``gradients`` pass of that objective, so
that every grad op of the first pass gets its ``<type>_grad_grad``.
``run`` runs a case's program on a device and returns the objective and
the second-order gradients as numpy.

``build_dropout(pkg)`` takes a second order through ``dropout``, whose
closed form holds the forward's own mask (``dropout_gaps``);
``attention_case`` and ``conv_bn_case`` are the kernels' ops, through which
a second order raises (on the card, and for K2 on both devices).

``build_penalty(pkg)`` is the WGAN-GP objective of
``test_double_grad.py::test_gradient_penalty_trains``: a critic MLP (8 ->
16 tanh -> 1), loss + 10 * mean((|d loss / d x| - 1)^2), minimised by
``Adam(0.01)``; the optimizer's backward pass differentiates through the
first ``gradients`` pass. ``penalty_feed()`` is that test's batch.

Tolerances (``tol``): float32 ``1e-5`` relative and absolute, ``1e-4`` for
conv2d, the norms and the products, whose sums run in other orders on the
two sides (the limits of ROADMAP's op probes, fault 3.1).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

F32 = 1e-5
SUMS = 1e-4


class DoubleGradCase(NamedTuple):
    op: str
    inputs: Dict[str, np.ndarray]
    outputs: Tuple[str, ...]      # the op's output slots
    attrs: dict
    check: Tuple[str, ...]        # the inputs differentiated twice
    output: str                   # the output the mean is taken of
    tol: float


def _rng(seed):
    return np.random.RandomState(seed)


def _cases() -> Dict[str, DoubleGradCase]:
    c: Dict[str, DoubleGradCase] = {}
    r = _rng(0)
    c["mul"] = DoubleGradCase("mul", {"X": r.randn(4, 5).astype("float32"),
                                      "Y": r.randn(5, 3).astype("float32")},
                              ("Out",), {}, ("X", "Y"), "Out", SUMS)
    r = _rng(1)
    c["matmul"] = DoubleGradCase("matmul", {"X": r.randn(2, 4, 5).astype("float32"),
                                            "Y": r.randn(2, 5, 3).astype("float32")},
                                 ("Out",), {}, ("X", "Y"), "Out", SUMS)
    r = _rng(2)
    c["conv2d"] = DoubleGradCase(
        "conv2d", {"Input": r.randn(2, 3, 6, 6).astype("float32"),
                   "Filter": r.randn(4, 3, 3, 3).astype("float32")},
        ("Output",), {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
                      "groups": 1}, ("Input", "Filter"), "Output", SUMS)
    c["tanh"] = DoubleGradCase("tanh", {"X": np.linspace(-2, 2, 12).reshape(3, 4)
                                        .astype("float32")}, ("Out",), {}, ("X",), "Out", F32)
    c["sigmoid"] = DoubleGradCase("sigmoid", {"X": np.linspace(-3, 3, 12).reshape(3, 4)
                                              .astype("float32")}, ("Out",), {}, ("X",),
                                  "Out", F32)
    x = _rng(3).randn(3, 4).astype("float32")
    x[np.abs(x) < 0.3] = 0.5
    c["relu"] = DoubleGradCase("relu", {"X": x}, ("Out",), {}, ("X",), "Out", F32)
    x = _rng(4).randn(3, 4).astype("float32")
    x[np.abs(x) < 0.3] = -0.6
    c["leaky_relu"] = DoubleGradCase("leaky_relu", {"X": x}, ("Out",), {"alpha": 0.02},
                                     ("X",), "Out", F32)
    c["square"] = DoubleGradCase("square", {"X": _rng(5).randn(3, 4).astype("float32")},
                                 ("Out",), {}, ("X",), "Out", F32)
    r = _rng(6)
    c["elementwise_mul"] = DoubleGradCase(
        "elementwise_mul", {"X": r.randn(3, 4).astype("float32"),
                            "Y": r.randn(3, 4).astype("float32")},
        ("Out",), {}, ("X", "Y"), "Out", F32)
    c["softmax"] = DoubleGradCase("softmax", {"X": _rng(7).randn(3, 5).astype("float32")},
                                  ("Out",), {}, ("X",), "Out", F32)
    r = _rng(8)
    c["layer_norm"] = DoubleGradCase(
        "layer_norm", {"X": r.randn(4, 6).astype("float32"),
                       "Scale": (r.rand(6) + 0.5).astype("float32"),
                       "Bias": r.randn(6).astype("float32")},
        ("Y", "Mean", "Variance"), {"epsilon": 1e-5, "begin_norm_axis": 1},
        ("X", "Scale"), "Y", SUMS)
    r = _rng(9)
    c["batch_norm"] = DoubleGradCase(
        "batch_norm", {"X": r.randn(4, 3, 2, 2).astype("float32"),
                       "Scale": (r.rand(3) + 0.5).astype("float32"),
                       "Bias": r.randn(3).astype("float32"),
                       "Mean": np.zeros(3, "float32"), "Variance": np.ones(3, "float32")},
        ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
        {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NCHW"}, ("X", "Scale"), "Y", SUMS)
    return c


CASES = _cases()


def build(pkg, name):
    """Case ``name``'s program in ``pkg`` (``name`` a key of ``CASES`` or a
    ``DoubleGradCase``), as ``OpTest.check_double_grad`` builds it.
    Returns (main, feed, fetch names: the objective, then the second-order
    gradient of each checked input)."""
    c = CASES[name] if isinstance(name, str) else name
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        block = main.global_block()
        feed = {}
        for slot, arr in c.inputs.items():
            block.create_var(slot, arr.shape, str(arr.dtype), is_data=True).stop_gradient = False
            feed[slot] = arr
        block.append_op(c.op, inputs={s: [s] for s in c.inputs},
                        outputs={s: [s + "@OUT"] for s in c.outputs}, attrs=dict(c.attrs))
        block.create_var("mean@OUT", (1,), "float32")
        block.append_op("mean", inputs={"X": [c.output + "@OUT"]},
                        outputs={"Out": ["mean@OUT"]})
        xs = [block.var(n) for n in c.check]
        first = pkg.gradients([block.var("mean@OUT")], xs)
        rng = np.random.RandomState(0)
        terms = []
        for n, g in zip(c.check, first):
            v = rng.randn(*c.inputs[n].shape).astype("float32")
            block.create_var(f"v_{n}", v.shape, "float32", is_data=True).stop_gradient = True
            feed[f"v_{n}"] = v
            block.create_var(f"gv_{n}", v.shape, "float32")
            block.append_op("elementwise_mul", inputs={"X": [g.name], "Y": [f"v_{n}"]},
                            outputs={"Out": [f"gv_{n}"]})
            block.create_var(f"obj_{n}", (1,), "float32")
            block.append_op("reduce_sum", inputs={"X": [f"gv_{n}"]},
                            outputs={"Out": [f"obj_{n}"]},
                            attrs={"dim": None, "keep_dim": False, "reduce_all": True})
            terms.append(f"obj_{n}")
        obj = terms[0]
        if len(terms) > 1:
            block.create_var("obj2@OUT", (1,), "float32")
            block.append_op("sum", inputs={"X": terms}, outputs={"Out": ["obj2@OUT"]})
            obj = "obj2@OUT"
        second = pkg.gradients([block.var(obj)], xs)
    return main, feed, [obj] + [g.name for g in second]


def attention_case(impl: str) -> DoubleGradCase:
    """``fused_attention`` over Q, K, V [1, 2, 128, 32] (no bias, dropout
    0) with ``impl``: the JAX package's Pallas route takes it (S a multiple
    of its block), its composed route and the port's plain one are
    differentiable twice."""
    rng = np.random.RandomState(12)
    q, k, v = (rng.randn(1, 2, 128, 32).astype("float32") * 0.5 for _ in range(3))
    return DoubleGradCase("fused_attention", {"Q": q, "K": k, "V": v}, ("Out",),
                          {"scale": 0.0, "dropout_prob": 0.0, "causal": False, "impl": impl},
                          ("Q", "K", "V"), "Out", SUMS)


def conv_bn_case() -> DoubleGradCase:
    """``conv2d_bn_fused`` at a shape inside the JAX kernel's gate (M = 7 x 8
    x 8 = 448, N 128), so the JAX op takes its Pallas kernel."""
    rng = np.random.RandomState(13)
    return DoubleGradCase(
        "conv2d_bn_fused",
        {"Input": rng.randn(7, 8, 8, 64).astype("float32"),
         "Filter": (rng.randn(128, 64, 1, 1) * 0.1).astype("float32"),
         "Scale": (rng.rand(128) + 0.5).astype("float32"),
         "Bias": rng.randn(128).astype("float32"),
         "Mean": np.zeros(128, "float32"), "Variance": np.ones(128, "float32")},
        ("Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"),
        {"epsilon": 1e-5, "momentum": 0.9}, ("Input", "Filter"), "Y", SUMS)


def run(name: str, device) -> List[np.ndarray]:
    """Case ``name`` on ``device`` ("cpu" or "cuda") through the port's
    executor: [objective, second-order gradient of each checked input]."""
    import paddle_tpu_torch as pt
    main, feed, fetch = build(pt, name)
    exe = pt.Executor(pt.CPUPlace() if str(device) == "cpu" else device)
    with pt.scope_guard(pt.Scope()):
        out = exe.run(main, feed=feed, fetch_list=fetch)
    exe.close()
    return out


def build_dropout(pkg, p=0.5):
    """Second order through ``dropout`` (upscale_in_train): y = dropout(x),
    g = d sum(y^2) / dx = 2 y Mask / (1 - p), h = d sum(g v) / dx = 2 Mask^2
    / (1 - p)^2 v with the forward's own Mask. Returns (main, fetch names
    [y, g, h, Mask]); ``dropout_feed()`` is its feed."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    layers = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [64], "float32")
        x.stop_gradient = False
        y = layers.dropout(x, p, dropout_implementation="upscale_in_train")
        g, = pkg.gradients([layers.reduce_sum(layers.square(y))], [x])
        v = pkg.data("v", [64], "float32")
        h, = pkg.gradients([layers.reduce_sum(layers.elementwise_mul(g, v))], [x])
    mask = next(op for op in main.global_block().ops if op.type == "dropout").output("Mask")[0]
    return main, [y.name, g.name, h.name, mask]


def dropout_feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(2, 64).astype("float32"), "v": rng.randn(2, 64).astype("float32")}


def dropout_gaps(y, g, h, mask, v, p=0.5):
    """The largest relative gap of g and h from their closed forms over the
    fetched Mask."""
    rel = lambda a, b: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    return rel(g, 2 * y * mask / (1 - p)), rel(h, 2 * mask * mask / (1 - p) ** 2 * v)


#: test_double_grad.py::test_gradient_penalty_trains
PENALTY_SEED, PENALTY_WEIGHT, PENALTY_LR, PENALTY_BATCH = 11, 10.0, 0.01, 32


def build_penalty(pkg):
    """The WGAN-GP objective: (main, startup, total, penalty)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = PENALTY_SEED
    layers = pkg.layers
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [8], "float32")
        h = layers.fc(x, 16, act="tanh")
        score = layers.fc(h, 1)
        d_loss = layers.mean(score)
        gx, = pkg.gradients([d_loss], [x])
        gnorm = layers.sqrt(layers.reduce_sum(layers.square(gx), dim=1) + 1e-8)
        penalty = layers.mean(layers.square(gnorm - 1.0))
        total = layers.elementwise_add(d_loss, layers.scale(penalty, scale=PENALTY_WEIGHT))
        pkg.optimizer.Adam(PENALTY_LR).minimize(total)
    return main, startup, total, penalty


def penalty_feed():
    return {"x": np.random.RandomState(0).randn(PENALTY_BATCH, 8).astype("float32")}
