"""The layers that wrap the dense op families (``layers/nn.py``,
``layers/tensor.py`` and the dense functions of ``layers/extras.py``):
each built in both packages from the same data variables, under
``unique_name.guard()``, gives the same ops (types, slots, attrs, names)
and, run on the same feed, the same values (f32 ``atol 1e-5, rtol 1e-5``;
integers by value, since the JAX package runs with x64 off). The random
layers are compared by their program and their shapes only: the two
packages draw with other generators.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt

TOL = dict(atol=1e-5, rtol=1e-5)
_rng = np.random.RandomState(11)
FEED = {
    "x": _rng.uniform(-0.9, 0.9, (3, 4)).astype("float32"),
    "y": _rng.uniform(-0.9, 0.9, (3, 4)).astype("float32"),
    "pos": _rng.uniform(0.2, 2.0, (3, 4)).astype("float32"),
    "prob": _rng.uniform(0.05, 0.95, (3, 4)).astype("float32"),
    "img": _rng.randn(2, 3, 4, 5).astype("float32"),
    "w": _rng.randn(4, 2).astype("float32"),
    "vec": _rng.randn(4).astype("float32"),
    "lab": np.array([[0], [3], [2]], "int64"),
    "ids": np.array([[1], [7], [12]], "int64"),
    "rows": np.array([2, 0], "int64"),
    "upd": _rng.randn(2, 4).astype("float32"),
    "nd": np.array([[1, 2], [0, 3], [1, 2]], "int64"),
    "ndupd": _rng.randn(3).astype("float32"),
    "one": np.ones((1, 4), "float32"),
}
SHAPES = {"x": [3, 4], "y": [3, 4], "pos": [3, 4], "prob": [3, 4], "img": [2, 3, 4, 5],
          "w": [4, 2], "vec": [4], "lab": [3, 1], "ids": [3, 1], "rows": [2], "upd": [2, 4],
          "nd": [3, 2], "ndupd": [3], "one": [1, 4]}


def _c(L, v):
    return L.less_than(v["x"], v["y"])


def _d(L, v):
    return L.greater_than(v["x"], v["pos"])


UNARY_X = ["logsigmoid", "tanh_shrink", "exp", "abs", "softplus", "softsign", "ceil", "floor",
           "round", "sign", "erf", "cos", "sin", "acos", "asin", "atan", "cosh", "sinh", "mish",
           "hard_swish", "hard_sigmoid", "relu6", "soft_relu", "stanh", "hard_shrink",
           "softshrink", "thresholded_relu", "brelu"]
UNARY_POS = ["log", "rsqrt", "reciprocal"]

LAYERS = {
    **{n: (lambda n: lambda L, v: getattr(L, n)(v["x"]))(n) for n in UNARY_X},
    **{n: (lambda n: lambda L, v: getattr(L, n)(v["pos"]))(n) for n in UNARY_POS},
    "relu6-attr": lambda L, v: L.relu6(v["x"], threshold=0.5),
    "mul": lambda L, v: L.mul(v["x"], v["w"]),
    "elementwise_min": lambda L, v: L.elementwise_min(v["x"], v["y"]),
    "elementwise_pow": lambda L, v: L.elementwise_pow(v["pos"], v["y"]),
    "elementwise_mod": lambda L, v: L.elementwise_mod(v["x"], v["pos"]),
    "elementwise_floordiv": lambda L, v: L.elementwise_floordiv(v["x"], v["pos"]),
    "leaky_relu": lambda L, v: L.leaky_relu(v["x"], 0.1),
    "elu": lambda L, v: L.elu(v["x"], 1.2),
    "swish": lambda L, v: L.swish(v["x"], 1.5),
    "pow": lambda L, v: L.pow(v["pos"], 2.5),
    "cross_entropy2": lambda L, v: L.cross_entropy2(v["prob"], v["lab"]),
    "huber_loss": lambda L, v: L.huber_loss(v["x"], v["y"], 0.5),
    "smooth_l1": lambda L, v: L.smooth_l1(v["x"], v["y"], sigma=2.0),
    "log_loss": lambda L, v: L.log_loss(L.slice(v["prob"], [1], [0], [1]),
                                        L.cast(v["lab"] < 2, "float32")),
    "reduce_mean": lambda L, v: L.reduce_mean(v["x"], dim=1),
    "reduce_max": lambda L, v: L.reduce_max(v["x"]),
    "reduce_min": lambda L, v: L.reduce_min(v["x"], dim=[0], keep_dim=True),
    "reduce_prod": lambda L, v: L.reduce_prod(v["pos"], dim=1),
    "reduce_all": lambda L, v: L.reduce_all(_c(L, v), dim=1),
    "reduce_any": lambda L, v: L.reduce_any(_c(L, v)),
    "flatten": lambda L, v: L.flatten(v["img"], axis=2),
    "stack": lambda L, v: L.stack([v["x"], v["y"]], axis=1),
    "unstack": lambda L, v: L.unstack(v["x"], axis=1),
    "gather_nd": lambda L, v: L.gather_nd(v["x"], v["nd"]),
    "scatter": lambda L, v: L.scatter(v["x"], v["rows"], v["upd"]),
    "pad": lambda L, v: L.pad(v["x"], [1, 0, 0, 2], pad_value=0.5),
    "pad2d": lambda L, v: L.pad2d(v["img"], [1, 1, 2, 0], mode="reflect"),
    "shape": lambda L, v: L.shape(v["img"]),
    "where": lambda L, v: L.where(_c(L, v), v["x"], v["y"]),
    "l2_normalize": lambda L, v: L.l2_normalize(v["x"], 1),
    # tensor.py
    "argmax": lambda L, v: L.argmax(v["x"], 1),
    "argmin": lambda L, v: L.argmin(v["x"]),
    "argsort": lambda L, v: L.argsort(v["x"], 1, descending=True),
    "ones": lambda L, v: L.ones([2, 3], "float32"),
    "zeros": lambda L, v: L.zeros([2, 3], "int64"),
    "ones_like": lambda L, v: L.ones_like(v["x"]),
    "zeros_like": lambda L, v: L.zeros_like(v["x"]),
    "diag": lambda L, v: L.diag(v["vec"]),
    "eye": lambda L, v: L.eye(3, 4),
    "reverse": lambda L, v: L.reverse(v["x"], 1),
    "isfinite": lambda L, v: L.isfinite(v["x"]),
    "has_nan": lambda L, v: L.has_nan(L.log(v["x"])),
    "has_inf": lambda L, v: L.has_inf(L.reciprocal(L.floor(v["pos"]))),
    "create_global_var": lambda L, v: L.elementwise_add(
        v["x"], L.create_global_var([1], 0.25, "float32", persistable=True)),
    # extras.py
    "logical_and": lambda L, v: L.logical_and(_c(L, v), _d(L, v)),
    "logical_or": lambda L, v: L.logical_or(_c(L, v), _d(L, v)),
    "logical_xor": lambda L, v: L.logical_xor(_c(L, v), _d(L, v)),
    "logical_not": lambda L, v: L.logical_not(_c(L, v)),
    "expand_as": lambda L, v: L.expand_as(v["one"], v["x"]),
    "strided_slice": lambda L, v: L.strided_slice(v["x"], [0, 1], [2, 3], [-4, 0], [-1, -2]),
    "scatter_nd": lambda L, v: L.scatter_nd(v["nd"], v["ndupd"], [3, 4]),
    "scatter_nd_add": lambda L, v: L.scatter_nd_add(v["x"], v["nd"], v["ndupd"]),
    "mse_loss": lambda L, v: L.mse_loss(v["x"], v["y"]),
    "rank": lambda L, v: L.rank(v["img"]),
    "shard_index": lambda L, v: L.shard_index(v["ids"], 20, 2, 1),
}
RANDOM = {
    "uniform_random": lambda L, v: L.uniform_random([30, 40], min=-2.0, max=2.0, seed=3),
    "gaussian_random": lambda L, v: L.gaussian_random([30, 40], mean=1.0, std=0.5, seed=3),
}


def _build(pkg, fn):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        v = {n: pkg.data(n, SHAPES[n], str(FEED[n].dtype), append_batch_size=False)
             for n in SHAPES}
        out = fn(pkg.layers, v)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    return main, startup, outs


def _run(pkg, main, startup, outs):
    exe = pkg.Executor() if pkg is fluid else pkg.Executor(pkg.CPUPlace())
    with pkg.scope_guard(pkg.Scope()):
        exe.run(startup)
        return exe.run(main, feed=FEED, fetch_list=outs)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    (jm, js, jo), (tm, ts, to) = _build(fluid, LAYERS[name]), _build(pt, LAYERS[name])
    assert [op.to_dict() for op in tm.global_block().ops] == \
        [op.to_dict() for op in jm.global_block().ops]
    # the JAX package's shape inference declares an int64 result int32 (x64 off)
    width = {"int64": "int32"}
    assert [(o.name, width.get(o.dtype, o.dtype)) for o in to] == \
        [(o.name, width.get(o.dtype, o.dtype)) for o in jo]
    for a, b in zip(_run(fluid, jm, js, jo), _run(pt, tm, ts, to)):
        a = np.asarray(a)
        assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a.dtype, b.dtype)
        np.testing.assert_allclose(b.astype(np.float64), a.astype(np.float64),
                                   equal_nan=True, **TOL)


@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_layer_builds_the_jax_program(name):
    (jm, js, jo), (tm, ts, to) = _build(fluid, RANDOM[name]), _build(pt, RANDOM[name])
    assert [op.to_dict() for op in tm.global_block().ops] == \
        [op.to_dict() for op in jm.global_block().ops]
    (b,) = _run(pt, tm, ts, to)
    assert b.shape == (30, 40) and b.dtype == np.float32


@pytest.mark.parametrize("layer", ["range", "linspace"])
def test_tensor_bounded_layers_are_refused_as_in_jax(layer):
    """``range`` and ``linspace`` pass their bounds as tensors: shape
    inference refuses them in both packages (a tensor cannot set a shape)."""
    def build(pkg):
        with pkg.program_guard(pkg.Program(), pkg.Program()):
            if layer == "range":
                pkg.layers.range(0, 10, 2, "int64")
            else:
                pkg.layers.linspace(0.0, 1.0, 5)
    for pkg in (fluid, pt):
        with pytest.raises(Exception, match="static bounds"):
            build(pkg)


def test_create_tensor_matches_jax():
    for pkg in (fluid, pt):
        with pkg.unique_name.guard(), pkg.program_guard(pkg.Program(), pkg.Program()):
            t = pkg.layers.create_tensor("int64", persistable=True)
            assert (t.name, t.dtype, t.persistable) == ("tensor_0", "int64", True)
