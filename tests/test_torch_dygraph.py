"""The port's dygraph (``paddle_tpu_torch.dygraph``) against the JAX
package's (``paddle_tpu.dygraph``) on the same numpy inputs, on the CPU.

Each layer is built in both packages under ``unique_name.guard()``, so its
parameters have the same names; the JAX layer's ``state_dict()`` is loaded
into the port's with ``set_dict``, as ``convert.py`` describes. Forward
outputs, parameter gradients and input gradients are held at float32
``rtol 1e-5, atol 1e-6`` unless a case states otherwise (both packages sum
in float32, in other orders). Random draws differ between the packages
(threefry against Philox): dropout is held by its statistics, and ``NCE``
runs the JAX lowering on the negatives the port drew.

The cases of ``tests/test_dygraph.py`` (all but the two 8-device
``DataParallel`` ones, which wait for ROADMAP item 13) and the dygraph cases
of ``tests/test_surface_parity.py`` run on the port here too.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import paddle_tpu as fluid
from paddle_tpu import dygraph as jdg
from paddle_tpu.dygraph import nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import dygraph as dg
from paddle_tpu_torch.dygraph import nn as tnn
from paddle_tpu_torch.ops import sampled_ops
from paddle_tpu_torch.ops.flash_attention import attention_bwd_plain, attention_plain

CPU = pt.CPUPlace()
RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got, "float64"), np.asarray(want, "float64"),
                               rtol=rtol, atol=atol, err_msg=what)


def _mean_sq(pkg, v):
    return pkg.trace_op("mean", {"X": [v * v]}, {}, ["Out"])["Out"][0]


def _weighted(pkg, out, cot):
    """out * cot: backward() seeds it with ones, so the gradient of out is cot."""
    return pkg.trace_op("elementwise_mul", {"X": [out], "Y": [pkg.to_variable(cot)]},
                        {"axis": -1}, ["Out"])["Out"][0]


# -- the layer classes -------------------------------------------------------------------

def _f(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype("float32")


def _layer_cases():
    """name -> (build(nn module), inputs(rng)), each held at the default
    float32 tolerance."""
    ids = lambda rng: rng.randint(0, 10, (3, 5)).astype("int64")
    edges = np.array([[[1, 2], [1, 3], [2, 4], [0, 0]]], "int32")
    return {
        "Linear": (lambda m: m.Linear(6, 4, act="relu"), lambda r: [_f(r, 3, 6)]),
        "FC": (lambda m: m.FC(6, 4, bias_attr=False), lambda r: [_f(r, 2, 3, 6)]),
        "Conv2D": (lambda m: m.Conv2D(3, 4, 3, padding=1, act="relu"),
                   lambda r: [_f(r, 2, 3, 6, 6)]),
        "Pool2D-max": (lambda m: m.Pool2D(2, "max", 2), lambda r: [_f(r, 2, 3, 6, 6)]),
        "Pool2D-avg": (lambda m: m.Pool2D(3, "avg", 1, pool_padding=1),
                       lambda r: [_f(r, 2, 3, 5, 5)]),
        "Embedding": (lambda m: m.Embedding([10, 4]), lambda r: [ids(r)]),
        "BatchNorm": (lambda m: m.BatchNorm(3), lambda r: [_f(r, 4, 3, 5, 5)]),
        "LayerNorm": (lambda m: m.LayerNorm(6), lambda r: [_f(r, 3, 4, 6)]),
        "Dropout": (lambda m: m.Dropout(0.0), lambda r: [_f(r, 3, 7)]),
        "Sequential": (lambda m: m.Sequential(m.Linear(6, 5, act="tanh"), m.Linear(5, 3)),
                       lambda r: [_f(r, 4, 6)]),
        "Conv2DTranspose": (lambda m: m.Conv2DTranspose(3, 4, 3, stride=2, padding=1),
                            lambda r: [_f(r, 2, 3, 5, 5)]),
        "Conv3D": (lambda m: m.Conv3D(2, 3, 3, padding=1), lambda r: [_f(r, 2, 2, 4, 5, 5)]),
        "Conv3DTranspose": (lambda m: m.Conv3DTranspose(2, 3, 2, stride=2),
                            lambda r: [_f(r, 1, 2, 3, 3, 3)]),
        "GroupNorm": (lambda m: m.GroupNorm(6, groups=3, act="relu"),
                      lambda r: [_f(r, 2, 6, 4, 4)]),
        "PRelu": (lambda m: m.PRelu("channel", channel=3), lambda r: [_f(r, 2, 3, 4, 4)]),
        "BilinearTensorProduct": (lambda m: m.BilinearTensorProduct(4, 5, 3, act="tanh"),
                                  lambda r: [_f(r, 2, 4), _f(r, 2, 5)]),
        "RowConv": (lambda m: m.RowConv(4, 2), lambda r: [_f(r, 2, 6, 4)]),
        "GRUUnit": (lambda m: m.GRUUnit(12), lambda r: [_f(r, 2, 12), _f(r, 2, 4)]),
        "GRUUnit-origin": (lambda m: m.GRUUnit(12, origin_mode=True),
                           lambda r: [_f(r, 2, 12), _f(r, 2, 4)]),
        "SequenceConv": (lambda m: m.SequenceConv(6, filter_size=3, input_dim=5, act="relu"),
                         lambda r: [_f(r, 2, 7, 5)]),
        "SpectralNorm": (lambda m: m.SpectralNorm([6, 4], power_iters=3),
                         lambda r: [_f(r, 6, 4, scale=3.0)]),
        "TreeConv": (lambda m: m.TreeConv(5, 3, num_filters=2),
                     lambda r: [_f(r, 1, 4, 5), edges]),
    }


LAYER_CASES = _layer_cases()
#: the 20 classes the cases cover (FC is Linear's alias)
CLASSES = {"Linear", "Conv2D", "Pool2D", "Embedding", "BatchNorm", "LayerNorm", "Dropout",
           "Sequential", "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "GroupNorm", "PRelu",
           "BilinearTensorProduct", "RowConv", "GRUUnit", "NCE", "SequenceConv",
           "SpectralNorm", "TreeConv"}


def _run_layer(pkg, nn_mod, uname, build, arrays, state, cot_seed):
    """Build under a name guard, load ``state`` (when given), run forward and
    backward; returns (outputs, param grads by name, input grads, state,
    a batch norm's running statistics)."""
    with uname.guard():
        layer = build(nn_mod)
    if state is not None:
        layer.set_dict(state)
    sd = layer.state_dict()
    ins = [pkg.to_variable(a) for a in arrays]
    for v, a in zip(ins, arrays):
        v.stop_gradient = a.dtype.kind != "f"
    outs = layer(*ins)
    outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    # the first output's gradient is a random cotangent (GRUUnit's other
    # outputs are parts of what the first one reads)
    _weighted(pkg, outs[0], np.random.RandomState(cot_seed).randn(*outs[0].shape)
              .astype("float32")).backward()
    pgrads = {n: p.gradient() for n, p in layer.named_parameters()}
    igrads = [v.gradient() for v in ins]
    extra = {}
    if hasattr(layer, "_mean"):
        extra = {"mean": layer._mean.numpy(), "variance": layer._variance.numpy()}
    return [o.numpy() for o in outs], pgrads, igrads, sd, extra


def test_layer_cases_cover_every_class():
    covered = {n.split("-")[0] for n in LAYER_CASES} - {"FC"} | {"NCE"}
    assert covered == CLASSES
    assert tnn.FC is tnn.Linear


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_layer_matches_jax(name):
    """Forward, every parameter's gradient and each float input's gradient,
    with the JAX layer's state carried in by ``state_dict`` -> ``set_dict``."""
    build, inputs = LAYER_CASES[name]
    arrays = inputs(np.random.RandomState(7))
    with jdg.guard():
        jouts, jpg, jig, jsd, jextra = _run_layer(jdg, jnn, fluid.unique_name, build,
                                                  arrays, None, 3)
    with dg.guard(CPU):
        touts, tpg, tig, tsd, textra = _run_layer(dg, tnn, pt.unique_name, build, arrays,
                                                  jsd, 3)
    assert sorted(tsd) == sorted(jsd) and sorted(tpg) == sorted(jpg)
    for i, (a, b) in enumerate(zip(touts, jouts)):
        assert a.shape == b.shape
        _close(a, b, what=f"{name} out {i}")
    for n in jpg:
        assert (tpg[n] is None) == (jpg[n] is None), n
        if jpg[n] is not None:
            _close(tpg[n], jpg[n], what=f"{name} grad {n}")
    for i, (a, b) in enumerate(zip(tig, jig)):
        assert (a is None) == (b is None)
        if b is not None:
            _close(a, b, what=f"{name} input grad {i}")
    for k in jextra:
        _close(textra[k], jextra[k], what=f"{name} running {k}")


def test_layer_init_matches_jax():
    """``_init_array`` is the JAX package's: a layer built with no state
    carried starts from the same values (xavier, normal, zeros, ones)."""
    with jdg.guard(), fluid.unique_name.guard():
        jl = jdg.Sequential(jdg.Linear(6, 5), jdg.Embedding([10, 4]), jdg.LayerNorm(5))
        jsd = jl.state_dict()
    with dg.guard(CPU), pt.unique_name.guard():
        tl = dg.Sequential(dg.Linear(6, 5), dg.Embedding([10, 4]), dg.LayerNorm(5))
        tsd = tl.state_dict()
    assert list(tsd) == list(jsd)
    for n in jsd:
        np.testing.assert_array_equal(tsd[n], jsd[n], err_msg=n)


def test_nce_matches_jax_on_the_ports_negatives(monkeypatch):
    """NCE's cost and gradients, the JAX lowering given the negatives the
    port drew (its ``randint`` replaced for the call, the recompute of its
    vjp included)."""
    drawn = []
    real = sampled_ops.counter_randint

    def spy(ctx, shape, high):
        drawn.append(real(ctx, shape, high))
        return drawn[-1]

    monkeypatch.setattr(sampled_ops, "counter_randint", spy)
    rng = np.random.RandomState(5)
    arrays = [_f(rng, 4, 8), rng.randint(0, 20, (4, 1)).astype("int64")]
    build = lambda m: m.NCE(num_total_classes=20, dim=8, num_neg_samples=5)
    with jdg.guard(), fluid.unique_name.guard():
        jsd = build(jnn).state_dict()
    with dg.guard(CPU):
        touts, tpg, tig, _, _ = _run_layer(dg, tnn, pt.unique_name, build, arrays, jsd, 1)
    assert len(drawn) == 1          # the kept graph: no recompute in the backward
    neg = jnp.asarray(drawn[0].numpy().astype("int32"))
    monkeypatch.setattr(jax.random, "randint", lambda *a, **k: neg)
    with jdg.guard():
        jouts, jpg, jig, _, _ = _run_layer(jdg, jnn, fluid.unique_name, build, arrays,
                                           jsd, 1)
    _close(touts[0], jouts[0], what="cost")
    for n in jpg:
        _close(tpg[n], jpg[n], what=n)
    _close(tig[0], jig[0], what="input grad")


def test_dropout_layer_statistics_and_eval():
    """Dropout(0.3) in train mode: the kept share within 0.02 of 0.7 over
    20,000 elements (5 standard errors) in both packages and kept values
    scaled by 1/0.7; on the port the gradient is nonzero exactly where the
    forward kept; in eval mode the identity in both."""
    x = np.random.RandomState(2).rand(100, 200).astype("float32") + 0.5
    for pkg, guard in ((jdg, jdg.guard()), (dg, dg.guard(CPU))):
        with guard:
            layer = pkg.Dropout(0.3)
            v = pkg.to_variable(x)
            v.stop_gradient = False
            y = layer(v)
            out = y.numpy()
            kept = out != 0
            assert abs(kept.mean() - 0.7) < 0.02, pkg.__name__
            _close(out[kept], x[kept] / 0.7, what=pkg.__name__)
            if pkg is dg:
                y.backward()
                np.testing.assert_array_equal(v.gradient() != 0, kept)
            layer.eval()
            np.testing.assert_array_equal(layer(pkg.to_variable(x)).numpy(), x)


# -- the optimizers ----------------------------------------------------------------------

def _train_mlp(pkg, opt, steps=5, state=None, seed=11):
    rng = np.random.RandomState(seed)
    xb, yb = _f(rng, 16, 6), _f(rng, 16, 1)
    uname = fluid.unique_name if pkg is jdg else pt.unique_name
    with uname.guard():
        model = pkg.Sequential(pkg.Linear(6, 8, act="relu"), pkg.Linear(8, 1))
    if state is not None:
        model.set_dict(state)
    sd = model.state_dict()
    losses = []
    for _ in range(steps):
        d = model(pkg.to_variable(xb)) - pkg.to_variable(yb)
        loss = _mean_sq(pkg, d)
        opt.minimize(loss, parameter_list=model.parameters())
        losses.append(float(loss.numpy().reshape(-1)[0]))
    return losses, {n: p.numpy() for n, p in model.named_parameters()}, sd


@pytest.mark.parametrize("name,make", [
    ("SGDOptimizer", lambda m: m.SGDOptimizer(0.1)),
    ("MomentumOptimizer", lambda m: m.MomentumOptimizer(0.05, momentum=0.9)),
    ("MomentumOptimizer-nesterov", lambda m: m.MomentumOptimizer(0.05, use_nesterov=True)),
    ("AdamOptimizer", lambda m: m.AdamOptimizer(0.02)),
])
def test_optimizer_trajectory_matches_jax(name, make):
    """Five steps of a 6 -> 8 -> 1 MLP on one batch: every loss and the final
    parameters."""
    with jdg.guard():
        jl, jp, jsd = _train_mlp(jdg, make(jdg))
    with dg.guard(CPU):
        tl, tp, _ = _train_mlp(dg, make(dg), state=jsd)
    _close(tl, jl, what=f"{name} losses")
    assert tl[-1] < tl[0]
    for n in jp:
        _close(tp[n], jp[n], what=f"{name} {n}")


def test_optimizer_lr_tensor_made_once():
    with dg.guard(CPU):
        opt = dg.AdamOptimizer(0.01)
        _train_mlp(dg, opt, steps=2)
        assert list(opt._lr_t) == [torch.device("cpu")]
        st = next(iter(opt._state.values()))
        assert all(t.device.type == "cpu" and t.dtype == torch.float32 for t in st.values())


# -- fused_attention through the tape ----------------------------------------------------

def _attn_arrays(B=2, H=2, S=16, D=32, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v = (_f(rng, B, H, S, D, scale=0.5) for _ in range(3))
    lens = rng.randint(S // 2, S + 1, B)
    bias = ((np.arange(S)[None, :] < lens[:, None]).astype("float32") - 1.0) * 1e4
    return q, k, v, bias.reshape(B, 1, 1, S).astype("float32")


def _attn(pkg, q, k, v, bias, p, cot):
    Q, K, V, Bb = (pkg.to_variable(a) for a in (q, k, v, bias))
    for t in (Q, K, V):
        t.stop_gradient = False
    Bb.stop_gradient = True
    o = pkg.trace_op("fused_attention", {"Q": [Q], "K": [K], "V": [V], "Bias": [Bb]},
                     {"dropout_prob": p}, ["Out"])["Out"][0]
    _weighted(pkg, o, cot).backward()
    return o, Q, K, V


def test_fused_attention_tape_matches_jax_without_dropout():
    arrays = _attn_arrays()
    cot = _f(np.random.RandomState(9), *arrays[0].shape)
    with jdg.guard():
        jo, jq, jk, jv = _attn(jdg, *arrays, 0.0, cot)
        jvals = [t.numpy() for t in (jo,)] + [t.gradient() for t in (jq, jk, jv)]
    with dg.guard(CPU):
        to, tq, tk, tv = _attn(dg, *arrays, 0.0, cot)
        tvals = [to.numpy()] + [t.gradient() for t in (tq, tk, tv)]
    for name, a, b in zip(("O", "dQ", "dK", "dV"), tvals, jvals):
        _close(a, b, 1e-5, 1e-5, name)


def test_fused_attention_tape_dropout_replays_the_forward_mask():
    """Dropout 0.1 through the tape. V is the identity (S = D), so O is the
    dropped probabilities themselves; the loss reads one query row of each
    head, so dV's rows are that row of the dropped probabilities times a
    cotangent: the gradient is zero exactly where the forward dropped. Both
    also equal the plain versions under the op's own seed (the tape's salt
    replayed into the grad op). The kept share of the valid (unmasked)
    probabilities is 0.9 within 0.015 in both packages (3,000+ elements: 5
    standard errors); the two RNGs differ."""
    B, H, S = 4, 4, 32
    q, k, _, bias = _attn_arrays(B, H, S, S, seed=1)
    v = np.broadcast_to(np.eye(S, dtype="float32"), (B, H, S, S)).copy()
    rng = np.random.RandomState(4)
    rows = rng.randint(0, S, (B, H))
    cot = np.zeros((B, H, S, S), "float32")
    for b in range(B):
        for h in range(H):
            cot[b, h, rows[b, h]] = rng.rand(S) + 0.5
    valid = np.broadcast_to(bias.reshape(B, 1, 1, S) == 0, (B, H, S, S))
    with jdg.guard():
        Q, K, V, Bb = (jdg.to_variable(a) for a in (q, k, v, bias))
        out = jdg.trace_op("fused_attention", {"Q": [Q], "K": [K], "V": [V], "Bias": [Bb]},
                           {"dropout_prob": 0.1}, ["Out"])["Out"][0].numpy()
    assert abs((out != 0)[valid].mean() - 0.9) < 0.015, "JAX"
    with dg.guard(CPU):
        start = dg.base._state.op_counter
        o, Q, K, V = _attn(dg, q, k, v, bias, 0.1, cot)
        out, dv = o.numpy(), V.gradient()
    kept = out != 0
    assert abs(kept[valid].mean() - 0.9) < 0.015, "port"
    for b in range(B):
        for h in range(H):
            np.testing.assert_array_equal(dv[b, h, :, 0] != 0, kept[b, h, rows[b, h]])
    from paddle_tpu_torch.core.registry import seed_int
    seed = seed_int(0, 0, start + 1)        # the attention op's salt
    tq, tk, tv, tb = (torch.from_numpy(a) for a in (q, k, v, bias))
    want = attention_plain(tq, tk, tv, tb, dropout=0.1, seed=seed)
    np.testing.assert_array_equal(out, want.numpy())
    dq, dk, dvw = attention_bwd_plain(tq, tk, tv, tb, want, torch.from_numpy(cot),
                                      dropout=0.1, seed=seed)
    _close(Q.gradient(), dq.numpy(), 1e-5, 1e-6, "dQ")
    _close(K.gradient(), dk.numpy(), 1e-5, 1e-6, "dK")
    _close(dv, dvw.numpy(), 1e-5, 1e-6, "dV")


def test_tape_keeps_forward_graphs_and_frees_them():
    """A generic-grad forward keeps its graph once (no recompute in the
    backward); a no_grad op keeps none; backward empties the table."""
    from paddle_tpu_torch.dygraph import base
    calls = []
    real = base.registry.get("tanh").lower

    def counting(ctx, ins):
        calls.append(1)
        return real(ctx, ins)

    with dg.guard(CPU):
        x = dg.to_variable(np.ones((2, 3), "float32"))
        x.stop_gradient = False
        d = base.registry.get("tanh")
        d.lower = counting
        try:
            y = dg.trace_op("tanh", {"X": [x]}, {}, ["Out"])["Out"][0]
            with dg.no_grad():
                dg.trace_op("tanh", {"X": [x]}, {}, ["Out"])
            assert len(base._state.graphs) == 1
            assert not y.value.requires_grad
            _mean_sq(dg, y).backward()
        finally:
            d.lower = real
        assert len(calls) == 2 and not base._state.graphs and not base._state.tape
        _close(x.gradient(), 2 * np.tanh(1.0) * (1 - np.tanh(1.0) ** 2) / 6 * np.ones((2, 3)))


def test_scalar_op_constant_on_the_tensors_device_and_dtype():
    with dg.guard(CPU):
        x = dg.to_variable(np.array([1.5, 2.5], "float32")).astype("bfloat16")
        y = x * 2.0 + 1
        assert y.dtype == "bfloat16" and y.numpy().dtype == np.float32
        np.testing.assert_array_equal(y.numpy(), [4.0, 6.0])


# -- the cases of tests/test_dygraph.py and tests/test_surface_parity.py ------------------

def test_varbase_arithmetic_and_grad():
    with dg.guard(CPU):
        x = dg.to_variable(np.array([1.0, 2.0, 3.0], "float32"))
        x.stop_gradient = False
        y = x * x + 2.0 * x
        loss = dg.trace_op("mean", {"X": [y]}, {}, ["Out"])["Out"][0]
        loss.backward()
        np.testing.assert_allclose(x.gradient(), (2 * np.array([1, 2, 3.0]) + 2) / 3,
                                   rtol=1e-6)


def test_linear_layer_trains():
    rng = np.random.RandomState(0)
    W = rng.randn(8, 1).astype("float32")
    with dg.guard(CPU):
        model = dg.Linear(8, 1)
        opt = dg.AdamOptimizer(0.05)
        losses = []
        for _ in range(40):
            xb = rng.randn(32, 8).astype("float32")
            pred = model(dg.to_variable(xb))
            diff = pred - dg.to_variable(xb @ W)
            loss = dg.trace_op("mean", {"X": [diff * diff]}, {}, ["Out"])["Out"][0]
            opt.minimize(loss, parameter_list=model.parameters())
            losses.append(float(loss.numpy()[0]))
    assert losses[-1] < 0.1 * losses[0]


def test_conv_bn_pool_forward_shapes():
    with dg.guard(CPU):
        conv = dg.Conv2D(3, 8, 3, padding=1)
        bn = dg.BatchNorm(8)
        pool = dg.Pool2D(2, "max", 2)
        x = dg.to_variable(np.random.randn(2, 3, 16, 16).astype("float32"))
        assert pool(bn(conv(x))).shape == (2, 8, 8, 8)
        bn.eval()
        assert bn(conv(x)).shape == (2, 8, 16, 16)


def test_dygraph_matches_static():
    """Same MLP, same init values -> same loss trajectory on the port's
    static executor and its dygraph (the JAX package's dygraph is held
    against the port's in test_optimizer_trajectory_matches_jax)."""
    rng = np.random.RandomState(1)
    xb, yb = rng.randn(16, 4).astype("float32"), rng.randn(16, 1).astype("float32")
    w0 = rng.randn(4, 8).astype("float32") * 0.1
    w1 = rng.randn(8, 1).astype("float32") * 0.1

    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [4], "float32")
        yt = pt.data("y", [1], "float32")
        from paddle_tpu_torch.initializer import NumpyArrayInitializer
        h = pt.layers.fc(x, 8, act="relu", bias_attr=False,
                         param_attr=pt.ParamAttr(initializer=NumpyArrayInitializer(w0)))
        pred = pt.layers.fc(h, 1, bias_attr=False,
                            param_attr=pt.ParamAttr(initializer=NumpyArrayInitializer(w1)))
        loss = pt.layers.mean(pt.layers.square_error_cost(pred, yt))
        pt.optimizer.SGD(0.1).minimize(loss)
    exe = pt.Executor(CPU)
    static_losses = []
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(5):
            lv, = exe.run(main, feed={"x": xb, "y": yb}, fetch_list=[loss])
            static_losses.append(float(lv[0]))

    def eager(pkg):
        l1 = pkg.Linear(4, 8, bias_attr=False, act="relu")
        l2 = pkg.Linear(8, 1, bias_attr=False)
        l1.set_dict({l1.weight.name: w0})
        l2.set_dict({l2.weight.name: w1})
        opt = pkg.SGDOptimizer(0.1)
        out = []
        for _ in range(5):
            d = l2(l1(pkg.to_variable(xb))) - pkg.to_variable(yb)
            loss = pkg.trace_op("mean", {"X": [d * d]}, {}, ["Out"])["Out"][0]
            opt.minimize(loss, parameter_list=[l1.weight, l2.weight])
            out.append(float(loss.numpy()[0]))
        return out

    with dg.guard(CPU):
        dy_losses = eager(dg)
    np.testing.assert_allclose(static_losses, dy_losses, rtol=1e-5)


def test_state_dict_roundtrip(tmp_path):
    with dg.guard(CPU):
        model = dg.Sequential(dg.Linear(4, 8), dg.Linear(8, 2))
        sd = model.state_dict()
        path = str(tmp_path / "model")
        dg.save_dygraph(sd, path)
        loaded, opt_state = dg.load_dygraph(path)
        assert opt_state is None and sorted(loaded) == sorted(sd)
        model2 = dg.Sequential(dg.Linear(4, 8), dg.Linear(8, 2))
        x = dg.to_variable(np.ones((2, 4), "float32"))
        # keys differ (fresh unique names) -> remap by order
        model2.set_dict({n: loaded[k] for (n, _), k in zip(model2.named_parameters(), sd)})
        np.testing.assert_allclose(model2(x).numpy(), model(x).numpy(), rtol=1e-6)


def test_no_grad_blocks_taping():
    from paddle_tpu_torch.dygraph import base
    with dg.guard(CPU):
        x = dg.to_variable(np.ones(3, "float32"))
        x.stop_gradient = False
        with dg.no_grad():
            x * 2.0
        assert base._state.tape == []
        z = x + 1.0
        dg.trace_op("mean", {"X": [z]}, {}, ["Out"])["Out"][0].backward()
        assert x.gradient() is not None


def test_dygraph_dropout_grad_uses_forward_mask():
    """Backward replays the forward's salt: dropout's grad mask is the
    forward's mask."""
    with dg.guard(CPU):
        x = dg.to_variable(np.ones((64,), "float32"))
        x.stop_gradient = False
        out = dg.trace_op("dropout", {"X": [x]},
                          {"dropout_prob": 0.5, "is_test": False,
                           "dropout_implementation": "upscale_in_train"}, ["Out"])["Out"][0]
        loss = dg.trace_op("reduce_sum", {"X": [out]}, {}, ["Out"])["Out"][0]
        fwd = out.numpy()
        loss.backward()
        np.testing.assert_array_equal(x.gradient() != 0.0, fwd != 0.0)


class _TNet:
    """tests/test_dygraph.py's traced net, in either package."""

    @staticmethod
    def make(pkg):
        class Net(pkg.Layer):
            def __init__(self):
                super().__init__()
                self.c = pkg.Conv2D(1, 4, 3, padding=1, act="relu")
                self.fc = pkg.Linear(4 * 8 * 8, 10)

            def forward(self, x):
                h = self.c(x)
                h = pkg.trace_op("reshape", {"X": [h]}, {"shape": [0, 4 * 8 * 8]},
                                 ["Out"])["Out"][0]
                return self.fc(h)
        return Net()


def test_traced_layer_matches_dygraph_jax_and_serves(tmp_path):
    """TracedLayer: the transcribed op types equal the JAX transcription's;
    the traced program agrees with the eager run at batch 2 and 5 (the -1
    feed dim), with the JAX package's eager output, and the export serves
    through the port's Predictor on the CPU."""
    rng = np.random.RandomState(4)
    x1 = rng.randn(2, 1, 8, 8).astype("float32")
    x2 = rng.randn(5, 1, 8, 8).astype("float32")
    with jdg.guard(), fluid.unique_name.guard():
        jnet = _TNet.make(jdg)
        jsd = jnet.state_dict()
        jout, jtraced = jdg.TracedLayer.trace(jnet, [jdg.to_variable(x1)])
        jeager2 = jnet(jdg.to_variable(x2)).numpy()
    with dg.guard(CPU), pt.unique_name.guard():
        net = _TNet.make(dg)
        net.set_dict(jsd)
        eager_out, traced = dg.TracedLayer.trace(net, [dg.to_variable(x1)])
        eager2 = net(dg.to_variable(x2)).numpy()
        eager1 = eager_out.numpy()
    assert ([op.type for op in traced.program.global_block().ops]
            == [op.type for op in jtraced.program.global_block().ops])
    assert traced.feed_names == jtraced.feed_names
    _close(eager1, jout.numpy(), 1e-5, 1e-6, "eager vs JAX")
    _close(eager2, jeager2, 1e-5, 1e-6, "eager vs JAX at batch 5")
    got1, = traced([x1])
    _close(got1, eager1, 1e-5, 1e-6, "traced batch 2")
    got2, = traced([x2])
    _close(got2, eager2, 1e-5, 1e-6, "traced batch 5")
    d = str(tmp_path / "traced")
    traced.save_inference_model(d)
    out, = pt.inference.Predictor(d, device="cpu").run([x2])
    _close(out, eager2, 1e-5, 1e-6, "Predictor")


def test_traced_attention_runs_and_serves(tmp_path):
    """A traced layer holding ``fused_attention`` (eval: no dropout) runs on
    the executor and serves, at two batch sizes."""
    B, H, S, D = 2, 2, 16, 32

    class Attn(dg.Layer):
        def __init__(self):
            super().__init__()
            self.qkv = dg.Linear(H * D, 3 * H * D)

        def forward(self, x, bias):
            qkv = self.qkv(x)
            heads = []
            for t in dg.trace_op("split", {"X": [qkv]}, {"num": 3, "sections": [], "axis": 2},
                                 ["Out"])["Out"]:
                t = dg.trace_op("reshape2", {"X": [t]}, {"shape": [0, -1, H, D]},
                                ["Out"])["Out"][0]
                heads.append(dg.trace_op("transpose2", {"X": [t]}, {"axis": [0, 2, 1, 3]},
                                         ["Out"])["Out"][0])
            q, k, v = heads
            return dg.trace_op("fused_attention", {"Q": [q], "K": [k], "V": [v],
                                                   "Bias": [bias]},
                               {"dropout_prob": 0.1, "is_test": not self.training},
                               ["Out"])["Out"][0]

    rng = np.random.RandomState(6)
    xs = {b: _f(rng, b, S, H * D) for b in (B, 3)}
    biases = {b: np.zeros((b, 1, 1, S), "float32") for b in (B, 3)}
    with dg.guard(CPU):
        net = Attn()
        net.eval()
        out, traced = dg.TracedLayer.trace(net, [dg.to_variable(xs[B]),
                                                 dg.to_variable(biases[B])])
        eager3 = net(dg.to_variable(xs[3]), dg.to_variable(biases[3])).numpy()
    assert "fused_attention" in [op.type for op in traced.program.global_block().ops]
    _close(traced([xs[B], biases[B]])[0], out.numpy(), 1e-5, 1e-6, "traced")
    _close(traced([xs[3], biases[3]])[0], eager3, 1e-5, 1e-6, "traced batch 3")
    d = str(tmp_path / "attn")
    traced.save_inference_model(d)
    got, = pt.inference.Predictor(d, device="cpu").run([xs[3], biases[3]])
    _close(got, eager3, 1e-5, 1e-6, "Predictor")


def test_traced_layer_keeps_autograd_alive():
    rng = np.random.RandomState(5)
    with dg.guard(CPU):
        lin = dg.Linear(4, 2)
        x = dg.to_variable(rng.randn(3, 4).astype("float32"))
        out, traced = dg.TracedLayer.trace(lin, [x])
        dg.trace_op("mean", {"X": [out * out]}, {}, ["Out"])["Out"][0].backward()
        assert lin.weight.gradient() is not None
        assert np.abs(lin.weight.gradient()).sum() > 0


def test_dygraph_tail_classes():
    """NCE / SequenceConv / SpectralNorm / TreeConv, as tests/test_dygraph.py."""
    rng = np.random.RandomState(0)
    with dg.guard(CPU):
        nce = tnn.NCE(num_total_classes=20, dim=8, num_neg_samples=5)
        cost = nce(dg.to_variable(rng.randn(4, 8).astype("float32")),
                   dg.to_variable(rng.randint(0, 20, (4, 1)).astype("int64")))
        assert cost.shape == (4, 1) and np.isfinite(cost.numpy().sum())
        sc = tnn.SequenceConv(num_filters=6, filter_size=3, input_dim=5)
        assert sc(dg.to_variable(rng.randn(2, 7, 5).astype("float32"))).shape == (2, 7, 6)
        sn = tnn.SpectralNorm([6, 4], power_iters=8)
        w = dg.to_variable((rng.randn(6, 4) * 3).astype("float32"))
        u_before = sn.weight_u.numpy().copy()
        wn = sn(w)
        assert not np.allclose(sn.weight_u.numpy(), u_before)
        np.testing.assert_allclose(np.linalg.svd(wn.numpy(), compute_uv=False)[0], 1.0,
                                   rtol=0.05)
        tc = tnn.TreeConv(feature_size=5, output_size=3, num_filters=2)
        out = tc(dg.to_variable(rng.randn(1, 4, 5).astype("float32")),
                 dg.to_variable(np.array([[[1, 2], [1, 3], [2, 4], [0, 0]]], "int32")))
        assert out.shape == (1, 4, 3, 2) and np.isfinite(out.numpy()).all()


def test_dygraph_new_layers():
    rng = np.random.RandomState(1)
    with dg.guard(CPU):
        x = dg.to_variable(rng.randn(2, 3, 8, 8).astype("float32"))
        ct = dg.Conv2DTranspose(3, 6, 3, stride=2, padding=1)
        assert ct(x).shape == (2, 6, 15, 15)
        v = dg.to_variable(rng.randn(2, 2, 4, 8, 8).astype("float32"))
        assert dg.Conv3D(2, 4, 3, padding=1)(v).shape == (2, 4, 4, 8, 8)
        assert dg.GroupNorm(6, groups=3)(ct(x)).shape == (2, 6, 15, 15)
        assert dg.PRelu("all")(x).shape == x.shape
        btp = dg.BilinearTensorProduct(4, 5, 3)
        a = dg.to_variable(rng.randn(2, 4).astype("float32"))
        b = dg.to_variable(rng.randn(2, 5).astype("float32"))
        assert btp(a, b).shape == (2, 3)
        assert dg.RowConv(4, 2)(dg.to_variable(rng.randn(2, 6, 4).astype("float32"))).shape \
            == (2, 6, 4)
        nh, rh, g = dg.GRUUnit(12)(dg.to_variable(rng.randn(2, 12).astype("float32")),
                                   dg.to_variable(rng.randn(2, 4).astype("float32")))
        assert nh.shape == (2, 4) and g.shape == (2, 12)
        loss = dg.trace_op("mean", {"X": [btp(a, b) * btp(a, b)]}, {}, ["Out"])["Out"][0]
        loss.backward()
        assert btp.weight.gradient() is not None


@pytest.mark.parametrize("origin_mode", [False, True])
def test_gru_unit_matches_numpy(origin_mode):
    """GRUUnit against a numpy GRU step (gru_unit_op.h math); origin_mode
    flips the update mix."""
    rng = np.random.RandomState(6)
    H = 4
    gate = rng.randn(2, 3 * H).astype("float32")
    h = rng.randn(2, H).astype("float32")
    with dg.guard(CPU):
        gu = dg.GRUUnit(3 * H, origin_mode=origin_mode)
        nh, _, _ = gu(dg.to_variable(gate), dg.to_variable(h))
        W, b = gu.weight.numpy(), gu.bias.numpy()
    sig = lambda v: 1 / (1 + np.exp(-v))
    ur = sig(gate[:, :2 * H] + h @ W[:, :2 * H] + b[:2 * H])
    u, r = ur[:, :H], ur[:, H:]
    c = np.tanh(gate[:, 2 * H:] + (r * h) @ W[:, 2 * H:] + b[2 * H:])
    want = (1 - u) * h + u * c if origin_mode else u * h + (1 - u) * c
    np.testing.assert_allclose(nh.numpy(), want, rtol=1e-5, atol=1e-6)


# -- checkpoints, DataParallel, the device ----------------------------------------------

def test_npz_checkpoints_load_across_packages(tmp_path):
    """An f32 state written by either package loads into the other's layer
    and gives its outputs."""
    x = np.random.RandomState(3).randn(3, 6).astype("float32")
    build = lambda m: m.Sequential(m.Linear(6, 5, act="tanh"), m.Linear(5, 2))
    with jdg.guard(), fluid.unique_name.guard():
        jm = build(jdg)
        jdg.save_dygraph(jm.state_dict(), str(tmp_path / "jax"))
        jout = jm(jdg.to_variable(x)).numpy()
    with dg.guard(CPU), pt.unique_name.guard():
        tm = build(dg)
        state, _ = dg.load_dygraph(str(tmp_path / "jax"))
        tm.set_dict(state)
        _close(tm(dg.to_variable(x)).numpy(), jout, what="port from a JAX file")
        for n, p in tm.named_parameters():
            p.value = p.value * 1.5
        dg.save_dygraph(tm.state_dict(), str(tmp_path / "port"))
        tout = tm(dg.to_variable(x)).numpy()
    with jdg.guard(), fluid.unique_name.guard():
        jm2 = build(jdg)
        state, _ = jdg.load_dygraph(str(tmp_path / "port"))
        assert all(a.dtype == np.float32 for a in state.values())
        jm2.set_dict(state)
        _close(jm2(jdg.to_variable(x)).numpy(), tout, what="JAX from a port file")


def test_bf16_checkpoint_round_trip_and_jax_bf16_file(tmp_path):
    """A bf16 layer saves as f32 (exact) and loads back bit for bit; a
    bf16 file the JAX package wrote ('|V2' data) reads as bf16 bits."""
    with dg.guard(CPU), pt.unique_name.guard():
        lin = dg.Linear(4, 3, dtype="bfloat16")
        dg.save_dygraph(lin.state_dict(), str(tmp_path / "m"))
        state, _ = dg.load_dygraph(str(tmp_path / "m"))
        assert all(a.dtype == np.float32 for a in state.values())
        lin2 = dg.Linear(4, 3, dtype="bfloat16")
        lin2.set_dict({n2: state[n1] for (n1, _), (n2, _) in
                       zip(lin.named_parameters(), lin2.named_parameters())})
        for p, q in zip(lin.parameters(), lin2.parameters()):
            assert q.value.dtype == torch.bfloat16 and torch.equal(p.value, q.value)
    with jdg.guard(), fluid.unique_name.guard():
        jl = jdg.Linear(4, 3, dtype="bfloat16")
        jdg.save_dygraph(jl.state_dict(), str(tmp_path / "j"))
        want = {n: np.asarray(v, "float32") for n, v in jl.state_dict().items()}
    state, _ = dg.load_dygraph(str(tmp_path / "j"))
    for n in want:
        np.testing.assert_array_equal(state[n], want[n])


def test_data_parallel_one_rank_equals_plain_model():
    rng = np.random.RandomState(3)
    W = rng.randn(16, 4).astype("float32")
    data = [rng.randn(32, 16).astype("float32") for _ in range(4)]

    def train(parallel):
        with dg.guard(CPU), pt.unique_name.guard():
            model = dg.Sequential(dg.Linear(16, 32, act="relu"), dg.Linear(32, 4))
            if parallel:
                strategy = dg.prepare_context()
                assert strategy.nranks == 1 and strategy.local_rank == 0
                model = dg.DataParallel(model, strategy)
            opt = dg.SGDOptimizer(0.1)
            losses = []
            for xb in data:
                diff = model(dg.to_variable(xb)) - dg.to_variable(xb @ W)
                loss = _mean_sq(dg, diff)
                if parallel:
                    loss = model.scale_loss(loss)
                loss.backward()
                if parallel:
                    model.apply_collective_grads()
                opt.minimize(loss, parameter_list=model.parameters())
                losses.append(float(loss.numpy()[0]))
            return losses, [p.numpy() for p in model.parameters()]

    (la, pa), (lb, pb) = train(False), train(True)
    assert la == lb and la[-1] < la[0]
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(a, b)


def test_data_parallel_over_ranks_raises_naming_item_13():
    with dg.guard(CPU):
        s = dg.ParallelStrategy()
        s.nranks = 2
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            dg.DataParallel(dg.Linear(2, 2), s)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_guard_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with dg.guard():
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with dg.guard(pt.CUDAPlace(0)):
            pass


def test_guard_places_new_vars_and_restores():
    from paddle_tpu_torch.dygraph import base
    assert not dg.enabled()
    with dg.guard(CPU):
        assert dg.enabled()
        assert dg.to_variable(np.ones(2, "float32")).value.device.type == "cpu"
        assert dg.Linear(2, 2).weight.value.device.type == "cpu"
    assert not dg.enabled() and base._state.device is None


def test_dygraph_exports_every_name_of_the_jax_module():
    names = {n for n in dir(jdg) if not n.startswith("_")
             and not isinstance(getattr(jdg, n), type(jdg))}
    missing = sorted(n for n in names if not hasattr(dg, n))
    assert not missing, missing
