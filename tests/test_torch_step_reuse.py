"""Grads that reuse the forward: a training step runs each forward lowering
once, and its grad ops differentiate the graphs the forward ops kept (the
port's counterpart of XLA's CSE of the JAX grad op's ``jax.vjp`` recompute).

Held on the CPU at small sizes: the tiny BERT of ``test_torch_training.py``
(L2 H64, dropout 0.1, so the kept graph must carry the forward's masks) and
the one-block-per-stage ResNet-50 of ``test_torch_resnet.py`` at 64 x 64
(33 chains cut to 9 fused ones, batch norms, Momentum). Against the
recompute path (``Executor._reuse_forward = False``, one update op at a
time) the results are equal bit for bit in f32: the same lowerings run on
the same tensors, only once. Against the JAX package the existing tests
(``test_three_adam_steps_match_jax``, ``test_three_momentum_steps_match_jax``)
run the new path with their own tolerances.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib import fuse_conv_bn_stats as tfuse
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor import trace_block
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.ops import multi_tensor
from tests import test_torch_resnet as tr
from tests import test_torch_training as tt


def _bert():
    main, startup, loss, _ = tt._build(pt, tbert, dropout=0.1)
    return main, startup, loss, tt._feeds()


def _resnet(monkeypatch):
    monkeypatch.setitem(tres._DEPTHS, 50, [1, 1, 1, 1])
    main, startup, loss, fused, _ = tr._build(pt, tres, tfuse)
    assert fused == 9
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(2, 64, 64, 3).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    return main, startup, loss, feed


@pytest.fixture(params=["bert", "resnet"])
def model(request, monkeypatch):
    return _bert() if request.param == "bert" else _resnet(monkeypatch)


def _init(startup, main):
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {n: scope.find_var(n).clone() for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _steps(main, loss, feed, init, n, reference=False):
    """``n`` steps from ``init``: (losses, final scope)."""
    scope = pt.Scope()
    for k, t in init.items():
        scope.set_var(k, t.clone())
    exe = pt.Executor(pt.CPUPlace())
    if reference:
        exe._reuse_forward = exe._group_updates = False
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        losses = [exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)[0]
                  for _ in range(n)]
    return losses, scope


def _spy_lowerings(monkeypatch):
    """Count every call of every registered lowering on real tensors. A
    generic grad op's recompute calls its forward's lowering, so it counts
    there."""
    calls = collections.Counter()
    for t, d in list(treg._REGISTRY.items()):
        def spy(ctx, ins, _t=t, _lower=d.lower):
            if not ctx.abstract:
                calls[_t] += 1
            return _lower(ctx, ins)
        monkeypatch.setattr(d, "lower", spy)
    return calls


def test_each_forward_lowering_runs_once_a_step(model, monkeypatch):
    main, startup, loss, feed = model
    init = _init(startup, main)
    calls = _spy_lowerings(monkeypatch)
    types = [op.type for op in main.global_block().ops]
    forward = collections.Counter(t for t in types if not t.endswith("_grad")
                                  and t not in multi_tensor.GROUPED)
    with_generic_grad = collections.Counter(
        f for t in types if (f := treg.generic_grad_forward(t)) is not None)
    assert with_generic_grad["fused_attention" if "fused_attention" in forward
                             else "conv2d_bn_fused"] > 0
    _steps(main, loss, feed, init, 1)
    assert {t: calls[t] for t in forward} == dict(forward)
    calls.clear()
    _steps(main, loss, feed, init, 1, reference=True)   # the recompute path: twice
    assert {t: calls[t] for t in forward} == {
        t: n + with_generic_grad[t] for t, n in forward.items()}


def test_three_steps_equal_the_recompute_path_bit_for_bit(model):
    main, startup, loss, feed = model
    init = _init(startup, main)
    losses, scope = _steps(main, loss, feed, init, 3)
    ref_losses, ref_scope = _steps(main, loss, feed, init, 3, reference=True)
    for a, b in zip(losses, ref_losses):
        assert torch.equal(a, b)
    assert float(losses[2][0]) < float(losses[0][0])
    moved = 0
    for n in init:
        a, b = scope.find_var(n), ref_scope.find_var(n)
        assert a.dtype == b.dtype and torch.equal(a, b), n
        moved += not torch.equal(a, init[n])
    assert moved > len(init) // 2


def test_no_graph_outlives_a_run(model, monkeypatch):
    """The table is emptied when the run ends; nothing the run leaves in the
    scope or returns carries a graph (a batch norm's MeanOut is made under
    autograd in the ResNet)."""
    main, startup, loss, feed = model
    init = _init(startup, main)
    tables, sizes = [], []
    generic = treg._generic_grad_lower

    def spy(fwd, ctx, ins):
        tables.append(ctx.graphs)
        sizes.append(len(ctx.graphs))
        return generic(fwd, ctx, ins)
    monkeypatch.setattr(treg, "_generic_grad_lower", spy)
    losses, scope = _steps(main, loss, feed, init, 1)
    assert max(sizes) > 0
    assert all(t is tables[0] for t in tables) and tables[0] == {}
    for n in scope.var_names():
        t = scope.find_var(n)
        assert t.grad_fn is None and not t.requires_grad, n
    assert losses[0].grad_fn is None and not losses[0].requires_grad

    def failing(fwd, ctx, ins):     # a run that fails half way, with graphs kept
        tables.append(ctx.graphs)
        assert len(ctx.graphs) > 0
        raise ValueError("injected")
    monkeypatch.setattr(treg, "_generic_grad_lower", failing)
    with pytest.raises(RuntimeError, match="injected"):
        _steps(main, loss, feed, init, 1)
    assert tables[-1] == {}


def _rebind_block(rebind):
    """tanh(a) -> b; optionally scale(c) -> a (rebinding a); then tanh's grad
    op, which reads a from env when it runs."""
    prog = pt.Program()
    blk = prog.global_block()
    for n in ("a", "b", "c", "b@GRAD", "a@GRAD"):
        blk.create_var(n, [3, 4], "float32")
    fwd = blk.append_op("tanh", inputs={"X": ["a"]}, outputs={"Out": ["b"]})
    if rebind:
        blk.append_op("scale", inputs={"X": ["c"]}, outputs={"Out": ["a"]},
                      attrs={"scale": 2.0})
    desc, = treg.make_grad_op_descs(fwd, {"b": "b@GRAD"})
    blk.append_op(desc["type"], inputs=desc["inputs"], outputs=desc["outputs"],
                  attrs=desc["attrs"])
    return blk


@pytest.mark.parametrize("rebind", [False, True])
def test_identity_guard_recomputes_a_rebound_input(rebind, monkeypatch):
    rng = np.random.RandomState(0)
    feed = {n: torch.from_numpy(rng.randn(3, 4).astype("float32")) for n in ("a", "c", "b@GRAD")}
    calls = _spy_lowerings(monkeypatch)
    outs = {}
    for reuse in (True, False):
        env = dict(feed)
        with torch.no_grad():
            trace_block(_rebind_block(rebind), env, "cpu", reuse_forward=reuse)
        outs[reuse] = env["a@GRAD"]
    # the forward ran once; its grad op reran it only when its input was rebound
    assert calls["tanh"] == (2 if rebind else 1) + 2
    assert torch.equal(outs[True], outs[False])
    a = 2.0 * feed["c"] if rebind else feed["a"]
    np.testing.assert_allclose(outs[True].numpy(),
                               ((1 - torch.tanh(a) ** 2) * feed["b@GRAD"]).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_a_second_grad_op_of_one_forward_recomputes(monkeypatch):
    """Two grad ops of one forward (a second backward pass): the first takes
    the kept graph, the second recomputes, as the reference does."""
    blk = _rebind_block(False)
    grad = blk.ops[-1]
    blk.append_op(grad.type, inputs={s: list(n) for s, n in grad.inputs.items()},
                  outputs={"X@GRAD": ["a@GRAD2"]}, attrs=dict(grad.attrs))
    calls = _spy_lowerings(monkeypatch)
    rng = np.random.RandomState(1)
    env = {n: torch.from_numpy(rng.randn(3, 4).astype("float32")) for n in ("a", "b@GRAD")}
    with torch.no_grad():
        trace_block(blk, env, "cpu")
    assert calls["tanh"] == 2
    assert torch.equal(env["a@GRAD"], env["a@GRAD2"])
