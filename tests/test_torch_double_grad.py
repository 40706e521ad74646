"""Second-order gradients in the port, held against the JAX package on the
CPU: the 12 op cases of tests/test_double_grad.py as program-level
``gradients`` of ``gradients`` (``paddle_tpu_torch/tools/double_grad.py``),
the gradient-penalty objective over 20 Adam steps, the third-order
refusal, what a second order does through the kernels' autograd
Functions, and first-order steps left as they were.

Tolerances: each op case's own (``double_grad.CASES``: f32 ``1e-5``
relative and absolute, ``1e-4`` for conv2d, the norms and the products,
whose sums run in other orders); the penalty's losses ``rtol 1e-5`` over
20 steps (f32, the same weights); the VGG-16 chapter under the penalty:
step 1's total and penalty ``rtol 1e-5`` (the same weights), step 2's
``rtol 2e-3``: Adam's first update is lr * g / |g| elementwise, so an
element whose gradient is near 0 moves by up to 2 lr on one side and not
the other when the two round its gradient apart, and the penalty after
the step (0.13, down from 3.3) is a sum of squared input gradients over
13 layers of such weights (measured 9.4e-4). The port's kept-graph path
against its recompute path: bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.ops import pallas_conv_bn as jpc
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.tools import book
from paddle_tpu_torch.tools import double_grad as dg
from paddle_tpu_torch.tools import train_profile


def _jax_run(main, feed, fetch, startup=None):
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor()
        if startup is not None:
            exe.run(startup)
        return exe.run(main, feed=feed, fetch_list=fetch)


def _port_run(main, feed, fetch, reuse=True):
    exe = pt.Executor(pt.CPUPlace())
    exe._reuse_forward = reuse
    with pt.scope_guard(pt.Scope()):
        return exe.run(main, feed=feed, fetch_list=fetch)


@pytest.mark.parametrize("name", sorted(dg.CASES))
def test_second_order_op_case_matches_jax(name):
    """The objective and each checked input's second-order gradient, built
    by two ``gradients`` passes in each package, on the same inputs."""
    tol = dg.CASES[name].tol
    jm, jfeed, jfetch = dg.build(fluid, name)
    want = _jax_run(jm, jfeed, jfetch)
    got = dg.run(name, "cpu")
    assert len(got) == len(want) == 1 + len(dg.CASES[name].check)
    for g, w, n in zip(got, want, jfetch):
        np.testing.assert_allclose(g, np.asarray(w), atol=tol, rtol=tol, err_msg=n)


@pytest.mark.parametrize("name", ["conv2d", "layer_norm", "batch_norm", "tanh"])
def test_kept_graphs_serve_second_order_bit_for_bit(name, monkeypatch):
    """Each first-pass grad op is kept as the forward of its ``_grad_grad``
    op (its graph to its own inputs), and the result is bit for bit the
    recompute path's (``_reuse_forward = False``)."""
    kept = []
    keeping = treg.lower_keeping_graph
    monkeypatch.setattr(treg, "lower_keeping_graph",
                        lambda d, ctx, ins, key: (kept.append(d.type),
                                                  keeping(d, ctx, ins, key))[1])
    main, feed, fetch = dg.build(pt, name)
    op = dg.CASES[name].op
    assert sum(o.type == op + "_grad_grad" for o in main.global_block().ops) == 1
    reused = _port_run(main, feed, fetch)
    assert op + "_grad" in kept
    recomputed = _port_run(main, feed, fetch, reuse=False)
    for a, b, n in zip(reused, recomputed, fetch):
        assert np.array_equal(a, b), n


def test_gradient_penalty_losses_match_jax_over_20_steps():
    """The WGAN-GP objective of test_double_grad.py: loss + 10 * mean((|d
    loss / d x| - 1)^2) minimised by Adam, the optimizer's backward pass
    differentiating through the first ``gradients`` pass: the same program
    in both, and the penalty of each of 20 steps from the same weights."""
    jm, js, _, jp = dg.build_penalty(fluid)
    tm, _, _, tp = dg.build_penalty(pt)
    assert [op.type for op in tm.global_block().ops] == [op.type for op in jm.global_block().ops]
    feed = dg.penalty_feed()
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor()
        exe.run(js)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        want = [float(np.asarray(exe.run(jm, feed=feed, fetch_list=[jp])[0]).reshape(()))
                for _ in range(20)]
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        texe = pt.Executor(pt.CPUPlace())
        got = [float(np.asarray(texe.run(tm, feed=feed, fetch_list=[tp])[0]).reshape(()))
               for _ in range(20)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]


def test_third_order_raises_as_jax():
    """A ``*_grad_grad`` op names slots on both sides; both packages refuse
    its gradient with the same message."""
    msgs = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.data("x", [4], "float32")
            x.stop_gradient = False
            y = pkg.layers.tanh(x)
            g1, = pkg.gradients([pkg.layers.mean(y)], [x])
            g2, = pkg.gradients([pkg.layers.mean(g1)], [x])
            with pytest.raises(NotImplementedError, match="third-order") as e:
                pkg.gradients([pkg.layers.mean(g2)], [x])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_second_order_through_dropout_reuses_the_forward_mask():
    """Through dropout the second-order gradient of sum(dropout(x)^2) is
    2 * Mask^2 / (1 - p)^2 * v with the forward's own Mask, on the kept
    path and the recompute path alike. The JAX package recomputes the grad
    op inside its ``_grad_grad`` op with that op's salt and draws another
    mask there (ROADMAP fault 3.13): its result parts from its own formula
    where the two masks differ."""
    feed = dg.dropout_feed()
    main, fetch = dg.build_dropout(pt)
    for reuse in (True, False):
        y, g, h, mask = _port_run(main, feed, fetch, reuse)
        assert max(dg.dropout_gaps(y, g, h, mask, feed["v"])) <= 1e-6
    main, fetch = dg.build_dropout(fluid)
    y, g, h, mask = (np.asarray(a) for a in _jax_run(main, feed, fetch))
    g_gap, h_gap = dg.dropout_gaps(y, g, h, mask, feed["v"])
    assert g_gap <= 1e-6 and h_gap > 0.1


def test_fused_attention_second_order_against_jax():
    """Through ``fused_attention`` the JAX package computes a second-order
    gradient on its composed route and raises on its Pallas kernel (in
    interpret mode: ``pallas_call`` has no reverse-mode rule). The port's
    CPU route is the plain attention: it gives the composed route's values
    for every impl; the card's kernel route raises (the next test)."""
    jm, jfeed, jfetch = dg.build(fluid, dg.attention_case("composed"))
    want = _jax_run(jm, jfeed, jfetch)
    for impl in ("auto", "composed"):
        tm, tfeed, tfetch = dg.build(pt, dg.attention_case(impl))
        got = _port_run(tm, tfeed, tfetch)
        for g, w, n in zip(got, want, jfetch):
            np.testing.assert_allclose(g, np.asarray(w), atol=dg.SUMS, rtol=dg.SUMS, err_msg=n)
    jm, jfeed, jfetch = dg.build(fluid, dg.attention_case("pallas"))
    with pytest.raises(Exception):
        _jax_run(jm, jfeed, jfetch)


def test_flash_attention_function_refuses_second_order(monkeypatch):
    """``FlashAttention`` (the kernels' autograd pair) on CPU stand-ins for
    the two kernels: a first-order gradient is the backward kernel's, and
    a gradient with ``create_graph`` raises, naming the missing
    double-backward kernel, instead of giving tensors with no graph (a
    silent zero second order)."""
    def fwd(q, k, v, bias, scale, causal, dropout, seed, return_lse=False, block_q=128):
        o = fa.attention_plain(q, k, v, bias, scale, causal)
        return (o, torch.zeros(q.shape[:3])) if return_lse else o

    def bwd(q, k, v, bias, o, lse, do, scale, causal, dropout, seed):
        return fa.attention_bwd_plain(q, k, v, bias, o, do, scale, causal)

    monkeypatch.setattr(fa, "flash_attn_fwd", fwd)
    monkeypatch.setattr(fa, "flash_attn_bwd", bwd)
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 16, 8).astype("float32")).requires_grad_()
               for _ in range(3))
    out = fa.FlashAttention.apply(q, k, v, None, 0.25, False, 0.0, 0)
    dq, = torch.autograd.grad(out.square().sum(), [q])
    ref = fa.attention_plain(q, k, v, None, 0.25, False)
    np.testing.assert_allclose(dq, torch.autograd.grad(ref.square().sum(), [q])[0],
                               atol=1e-5, rtol=1e-5)
    out = fa.FlashAttention.apply(q, k, v, None, 0.25, False, 0.0, 0)
    with pytest.raises(NotImplementedError, match="double-backward kernel of flash_attn_bwd"):
        torch.autograd.grad(out.square().sum(), [q], create_graph=True)


def test_conv2d_bn_fused_second_order_raises_as_jax():
    """Through ``conv2d_bn_fused`` the JAX package raises on its kernel
    route; the port's op runs ``FusedConv1x1BN`` on both devices, and a
    second order through it raises on the CPU here (on both paths), naming
    why. Its first-order gradient still runs."""
    case = dg.conv_bn_case()
    assert jpc.supports_fused(7 * 8 * 8, 64, 128)
    jm, jfeed, jfetch = dg.build(fluid, case)
    with pytest.raises(Exception):
        _jax_run(jm, jfeed, jfetch)
    tm, tfeed, tfetch = dg.build(pt, case)
    for reuse in (True, False):
        with pytest.raises(NotImplementedError, match="conv2d_bn_fused"):
            _port_run(tm, tfeed, tfetch, reuse)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        block = main.global_block()
        for slot, arr in case.inputs.items():
            block.create_var(slot, arr.shape, "float32", is_data=True).stop_gradient = False
        block.append_op("conv2d_bn_fused", inputs={s: [s] for s in case.inputs},
                        outputs={s: [s + "@OUT"] for s in case.outputs}, attrs=case.attrs)
        gx, = pt.gradients([pt.layers.mean(block.var("Y@OUT"))], [block.var("Input")])
    assert np.isfinite(_port_run(main, tfeed, [gx])[0]).all()


def test_first_order_steps_keep_create_graph_off(monkeypatch):
    """A first-order training step (tiny BERT with dropout 0.1 and fused
    attention) calls ``torch.autograd.grad`` without ``create_graph`` in
    every grad op, and its grad ops take their forwards' kept graphs as
    before: the second-order machinery costs it nothing."""
    calls, kept = [], []
    grad = torch.autograd.grad

    def spy(*a, **kw):
        calls.append(kw.get("create_graph", False))
        return grad(*a, **kw)

    keeping = treg.lower_keeping_graph
    monkeypatch.setattr(torch.autograd, "grad", spy)
    monkeypatch.setattr(treg, "lower_keeping_graph",
                        lambda d, ctx, ins, key: (kept.append(d.type),
                                                  keeping(d, ctx, ins, key))[1])
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(vocab_size=128, hidden=64, n_layers=2, n_heads=2, max_seq_len=16,
                          dropout=0.1)
    main, startup, total, _ = train_profile.build_pretrain(cfg, 4, 16, 2, lr=0.01)
    feed = train_profile.pretrain_feed(np.random.RandomState(0), cfg, 4, 16, 2)
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        calls.clear()
        exe.run(main, feed=feed, fetch_list=[total])
    n_grads = sum(treg.generic_grad_forward(op.type) is not None
                  for op in main.global_block().ops)
    assert calls and not any(calls)
    assert kept.count("fused_attention") == 2 and len(kept) == n_grads
    assert not any(t.endswith("_grad") for t in kept)


def test_vgg16_chapter_under_the_input_gradient_penalty_matches_jax():
    """The image chapter under the input-gradient penalty
    (``book.build_image_penalty``) at batch 2, dropout 0: the total and the
    penalty of 2 Adam steps from the same weights, in each package."""
    from paddle_tpu.models import vgg as jvgg
    from paddle_tpu_torch.models import vgg as tvgg
    jch, jpen = book.build_image_penalty(fluid, jvgg, dropout=0.0)
    tch, tpen = book.build_image_penalty(pt, tvgg, dropout=0.0)
    assert [op.type for op in tch.main.global_block().ops] == \
        [op.type for op in jch.main.global_block().ops]
    assert sum(op.type.endswith("_grad_grad") for op in tch.main.global_block().ops) > 40
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(2, 3, 32, 32).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    names = sorted(n for n, v in jch.main.global_block().vars.items() if v.persistable)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor()
        exe.run(jch.startup)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        want = [exe.run(jch.main, feed=feed, fetch_list=[jch.loss, jpen]) for _ in range(2)]
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        texe = pt.Executor(pt.CPUPlace())
        got = [texe.run(tch.main, feed=feed, fetch_list=[tch.loss, tpen]) for _ in range(2)]
    got = np.array(got, dtype=np.float64).reshape(2, 2)
    want = np.array(want, dtype=np.float64).reshape(2, 2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=2e-3)
    assert got[1, 1] < got[0, 1]
