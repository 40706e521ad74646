"""``RecomputeOptimizer`` and ``remat_segment`` in the port, and LAMB on
tiny BERT, held against the JAX package on the CPU.

Tiny BERT: L2, H64, A2, vocab 128, S16, B4 (``tests/test_torch_training.py``'s
feeds), f32. ``Lamb`` at its defaults with the LayerNorm parameters
excluded from weight decay (``train_profile.lamb``), plain and under
``RecomputeOptimizer`` with a checkpoint at each encoder layer's output
(``train_profile.encoder_checkpoints``). Tolerances: 3 steps from one state,
dropout 0, losses ``rtol 1e-5`` and every state tensor ``atol 5e-5`` (sums
in other orders, about 1e-6 a step; LAMB's trust ratio is a ratio of two
such sums). Recompute against no recompute in the port, dropout 0.1:
``atol 1e-6`` on the state after a step, since the two differ only in the
order autograd adds a residual's two gradients; a mask drawn again with
another salt would part them by the dropped elements' whole gradients.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.tools import train_profile

B, S, M, VOCAB = 4, 16, 6, 128


def _feeds(seed=0):
    rng = np.random.RandomState(seed)
    return {
        "src_ids": rng.randint(0, VOCAB, (B, S)).astype("int64"),
        "pos_ids": np.tile(np.arange(S), (B, 1)).astype("int64"),
        "sent_ids": np.zeros((B, S), "int64"),
        "input_mask": np.ones((B, S), "float32"),
        "mask_pos": rng.randint(0, B * S, (M, 1)).astype("int64"),
        "mask_label": rng.randint(0, VOCAB, (M, 1)).astype("int64"),
        "nsp_label": rng.randint(0, 2, (B, 1)).astype("int64"),
    }


def _build(pkg, bert, recompute, dropout=0.0, lr=0.01):
    cfg = bert.BertConfig(vocab_size=VOCAB, hidden=64, n_layers=2, n_heads=2,
                          max_seq_len=S, dropout=dropout)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        slots = [("src_ids", "int64"), ("pos_ids", "int64"), ("sent_ids", "int64"),
                 ("input_mask", "float32")]
        ins = [pkg.data(n, [S], t) for n, t in slots]
        ins += [pkg.data(n, [1], "int64") for n in ("mask_pos", "mask_label", "nsp_label")]
        total, _, _ = bert.pretrain(*ins, cfg)
        opt = train_profile.lamb(pkg, lr)
        if recompute:
            opt = pkg.optimizer.RecomputeOptimizer(opt)._set_checkpoints(
                train_profile.encoder_checkpoints(main, cfg.n_layers))
        opt.minimize(total)
    return main, startup, total


def _types(program):
    return [[op.type for op in blk.ops] for blk in program.blocks]


def test_the_recompute_program_is_the_jax_packages():
    """Two ``remat_segment`` ops (embeddings + layer 0, layer 1), their
    sub-blocks, inputs and outputs, the grad ops and the ``lamb`` ops with
    their weight decays, as the JAX package builds them."""
    jm, _, _ = _build(fluid, jbert, True)
    tm, _, _ = _build(pt, tbert, True)
    assert _types(tm) == _types(jm)
    segs = [op for op in tm.global_block().ops if op.type == "remat_segment"]
    jsegs = [op for op in jm.global_block().ops if op.type == "remat_segment"]
    assert len(segs) == 2 and len(tm.blocks) == 3
    for a, b in zip(segs, jsegs):
        assert a.inputs == b.inputs and a.outputs == b.outputs and a.attrs == b.attrs
    assert sum(op.type == "remat_segment_grad" for op in tm.global_block().ops) == 2
    lambs = [op for op in tm.global_block().ops if op.type == "lamb"]
    jlambs = [op for op in jm.global_block().ops if op.type == "lamb"]
    assert [op.attr("weight_decay") for op in lambs] == \
        [op.attr("weight_decay") for op in jlambs]
    assert {op.attr("weight_decay") for op in lambs} == {0.0, 0.01}
    # the checkpoints are the encoder layers' outputs, each a segment's output
    ckpts = train_profile.encoder_checkpoints(_build(pt, tbert, False)[0], 2)
    assert [c in op.output("Out") for c, op in zip(ckpts, segs)] == [True, True]


@pytest.mark.parametrize("recompute", [False, True], ids=["lamb", "recompute_lamb"])
def test_three_lamb_steps_match_jax(recompute):
    jm, js, jt = _build(fluid, jbert, recompute)
    tm, _, tt = _build(pt, tbert, recompute)
    feeds = _feeds()
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    exe = fluid.Executor()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jlosses = [float(exe.run(jm, feed=feeds, fetch_list=[jt])[0][0]) for _ in range(3)]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        texe = pt.Executor(pt.CPUPlace())
        tlosses = [float(texe.run(tm, feed=feeds, fetch_list=[tt])[0][0]) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[2] < tlosses[0]
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=5e-5, err_msg=n)


def _step(program, startup, loss, feeds):
    """One step from the startup state with the run counter at 0: (loss,
    the persistable state)."""
    program._rng_run_counter = startup._rng_run_counter = 0
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        value = exe.run(program, feed=feeds, fetch_list=[loss])[0]
    return float(value[0]), {n: scope.find_var(n).clone() for n in scope.var_names()}


def test_remat_segment_keeps_no_graph_and_recomputes(monkeypatch):
    """The executor never keeps a ``remat_segment``'s forward graph: its
    forward runs without autograd and its grad op runs the sub-block again,
    so each layer's attention runs twice a step (once without recompute),
    and the intermediates of a segment are not kept to the backward pass."""
    kept, attention = [], []
    lower_keeping = treg.lower_keeping_graph

    def spy_keeping(d, ctx, ins, key):
        kept.append(d.type)
        return lower_keeping(d, ctx, ins, key)

    fa = treg._REGISTRY["fused_attention"]
    fa_lower = fa.lower

    def spy_attention(ctx, ins):
        attention.append(torch.is_grad_enabled())
        return fa_lower(ctx, ins)

    monkeypatch.setattr(treg, "lower_keeping_graph", spy_keeping)
    monkeypatch.setattr(fa, "lower", spy_attention)
    feeds = _feeds()
    for recompute, want in ((False, [True, True]), (True, [False, False, True, True])):
        main, startup, loss = _build(pt, tbert, recompute)
        kept.clear()
        attention.clear()        # shape inference ran the lowering on meta tensors
        _step(main, startup, loss, feeds)
        assert attention == want, recompute
        assert ("remat_segment" in kept) is False
        assert ("fused_attention" in kept) is not recompute
    assert treg.get("remat_segment").remat
    assert not any(treg.get(t).remat for t in ("fused_attention", "dropout", "scan"))


def test_recompute_draws_the_forward_dropout_masks():
    """Dropout 0.1: each op inside a segment salts its draws with its own
    output's name, in the forward and in the recompute alike, so a step
    with recompute updates the state as the step without it does."""
    feeds = _feeds()
    loss0, plain = _step(*_build(pt, tbert, False, dropout=0.1), feeds)
    loss1, remat = _step(*_build(pt, tbert, True, dropout=0.1), feeds)
    assert loss0 == loss1
    moved = 0
    for n, t in plain.items():
        if t.is_floating_point():
            np.testing.assert_allclose(remat[n].numpy(), t.numpy(), atol=1e-6, err_msg=n)
            moved += n.endswith("_moment1_0") and bool(t.abs().sum() > 0)
    assert moved > 10
