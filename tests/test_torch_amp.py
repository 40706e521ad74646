"""Automatic mixed precision in the port (``contrib/mixed_precision.py``),
held against the JAX package on the CPU: the rewritten programs' dtypes,
five ``decorate(Adam)`` steps, and the loss-scale trajectory across an
overflow.

The programs are ``tools/train_profile.py``'s builders at tiny sizes: the
MNIST MLP at batch 8 and the Transformer at hidden 32, 2 + 2 layers, 4
heads, FFN 64, vocabularies 40, batch 4, length 12, dropout 0.

Limits. Dtypes: every float variable's dtype equal to the JAX program's
(integer widths compared as one class: the JAX package runs with x64 off).
Five bf16 steps from the same weights: the loss within 1e-2 relative and
the update (the state's change over the steps, all parameters together)
within 0.1 relative L1 of the JAX package's, ``chip_smoke.py``'s
``TRAIN_LOSS_REL`` / ``TRAIN_UPDATE_REL`` for two bf16 paths: the two round
each product's bf16 inputs alike but sum in other orders, and Adam's
update is about lr * sign(g), so it parts only where a gradient element
is below its rounding. Loss scaling: the scales exactly; the losses before
the overflow within 1e-2 relative (bf16 and fp16 products); the
parameters across the overflowed step bit for bit.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import transformer as jtrans
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import transformer as ttrans
from paddle_tpu_torch.tools import train_profile as tp

LOSS_REL, UPDATE_REL = 1e-2, 0.1
MLP_BATCH, NMT_BATCH, NMT_SEQ, VOCAB = 8, 4, 12, 40


def _nmt_cfg(module):
    return module.TransformerConfig(src_vocab=VOCAB, trg_vocab=VOCAB, hidden=32, n_layers=2,
                                    n_heads=4, ffn_hidden=64, max_len=NMT_SEQ, dropout=0.0)


def _build(pkg, model, optimizer):
    if model == "mnist":
        main, startup, loss, _, _ = tp.build_mnist(batch=MLP_BATCH, optimizer=optimizer, pkg=pkg,
                                                   model=jmnist if pkg is fluid else tmnist)
    else:
        module = jtrans if pkg is fluid else ttrans
        main, startup, loss, _ = tp.build_transformer(
            _nmt_cfg(module), NMT_BATCH, NMT_SEQ, lr=0.01,
            optimizer=lambda p, rate: optimizer(p), pkg=pkg, model=module)
    return main, startup, loss


def _feeds(model, steps):
    if model == "mnist":
        return [tp.mnist_feed(np.random.RandomState(i), MLP_BATCH) for i in range(steps)]
    rng = np.random.RandomState(0)
    pos = np.tile(np.arange(NMT_SEQ), (NMT_BATCH, 1)).astype("int64")
    ids = lambda: rng.randint(0, VOCAB, (NMT_BATCH, NMT_SEQ)).astype("int64")
    ones = np.ones((NMT_BATCH, NMT_SEQ), "float32")
    return [{"src": ids(), "spos": pos, "smask": ones, "trg": ids(), "tpos": pos,
             "tmask": ones, "lbl": ids()} for _ in range(steps)]


def _kind(dtype):
    return "int" if "int" in dtype else dtype


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


def _run(jm, js, tm, fetch_j, fetch_t, feeds):
    """The JAX program from its startup, and the port's from the same state:
    (JAX fetches, port fetches, initial, JAX final and port final state;
    the fetches as numpy per step)."""
    names = _persistables(jm)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor()
        exe.run(js)
        init = {n: np.array(scope.find_var(n)) for n in names}
        jouts = [[np.asarray(v) for v in exe.run(jm, feed=f, fetch_list=fetch_j)]
                 for f in feeds]
        jfinal = {n: np.asarray(scope.find_var(n), np.float32) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy({n: np.array(v) for n, v in init.items()},
                                                        device="cpu"))
    touts = []
    with pt.scope_guard(tscope):
        texe = pt.Executor(pt.CPUPlace())
        for f in feeds:
            touts.append(texe.run(tm, feed=f, fetch_list=fetch_t))
            touts[-1].append({n: tscope.find_var(n).float().numpy().copy() for n in names})
    return jouts, touts, init, jfinal


@pytest.mark.parametrize("model", ["mnist", "transformer"])
def test_rewritten_dtypes_equal_jax(model):
    """``decorate`` at its defaults (bf16, no scaling): the same casts before
    the same ops, and every variable of the rewritten program in the JAX
    program's dtype (the rewritten ops' outputs re-inferred on meta
    tensors, as JAX infers them with ``eval_shape``)."""
    opt = tp.amp_adam
    jm, _, _ = _build(fluid, model, lambda p: opt(p, 1e-3))
    tm, _, _ = _build(pt, model, lambda p: opt(p, 1e-3))
    jops, tops = jm.global_block().ops, tm.global_block().ops
    assert [op.type for op in tops] == [op.type for op in jops]
    casts = [op for op in tops if op.type == "cast"]
    assert casts and [(op.input("X"), op.output("Out"), op.attrs) for op in casts] == \
        [(op.input("X"), op.output("Out"), op.attrs) for op in jops if op.type == "cast"]
    jv = {n: _kind(v.dtype) for b in jm.blocks for n, v in b.vars.items()}
    tv = {n: _kind(v.dtype) for b in tm.blocks for n, v in b.vars.items()}
    assert tv == jv
    white = pt.contrib.mixed_precision.AutoMixedPrecisionLists().white_list
    assert any(tm.global_block().var(op.input("X")[0]).dtype == "bfloat16"
               for op in tops if op.type in white)
    # no loss-scaling state at the defaults
    assert not any(n.startswith("loss_scaling") for n in tm.global_block().vars)


def test_the_op_lists_are_the_jax_packages():
    mp = pt.contrib.mixed_precision
    jmp = fluid.contrib.mixed_precision
    for args in ((), (["relu"], ["mul"])):
        a, b = mp.AutoMixedPrecisionLists(*args), jmp.AutoMixedPrecisionLists(*args)
        assert a.white_list == b.white_list and a.black_list == b.black_list
    assert "mul" not in mp.AutoMixedPrecisionLists(None, ["mul"]).white_list


@pytest.mark.parametrize("model", ["mnist", "transformer"])
def test_five_adam_steps_match_jax_at_bf16_limits(model):
    """``decorate(Adam)``: 5 steps on one batch from the same weights; each
    step's loss and the update over the 5 steps against the JAX package's."""
    lr = 1e-3 if model == "mnist" else 0.01
    jm, js, jl = _build(fluid, model, lambda p: tp.amp_adam(p, lr))
    tm, _, tl = _build(pt, model, lambda p: tp.amp_adam(p, lr))
    jouts, touts, init, jfinal = _run(jm, js, tm, [jl], [tl], _feeds(model, 1) * 5)
    jl_ = np.array([float(o[0].reshape(-1)[0]) for o in jouts])
    tl_ = np.array([float(o[0].reshape(-1)[0]) for o in touts])
    assert np.all(np.abs(tl_ - jl_) <= LOSS_REL * np.abs(jl_)), (tl_, jl_)
    tfinal = touts[-1][-1]
    num = sum(np.abs((tfinal[n] - init[n]) - (jfinal[n] - init[n])).sum() for n in init)
    den = sum(np.abs(jfinal[n] - init[n]).sum() for n in init)
    assert den > 0 and num / den <= UPDATE_REL, num / den
    assert tl_[-1] < tl_[0]


@pytest.mark.parametrize("dest", ["float16", "bfloat16"])
def test_loss_scale_across_an_overflow(dest):
    """Dynamic loss scaling (init 1024, grow by 2 after 2 finite steps,
    halve on an overflow) on the MNIST MLP under ``SGD(0.01)`` for 6 steps,
    step 3 fed an image holding inf: the scale after each step is 1024,
    2048, 1024, 1024, 2048, 2048, and step 3 leaves every parameter as it
    was (its gradients zeroed). The JAX package agrees up to the overflow,
    and then writes NaN into its parameters: its unscale multiplies the
    overflowed gradients by 0, and inf * 0 is NaN (ROADMAP fault 3.12)."""
    holder = {}

    def opt(p):
        holder[p] = p.contrib.mixed_precision.decorate(
            p.optimizer.SGD(0.01), dest_dtype=dest, use_dynamic_loss_scaling=True,
            init_loss_scaling=1024.0, incr_every_n_steps=2)
        return holder[p]

    jm, js, jl = _build(fluid, "mnist", opt)
    tm, _, tl = _build(pt, "mnist", opt)
    feeds = _feeds("mnist", 6)
    feeds[2]["img"][0, 0] = np.inf
    jscale, tscale = holder[fluid].get_loss_scaling(), holder[pt].get_loss_scaling()
    jouts, touts, init, _ = _run(jm, js, tm, [jl, jscale], [tl, tscale], feeds)
    scales = [float(o[1].reshape(-1)[0]) for o in touts]
    assert scales == [1024.0, 2048.0, 1024.0, 1024.0, 2048.0, 2048.0]
    assert [float(o[1].reshape(-1)[0]) for o in jouts][:3] == scales[:3]
    losses = [float(o[0].reshape(-1)[0]) for o in touts]
    for t, j in zip(losses[:2], jouts[:2]):
        assert abs(t - float(j[0].reshape(-1)[0])) <= LOSS_REL * abs(t)
    assert np.isnan(losses[2]) and np.isfinite(losses[3:]).all()
    params = [p.name for p in tm.global_block().all_parameters()]
    before, after = touts[1][-1], touts[2][-1]
    assert len(params) == 6 and all(np.array_equal(before[n], after[n]) for n in params)
    assert all(not np.array_equal(after[n], touts[3][-1][n]) for n in params)
    assert not np.isfinite(float(np.asarray(jouts[3][0]).reshape(-1)[0]))
