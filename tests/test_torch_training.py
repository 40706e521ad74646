"""Training through the port: ``append_backward`` + ``Adam.minimize`` +
``Executor.run`` on a tiny BERT pretraining program, held against the JAX
package on the CPU.

Tiny BERT: L2, H64, A2 (head width 32, one the kernels take), vocab 128,
S16, B4, the feeds of tests/test_models.py. Tolerances: the 3-step run in
float32 with dropout 0 holds losses to ``rtol 1e-5`` and every parameter
and optimizer state to ``atol 5e-5``: the two frameworks sum in other
orders (about 1e-6 per step), and Adam's early updates divide by sqrt(v),
about |grad|, so a grad's rounding moves a small parameter's update by up
to that much relative to the learning rate of 5e-3.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import bert as tbert

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


def _build(pkg, bert, dropout=0.0, attn_impl="auto", dtype="float32", lr=0.005):
    cfg = bert.BertConfig(vocab_size=VOCAB, hidden=64, n_layers=2, n_heads=2,
                          max_seq_len=S, dropout=dropout, attn_impl=attn_impl, dtype=dtype)
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 1
    startup.random_seed = 1
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        slots = [("src_ids", "int64"), ("pos_ids", "int64"), ("sent_ids", "int64"),
                 ("input_mask", "float32")]
        ins = [pkg.data(n, [S], t) for n, t in slots]
        ins += [pkg.data(n, [1], "int64") for n in ("mask_pos", "mask_label", "nsp_label")]
        total, _, _ = bert.pretrain(*ins, cfg)
        _, params_grads = pkg.optimizer.Adam(lr).minimize(total)
    return main, startup, total, params_grads


def _persistables(program):
    return {n for n, v in program.global_block().vars.items() if v.persistable}


@pytest.fixture(scope="module")
def programs():
    return _build(fluid, jbert), _build(pt, tbert)


def test_training_program_matches_jax(programs):
    """The same op types in the same order (forward, grad ops, Adam), the
    same (param, grad) pairs and the same persistable state names."""
    (jm, _, _, jpg), (tm, _, _, tpg) = programs
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert [(p.name, g.name) for p, g in tpg] == [(p.name, g.name) for p, g in jpg]
    assert _persistables(tm) == _persistables(jm)
    grad_types = {op.type for op in tm.global_block().ops if op.type.endswith("_grad")}
    assert {"fused_attention_grad", "softmax_with_cross_entropy_grad", "gather_grad",
            "lookup_table_v2_grad", "layer_norm_grad", "mul_grad", "matmul_grad"} <= grad_types
    assert "adam" in {op.type for op in tm.global_block().ops}
    # every grad var copies its forward var's shape and dtype
    for p, g in tpg:
        assert (g.shape, g.dtype) == (p.shape, p.dtype)


def test_three_adam_steps_match_jax(programs):
    (jm, js, jt, _), (tm, _, tt, _) = programs
    feeds = _feeds()
    names = sorted(_persistables(jm))
    exe = fluid.Executor()
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jlosses = [float(exe.run(jm, feed=feeds, fetch_list=[jt])[0][0]) for _ in range(3)]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    texe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(tscope):
        tlosses = [float(texe.run(tm, feed=feeds, fetch_list=[tt])[0][0]) for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[2] < tlosses[0]
    for n in names:
        got = tscope.find_var(n)
        assert tuple(got.shape) == jfinal[n].shape, n
        np.testing.assert_allclose(got.numpy(), jfinal[n], atol=5e-5, err_msg=n)
    # the optimizer state moved: three steps of beta1 powers
    b1p = next(n for n in names if n.endswith("beta1_pow_acc_0"))
    np.testing.assert_allclose(tscope.find_var(b1p).numpy(), [0.9 ** 4], rtol=1e-6)


def test_loss_falls_with_dropout():
    """As tests/test_models.py asserts for the JAX package: dropout 0.1,
    Adam 5e-3, 15 steps on one batch."""
    main, startup, total, _ = _build(pt, tbert, dropout=0.1)
    exe = pt.Executor(pt.CPUPlace())
    feeds = _feeds()
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        losses = [float(exe.run(main, feed=feeds, fetch_list=[total])[0][0])
                  for _ in range(15)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_composed_attention_trains_like_the_fused_op():
    """attn_impl='composed' (matmul/softmax ops) and the fused op take the
    same first step from the same weights, dropout 0."""
    feeds = _feeds(1)
    runs = []
    for impl in ("auto", "composed"):
        main, startup, total, pg = _build(pt, tbert, attn_impl=impl)
        scope = pt.Scope()
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            exe.run(startup)
            loss = exe.run(main, feed=feeds, fetch_list=[total])[0]
        runs.append((loss, {p.name: scope.find_var(p.name).numpy() for p, _ in pg}))
    (la, pa_), (lc, pc) = runs
    assert sorted(pa_) == sorted(pc)
    np.testing.assert_allclose(la, lc, rtol=1e-5)
    for n in pa_:
        np.testing.assert_allclose(pa_[n], pc[n], atol=5e-5, err_msg=n)


def test_bf16_training_runs():
    """bf16 activations and weights, f32 embeddings and optimizer state."""
    main, startup, total, pg = _build(pt, tbert, dtype="bfloat16", lr=1e-3)
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        exe.run(startup)
        before = {p.name: scope.find_var(p.name).clone() for p, _ in pg}
        losses = [float(exe.run(main, feed=_feeds(), fetch_list=[total])[0][0])
                  for _ in range(3)]
    assert np.isfinite(losses).all()
    dtypes = {p.name: scope.find_var(p.name).dtype for p, _ in pg}
    assert dtypes["word_emb"] == torch.float32
    assert dtypes["layer0_attn_qkv_w"] == torch.bfloat16
    still = {n for n, t in before.items() if torch.equal(t, scope.find_var(n))}
    # a bf16 layer-norm scale sits at 1.0, where a bf16 ulp (2^-7) is far
    # above Adam's step of ~1e-3: the update rounds away, as in the JAX package
    assert still and all(n.startswith("layer_norm_") and n.endswith(".w_0") for n in still)
    assert scope.find_var("layer0_attn_qkv_w_moment1_0").dtype == torch.float32


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adam_matches_jax(param_dtype):
    import jax.numpy as jnp
    rng = np.random.RandomState(3)
    p = rng.randn(6, 5).astype("float32")
    ins = {"Param": [p], "Grad": [rng.randn(6, 5).astype("float32")],
           "LearningRate": [np.array([1e-3], "float32")],
           "Moment1": [rng.randn(6, 5).astype("float32") * 0.1],
           "Moment2": [np.abs(rng.randn(6, 5)).astype("float32") * 0.01],
           "Beta1Pow": [np.array([0.9 ** 2], "float32")],
           "Beta2Pow": [np.array([0.999 ** 2], "float32")]}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
    low = lambda s: param_dtype == "bfloat16" and s in ("Param", "Grad")
    jouts = jreg.get("adam").lower(jreg.LowerCtx(attrs), {
        s: [jnp.asarray(a, jnp.bfloat16 if low(s) else jnp.float32) for a in v]
        for s, v in ins.items()})
    touts = treg.get("adam").lower(treg.LowerCtx(attrs), {
        s: [torch.from_numpy(a).to(torch.bfloat16 if low(s) else torch.float32) for a in v]
        for s, v in ins.items()})
    assert touts["ParamOut"][0].dtype == getattr(torch, param_dtype)
    for s in touts:
        np.testing.assert_allclose(touts[s][0].float().numpy(),
                                   np.asarray(jouts[s][0], np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=s)


def test_clip_and_regularizer_refuse():
    """A clip attr that is not a clip class, or a regularization that is not
    a regularizer, is refused, as in the JAX package (it has no method to
    append its ops); a regularizer appends its ops (tests/test_torch_clip.py
    holds the clip classes and the regularizers against the JAX package)."""
    from paddle_tpu_torch.clip import append_gradient_clip_ops
    from paddle_tpu_torch.regularizer import append_regularization_ops
    main, _, _, pg = _build(pt, tbert)
    p, g = pg[0]
    p.gradient_clip = object()
    with pytest.raises(AttributeError, match="_create_operators"):
        append_gradient_clip_ops([(p, g)])
    p.gradient_clip = None
    with pytest.raises(AttributeError, match="append_regularization_op"):
        append_regularization_ops([(p, g)], regularization=object())
    assert append_regularization_ops([(p, g)]) == [(p, g)]
    with pt.program_guard(main):
        (p2, g2), = append_regularization_ops([(p, g)],
                                              regularization=pt.regularizer.L2Decay(0.1))
    assert p2 is p and g2.name == g.name + "@REG"
    assert [op.type for op in main.global_block().ops[-2:]] == ["scale", "sum"]
