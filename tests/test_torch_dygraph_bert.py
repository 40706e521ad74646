"""The dygraph slice as a whole, on the CPU at a small width: BERT's encoder
composed from dygraph layers (``tools/dygraph_bert.py``), trained eagerly,
traced to a static Program and served.

- The port's dygraph encoder against the port's static ``models.bert.encoder``
  program from the same weights (``static_names``), three ``Adam`` steps of
  mean(square(out)) at dropout 0: every loss at ``rtol 1e-5`` (both sum in
  float32 in other orders).
- The same dygraph encoder built with the JAX package's dygraph, from the
  same weights, three ``Adam`` steps of mean(out * proj) (a random
  projection): the losses and every trained parameter at ``rtol 1e-5,
  atol 1e-6``.
- With dropout 0.1: finite losses, and each step's ``fused_attention`` grad
  op replays its forward's salt.
- Traced in eval mode: the op types equal the JAX transcription's; the
  traced program on the port's executor at batch 2 and 1, and the export
  through ``Predictor(device="cpu")``, agree with the eager output at
  ``rtol 1e-5, atol 1e-5``.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import dygraph as jdg
import paddle_tpu_torch as pt
from paddle_tpu_torch import dygraph as dg
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.tools import dygraph_bert as db

CPU = pt.CPUPlace()
B, S, LR, STEPS = 2, 8, 1e-3, 3


def _cfg(dropout=0.0):
    return bert.BertConfig(vocab_size=50, hidden=64, n_layers=2, n_heads=2, ffn_hidden=96,
                           max_seq_len=16, dropout=dropout)


@pytest.fixture(scope="module")
def static_run():
    """The static program's startup weights and its losses over STEPS."""
    cfg = _cfg()
    main, startup, _, total = db.static_encoder(pt, bert, cfg, B, S, LR)
    feed = db.feed(np.random.RandomState(0), cfg, B, S)
    scope = pt.Scope()
    exe = pt.Executor(CPU)
    with pt.scope_guard(scope):
        exe.run(startup)
        init = {p.name: scope.find_var(p.name).clone() for p in main.all_parameters()}
        losses = [float(exe.run(main, feed=feed, fetch_list=[total])[0].reshape(-1)[0])
                  for _ in range(STEPS)]
    return init, feed, losses


def _train(pkg, init, feed, cfg, steps=STEPS, proj=None):
    """``steps`` Adam steps of mean(square(out)), or with ``proj`` of
    mean(out * proj). Returns the losses and the trained parameters."""
    with pkg.guard(CPU) if pkg is dg else pkg.guard():
        uname = pt.unique_name if pkg is dg else fluid.unique_name
        with uname.guard():
            model = db.build_encoder(cfg, pkg)
        db.load_static_state(model, {k: np.asarray(v) for k, v in init.items()})
        opt = pkg.AdamOptimizer(LR)
        ins = [pkg.to_variable(feed[n]) for n, _ in db.FEEDS]
        losses = []
        for _ in range(steps):
            out = model(*ins)
            if proj is None:
                total = db.loss(pkg, out)
            else:
                total = pkg.trace_op("mean", {"X": [out * pkg.to_variable(proj)]}, {},
                                     ["Out"])["Out"][0]
            opt.minimize(total, parameter_list=model.parameters())
            losses.append(float(total.numpy().reshape(-1)[0]))
        params = {db.static_names(model)[n]: p.numpy() for n, p in model.named_parameters()}
    return losses, params


def test_static_names_cover_the_static_program():
    cfg = _cfg()
    main, _, _, _ = db.static_encoder(pt, bert, cfg, B, S, LR)
    with dg.guard(CPU), pt.unique_name.guard():
        model = db.build_encoder(cfg)
    names = db.static_names(model)
    static = {p.name: p.shape for p in main.all_parameters()}
    assert sorted(names.values()) == sorted(static)
    for n, p in model.named_parameters():
        assert tuple(p.shape) == tuple(static[names[n]]), n


def test_dygraph_bert_matches_static_program(static_run):
    init, feed, static_losses = static_run
    losses, _ = _train(dg, init, feed, _cfg())
    np.testing.assert_allclose(losses, static_losses, rtol=1e-5)
    assert losses[-1] < losses[0]


def test_dygraph_bert_matches_jax_dygraph(static_run):
    """Under mean(out * proj), a random projection: mean(square(out)) of a
    layer norm's output has gradients of rounding size before the last layer
    norm (its output's norm does not move), which Adam scales up to the step
    size with the rounding's sign."""
    init, feed, _ = static_run
    proj = np.random.RandomState(2).randn(B, S, _cfg().hidden).astype("float32")
    tl, tp = _train(dg, init, feed, _cfg(), proj=proj)
    jl, jp = _train(jdg, init, feed, _cfg(), proj=proj)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-6, err_msg=n)


def test_dygraph_bert_with_dropout_trains(static_run, monkeypatch):
    """Dropout 0.1: finite losses; every fused_attention grad op is given
    its forward's salt."""
    from paddle_tpu_torch.dygraph import base
    init, feed, _ = static_run
    salts, real = [], base._ctx

    def spy(attrs, salt=None, device=None):
        ctx = real(attrs, salt, device)
        if attrs.get("dropout_prob") and "scale" in attrs:
            salts.append((salt is not None, ctx._salt))
        return ctx

    monkeypatch.setattr(base, "_ctx", spy)
    losses, _ = _train(dg, init, feed, _cfg(dropout=0.1), steps=2)
    assert all(np.isfinite(losses))
    fwd = [s for replay, s in salts if not replay]
    bwd = [s for replay, s in salts if replay]
    assert len(fwd) == 2 * 2 and sorted(bwd) == sorted(fwd)


def test_traced_encoder_matches_eager_and_jax_and_serves(static_run, tmp_path):
    init, feed, _ = static_run
    cfg = _cfg(dropout=0.1)
    small = {n: v[:1] for n, v in feed.items()}
    with jdg.guard(), fluid.unique_name.guard():
        jm = db.build_encoder(cfg, jdg)
        jm.eval()
        _, jtraced = jdg.TracedLayer.trace(jm, [jdg.to_variable(feed[n]) for n, _ in db.FEEDS])
    with dg.guard(CPU), pt.unique_name.guard():
        model = db.build_encoder(cfg)
        db.load_static_state(model, {k: np.asarray(v) for k, v in init.items()})
        model.eval()
        out, traced = dg.TracedLayer.trace(model, [dg.to_variable(feed[n])
                                                   for n, _ in db.FEEDS])
        eager1 = model(*[dg.to_variable(small[n]) for n, _ in db.FEEDS]).numpy()
    types = [op.type for op in traced.program.global_block().ops]
    assert types == [op.type for op in jtraced.program.global_block().ops]
    assert types.count("fused_attention") == cfg.n_layers
    got, = traced([feed[n] for n, _ in db.FEEDS])
    np.testing.assert_allclose(got, out.numpy(), rtol=1e-5, atol=1e-5)
    got1, = traced([small[n] for n, _ in db.FEEDS])
    np.testing.assert_allclose(got1, eager1, rtol=1e-5, atol=1e-5)
    d = str(tmp_path / "encoder")
    traced.save_inference_model(d)
    pred = pt.inference.Predictor(d, device="cpu")
    served, = pred.run([feed[n] for n, _ in db.FEEDS])
    np.testing.assert_allclose(served, out.numpy(), rtol=1e-5, atol=1e-5)
