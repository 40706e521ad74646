"""``PipelineOptimizer``'s microbatch scan in the port, held against the JAX
package on the CPU.

The MLP parities of tests/test_pipeline.py (SGD over 4 microbatches,
Momentum over 2; 6 steps, ``rtol 1e-4, atol 1e-6`` as there: the mean of
equal-count microbatch means is the batch mean, so only the order of the
sums separates the two), the rewritten program (op types, variable
names, the scan's attrs) equal to the JAX package's, tiny BERT (L2, H64,
A2, S16, B4) under ``PipelineOptimizer(Adam, 2)`` against the JAX
package's at dropout 0 (3 steps: losses ``rtol 1e-5``, every state tensor
``atol 5e-5``, as tests/test_torch_recompute.py) and against its own plain
step on the batch's positions made global (``atol 1e-5`` on the state:
the same sums in another order), each microbatch drawing the same dropout
masks at dropout 0.1 in both packages, the body's forwards kept once a
microbatch, bit for bit to the recompute path, the ``check_nested``
refusal.

The temporal schedule on one process (its serial form), against the JAX
package: ``device_guard``'s tags, the rewrite of BERT's ``pp_stages`` (op
for op, the ``@pp_stacked`` names), the staged MLP and tiny BERT trained
under it, the refusal of heterogeneous stages with the JAX message, and
the stages' decorrelated dropout streams. The schedule over pp ranks is
``tests/test_torch_pipeline_spmd.py``'s.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.tools import train_profile as tp

B, S, MASKS, VOCAB = 4, 16, 2, 128


def _mlp(pkg, opt, seed):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [16], "float32")
        label = pkg.data("label", [1], "int64")
        h = pkg.layers.fc(x, 32, act="relu")
        h = pkg.layers.fc(h, 32, act="relu")
        logits = pkg.layers.fc(h, 4)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        opt(pkg).minimize(loss)
    return main, startup, loss


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


def _jax_steps(main, startup, fetch, feeds, init=None):
    """(each step's fetches, the startup state, the final state), from
    ``init`` when given."""
    scope = fluid.Scope()
    names = _persistables(main)
    with fluid.scope_guard(scope):
        exe = fluid.Executor()
        exe.run(startup)
        for n, v in (init or {}).items():
            scope.set_var(n, v)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        outs = [exe.run(main, feed=f, fetch_list=fetch) for f in feeds]
        final = {n: np.asarray(scope.find_var(n)) for n in names}
    return outs, init, final


def _port_steps(main, fetch, feeds, init, reuse=True):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy({n: np.array(v) for n, v in init.items()},
                                                       device="cpu"))
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        exe._reuse_forward = reuse
        outs = [exe.run(main, feed=f, fetch_list=fetch) for f in feeds]
    return outs, {n: scope.find_var(n).float().numpy() for n in init}


def _mlp_feeds(bs=16, steps=6):
    rng = np.random.RandomState(1)
    return [{"x": rng.randn(bs, 16).astype("float32"),
             "label": rng.randint(0, 4, (bs, 1)).astype("int64")} for _ in range(steps)]


@pytest.mark.parametrize("inner, m, seed", [
    (lambda pkg: pkg.optimizer.SGD(0.1), 4, 7),
    (lambda pkg: pkg.optimizer.Momentum(0.05, 0.9), 2, 9)], ids=["sgd_m4", "momentum_m2"])
def test_mlp_parity_with_jax_and_the_plain_step(inner, m, seed):
    feeds = _mlp_feeds()
    pipe = lambda pkg: pkg.optimizer.PipelineOptimizer(inner(pkg), num_microbatches=m)
    jm, js, jl = _mlp(fluid, pipe, seed)
    jouts, init, jfinal = _jax_steps(jm, js, [jl], feeds)
    tm, _, tl = _mlp(pt, pipe, seed)
    touts, tfinal = _port_steps(tm, [tl], feeds, init)
    pm, _, pl = _mlp(pt, inner, seed)
    pouts, _ = _port_steps(pm, [pl], feeds, init)
    got = [float(o[0].reshape(())) for o in touts]
    np.testing.assert_allclose(got, [float(np.asarray(o[0]).reshape(())) for o in jouts],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, [float(o[0].reshape(())) for o in pouts],
                               rtol=1e-4, atol=1e-6)
    for n in init:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=1e-4, atol=1e-6, err_msg=n)


def test_the_rewritten_program_is_the_jax_packages():
    """The scan op, its body (the forward and backward ops), the carries'
    ``sum`` ops, the reshapes of the feeds to [M, -1, ...], the 1/M scales
    of the ``@mb_mean`` grads and of the loss, the update ops over them:
    the same op types, variables, attrs and inputs in both packages."""
    pipe = lambda pkg: pkg.optimizer.PipelineOptimizer(pkg.optimizer.SGD(0.1),
                                                       num_microbatches=4)
    jm, _, _ = _mlp(fluid, pipe, 7)
    tm, _, _ = _mlp(pt, pipe, 7)
    assert len(tm.blocks) == len(jm.blocks) == 2
    for tb, jb in zip(tm.blocks, jm.blocks):
        assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
        assert sorted(tb.vars) == sorted(jb.vars)
        for a, b in zip(tb.ops, jb.ops):
            assert a.inputs == b.inputs and a.outputs == b.outputs, a.type
        assert {n: v.dtype for n, v in tb.vars.items() if "int" not in v.dtype} == \
            {n: v.dtype for n, v in jb.vars.items() if "int" not in v.dtype}
    scan = next(op for op in tm.global_block().ops if op.type == "scan")
    jscan = next(op for op in jm.global_block().ops if op.type == "scan")
    assert scan.attrs == jscan.attrs
    assert scan.attr("x_names") == ["x", "label"] and scan.attr("time_major")
    assert [op.type for op in tm.global_block().ops].count("sgd") == 6
    assert all(op.input("Grad")[0].endswith("@mb_mean")
               for op in tm.global_block().ops if op.type == "sgd")
    assert tp.pipeline(4)(pt, 0.1)._m == 4
    assert pt.optimizer.PipelineOptimizer.pp_param_rules() == \
        fluid.optimizer.PipelineOptimizer.pp_param_rules()


def _bert(pkg, module, optimizer, dropout=0.0, batch=B, pp_stages=None):
    cfg = module.BertConfig(vocab_size=VOCAB, hidden=64, n_layers=2, n_heads=2,
                            max_seq_len=S, dropout=dropout, pp_stages=pp_stages)
    return tp.build_pretrain(cfg, batch, S, MASKS, lr=0.01, seed=1, optimizer=optimizer,
                             pkg=pkg, model=module)


def _bert_feed(seed=0, microbatches=2, batch=B):
    cfg = tbert.BertConfig(vocab_size=VOCAB)
    return tp.pretrain_feed(np.random.RandomState(seed), cfg, batch, S, MASKS, microbatches)


def test_microbatch_feed_positions():
    """``pretrain_feed(..., microbatches)`` draws each microbatch's masked
    positions in its own tokens, equal counts in microbatch order, and
    ``global_mask_pos`` offsets them into the whole batch."""
    feed = _bert_feed(microbatches=2)
    local = feed["mask_pos"]
    assert local.shape == (B * MASKS, 1) and local.max() < B // 2 * S
    glob = tp.global_mask_pos(local, 2, B, S)
    half = B * MASKS // 2
    np.testing.assert_array_equal(glob[:half], local[:half])
    np.testing.assert_array_equal(glob[half:], local[half:] + B // 2 * S)
    # one microbatch: the draw of bench.py, unchanged
    one = tp.pretrain_feed(np.random.RandomState(0), tbert.BertConfig(vocab_size=VOCAB), B, S,
                           MASKS)
    assert one["mask_pos"].max() >= B // 2 * S


def test_tiny_bert_under_two_microbatches_matches_jax_and_the_plain_step():
    """Tiny BERT under ``PipelineOptimizer(Adam, 2)`` at dropout 0: 3 steps
    against the JAX package's from the same weights, and the state after
    them against the port's plain step on the same tokens."""
    feed = _bert_feed()
    jm, js, jt, _ = _bert(fluid, jbert, tp.pipeline(2))
    jouts, init, jfinal = _jax_steps(jm, js, [jt], [feed] * 3)
    tm, _, tt, _ = _bert(pt, tbert, tp.pipeline(2))
    touts, tfinal = _port_steps(tm, [tt], [feed] * 3, init)
    losses = [float(o[0].reshape(-1)[0]) for o in touts]
    np.testing.assert_allclose(losses, [float(np.asarray(o[0]).reshape(-1)[0]) for o in jouts],
                               rtol=1e-5)
    assert losses[2] < losses[0]
    for n in init:
        np.testing.assert_allclose(tfinal[n], np.asarray(jfinal[n], np.float32), atol=5e-5,
                                   err_msg=n)
    pm, _, pl, _ = _bert(pt, tbert, None)
    plain = dict(feed, mask_pos=tp.global_mask_pos(feed["mask_pos"], 2, B, S))
    pouts, pfinal = _port_steps(pm, [pl], [plain] * 3, init)
    np.testing.assert_allclose(losses, [float(o[0].reshape(-1)[0]) for o in pouts], rtol=1e-5)
    for n in init:
        np.testing.assert_allclose(tfinal[n], pfinal[n], atol=1e-5, err_msg=n)


def test_every_microbatch_draws_the_same_dropout_masks():
    """At dropout 0.1 each microbatch draws the masks of the body's one salt
    per op, in both packages (the JAX body is traced once with one key;
    Paddle draws anew per microbatch: ROADMAP fault 3.10). So a batch of
    two equal halves trains as its half alone does: the pipeline's step on
    [h; h] equals the plain step on h, bit for bit in the port."""
    half = _bert_feed(seed=3, microbatches=1, batch=B // 2)
    both = {k: np.concatenate([v, v]) for k, v in half.items()}
    results = {}
    for pkg, module in ((fluid, jbert), (pt, tbert)):
        pm, ps, pl, _ = _bert(pkg, module, tp.pipeline(2), dropout=0.1)
        hm, hs, hl, _ = _bert(pkg, module, None, dropout=0.1, batch=B // 2)
        if pkg is fluid:
            p_outs, init, p_final = _jax_steps(pm, ps, [pl], [both] * 2)
            h_outs, _, h_final = _jax_steps(hm, hs, [hl], [half] * 2, init)
            results["jax"] = (p_outs, p_final, h_outs, h_final)
        else:
            p_outs, p_final = _port_steps(pm, [pl], [both] * 2, init)
            h_outs, h_final = _port_steps(hm, [hl], [half] * 2, init)
            results["port"] = (p_outs, p_final, h_outs, h_final)
    p_outs, p_final, h_outs, h_final = results["port"]
    for a, b in zip(p_outs, h_outs):
        assert np.array_equal(a[0], b[0])
    for n in p_final:
        assert np.array_equal(p_final[n], h_final[n]), n
    p_outs, p_final, h_outs, h_final = results["jax"]
    for a, b in zip(p_outs, h_outs):
        np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), rtol=1e-6)
    for n in p_final:   # XLA's fusions round otherwise in the body (a few f32 ulps)
        np.testing.assert_allclose(np.asarray(p_final[n], np.float32),
                                   np.asarray(h_final[n], np.float32), atol=1e-5, err_msg=n)


def test_the_body_keeps_each_forward_once_a_microbatch(monkeypatch):
    """The body holds the forward and backward ops: each ``fused_attention``
    runs once a microbatch under autograd and its grad op differentiates
    the kept graph (2 layers x 2 microbatches = 4 runs a step; the
    recompute path runs 8), bit for bit to the recompute path; only the
    carries outlive an iteration of the body."""
    calls, leaked = [], []
    fa = treg._REGISTRY["fused_attention"]
    lower = fa.lower
    monkeypatch.setattr(fa, "lower", lambda ctx, ins: (calls.append(torch.is_grad_enabled()),
                                                       lower(ctx, ins))[1])
    runner_call = texec.SubBlockRunner.__call__

    def spy(self, idx, sub_env, keep=None):
        env = runner_call(self, idx, sub_env, keep)
        made = {n for op in self.program.blocks[idx].ops for n in op.output_arg_names()}
        leaked.extend(n for n in made if n in env and n not in (keep or ()))
        return env

    monkeypatch.setattr(texec.SubBlockRunner, "__call__", spy)
    feed = _bert_feed()
    tm, ts, tt, _ = _bert(pt, tbert, tp.pipeline(2), dropout=0.1)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(ts)
    init = {n: scope.find_var(n).numpy() for n in _persistables(tm)}
    outs = {}
    for reuse, want in ((True, [True] * 4), (False, [False] * 4 + [True] * 4)):
        calls.clear()
        outs[reuse] = _port_steps(tm, [tt], [feed], init, reuse)
        assert sorted(calls) == sorted(want)
    assert not leaked
    assert np.array_equal(outs[True][0][0][0], outs[False][0][0][0])
    for n in init:
        assert np.array_equal(outs[True][1][n], outs[False][1][n]), n


def test_a_feed_read_inside_a_sub_block_is_refused():
    """A feed read by a sub-block's op, and by no op of the main block,
    without being an input of the enclosing op cannot be sliced: both
    packages refuse it by name."""
    msgs = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [4], "float32")
            pkg.data("side_feed", [4], "float32")
            loss = pkg.layers.mean(pkg.layers.fc(x, 4))
            sub = main._create_block(parent_idx=0)
            sub.create_var("side", (-1, 4), "float32")
            sub.append_op("scale", inputs={"X": ["side_feed"]}, outputs={"Out": ["side"]},
                          attrs={"scale": 2.0}, infer_shape=False)
            main._rollback()
            main.global_block().create_var("side_out", (-1, 4), "float32")
            main.global_block().append_op(
                "remat_segment", inputs={"X": []}, outputs={"Out": ["side_out"]},
                attrs={"sub_block": sub.idx, "in_names": [], "out_names": ["side"]},
                infer_shape=False)
            opt = pkg.optimizer.PipelineOptimizer(pkg.optimizer.SGD(0.1), num_microbatches=2)
            with pytest.raises(ValueError, match="feed var 'side_feed' is read inside sub-block") as e:
                opt.minimize(loss)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _staged(pkg, schedule="temporal", stages=4, micro=2):
    from tests import torch_dist_runner as runner
    return runner.build_staged_mlp(pkg, stages, schedule=schedule, micro=micro)


def test_the_temporal_schedule_raises():
    """The temporal schedule runs since the port has ``device_guard``: the
    staged MLP of tests/test_pipeline.py (4 tanh stages) under
    ``PipelineOptimizer(SGD, 2, schedule="temporal")`` trains as the JAX
    package's serial schedule does (6 steps from its startup: losses
    ``rtol 1e-5``, every state tensor ``atol 1e-6``). What still raises:
    a schedule by another name, refused as in JAX; ``"auto"`` on a program
    without stages is the scan."""
    feeds = _mlp_feeds(bs=8)
    jm, js, jl = _staged(fluid)
    jouts, init, jfinal = _jax_steps(jm, js, [jl], feeds)
    tm, _, tl = _staged(pt)
    assert [op.type for op in tm.global_block().ops].count("temporal_pipeline") == 1
    touts, tfinal = _port_steps(tm, [tl], feeds, init)
    np.testing.assert_allclose([float(o[0].reshape(())) for o in touts],
                               [float(np.asarray(o[0]).reshape(())) for o in jouts], rtol=1e-5)
    for n in init:
        np.testing.assert_allclose(tfinal[n], jfinal[n], atol=1e-6, err_msg=n)
    with pytest.raises(ValueError, match="auto|scan|temporal"):
        pt.optimizer.PipelineOptimizer(pt.optimizer.SGD(0.1), 2, schedule="gpipe")
    auto = lambda pkg: pkg.optimizer.PipelineOptimizer(pkg.optimizer.SGD(0.1), 2)
    tm, _, _ = _mlp(pt, auto, 7)
    assert [op.type for op in tm.global_block().ops].count("scan") == 1


def test_device_guard_tags_ops():
    """``device_guard`` tags the ops built inside with ``op_device``, in
    both packages alike; an op built outside has none."""
    devs = {}
    for pkg in (fluid, pt):
        main = pkg.Program()
        with pkg.program_guard(main, pkg.Program()):
            x = pkg.data("x", [4], "float32")
            with pkg.device_guard("stage:0"):
                assert pkg.framework.current_op_device() == "stage:0"
                h = pkg.layers.fc(x, 8)
            with pkg.device_guard("stage:1"):
                y = pkg.layers.fc(h, 2)
            pkg.layers.mean(y)
        devs[pkg.__name__] = [op.attr("op_device") for op in main.global_block().ops]
    assert devs["paddle_tpu"] == devs["paddle_tpu_torch"]
    assert "stage:0" in devs["paddle_tpu"] and devs["paddle_tpu"][-1] is None


def test_the_temporal_rewrite_is_the_jax_packages():
    """BERT's ``pp_stages`` 2 under ``PipelineOptimizer(Adam, 2,
    "temporal")``: the same ops, variables and attrs in every block of the
    main and startup programs, the ``@pp_stacked`` parameters made by
    ``stack`` in the startup, the per-stage parameters not persistable."""
    progs = {}
    for pkg, module in ((fluid, jbert), (pt, tbert)):
        progs[pkg.__name__] = _bert(pkg, module, _temporal(2), pp_stages=2)
    (jm, js, _, _), (tm, ts, _, _) = progs["paddle_tpu"], progs["paddle_tpu_torch"]
    for a, b in ((tm, jm), (ts, js)):
        assert len(a.blocks) == len(b.blocks)
        for tb, jb in zip(a.blocks, b.blocks):
            assert [op.type for op in tb.ops] == [op.type for op in jb.ops]
            assert sorted(tb.vars) == sorted(jb.vars)
            for x, y in zip(tb.ops, jb.ops):
                assert x.inputs == y.inputs and x.outputs == y.outputs, x.type
            assert {n: v.persistable for n, v in tb.vars.items()} == \
                {n: v.persistable for n, v in jb.vars.items()}
    op = next(o for o in tm.global_block().ops if o.type == "temporal_pipeline")
    jop = next(o for o in jm.global_block().ops if o.type == "temporal_pipeline")
    assert op.attrs == jop.attrs and op.attr("num_stages") == 2
    stacked = sorted(n for n in tm.global_block().vars if n.endswith("@pp_stacked"))
    assert "layer0_attn_qkv_w@pp_stacked" in stacked   # stage 0's names
    assert [o.type for o in ts.global_block().ops].count("stack") == len(stacked)
    assert not tm.global_block().vars["layer1_ffn1_w"].persistable


def _temporal(m):
    return lambda pkg, rate: pkg.optimizer.PipelineOptimizer(pkg.optimizer.Adam(rate), m,
                                                             schedule="temporal")


def test_tiny_bert_pp_stages_serial_matches_jax():
    """Tiny BERT with ``pp_stages`` 2 under the temporal schedule, run
    serially on one process: 3 Adam steps against the JAX package's (losses
    ``rtol 1e-5``, every state tensor ``atol 5e-5``)."""
    feed = _bert_feed(microbatches=1)
    jm, js, jt, _ = _bert(fluid, jbert, _temporal(2), pp_stages=2)
    jouts, init, jfinal = _jax_steps(jm, js, [jt], [feed] * 3)
    tm, _, tt, _ = _bert(pt, tbert, _temporal(2), pp_stages=2)
    touts, tfinal = _port_steps(tm, [tt], [feed] * 3, init)
    losses = [float(o[0].reshape(-1)[0]) for o in touts]
    np.testing.assert_allclose(losses, [float(np.asarray(o[0]).reshape(-1)[0]) for o in jouts],
                               rtol=1e-5)
    assert losses[2] < losses[0]
    for n in init:
        np.testing.assert_allclose(tfinal[n], np.asarray(jfinal[n], np.float32), atol=5e-5,
                                   err_msg=n)


def test_heterogeneous_stages_are_refused_with_the_jax_message():
    """``"temporal"`` refuses stages of different widths with the JAX
    package's message; ``"auto"`` falls back to the microbatch scan."""

    def build(pkg, schedule):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [16], "float32")
            label = pkg.data("label", [1], "int64")
            with pkg.device_guard("stage:0"):
                h = pkg.layers.fc(x, 32, act="relu")
            with pkg.device_guard("stage:1"):
                h = pkg.layers.fc(h, 16, act="tanh")
            loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
                pkg.layers.fc(h, 4), label))
            pkg.optimizer.PipelineOptimizer(pkg.optimizer.SGD(0.1), num_microbatches=2,
                                            schedule=schedule).minimize(loss)
        return main

    msgs = []
    for pkg in (fluid, pt):
        with pytest.raises(ValueError, match="temporal") as e:
            build(pkg, "temporal")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert [op.type for op in build(pt, "auto").global_block().ops].count("scan") == 1


def test_stage_dropout_streams_are_decorrelated():
    """Two 0.5-dropout stages keep about a quarter of the elements (a shared
    stream would keep half): each stage draws with its index folded into
    the seed, in the port as in the JAX package."""
    fracs = []
    for pkg in (fluid, pt):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            x = pkg.data("x", [4096], "float32")
            h = pkg.layers.scale(x, scale=1.0)
            for s in range(2):
                with pkg.device_guard(f"stage:{s}"):
                    h = pkg.layers.dropout(h, 0.5, dropout_implementation="upscale_in_train")
            out = pkg.layers.scale(h, scale=1.0)
            opt = pkg.optimizer.PipelineOptimizer(pkg.optimizer.SGD(0.1), num_microbatches=2,
                                                  schedule="temporal")
            try:
                opt.minimize(pkg.layers.mean(out))
            except Exception:
                pass   # no trainable parameter; the rewrite has happened
        assert any(op.type == "temporal_pipeline" for op in main.global_block().ops)
        exe = fluid.Executor() if pkg is fluid else pt.Executor(pt.CPUPlace())
        with pkg.scope_guard(pkg.Scope()):
            exe.run(startup)
            ov, = exe.run(main, feed={"x": np.ones((4, 4096), "float32")}, fetch_list=[out])
        fracs.append(float((np.asarray(ov) != 0).mean()))
    for f in fracs:
        assert 0.17 < f < 0.33, fracs
