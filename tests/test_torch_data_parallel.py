"""Data parallel in the port (``compiler.py``, the executor's
``_run_compiled``, ``comm/rewrite.py``) at world 2 over gloo on the CPU,
against the JAX package's ``CompiledProgram`` at dp 2 on the CPU mesh: the
cases of ``tests/test_parallel.py`` that need no ``mp`` and the explicit-dp
cases of ``tests/test_comm.py``.

The JAX side runs in this process from its startup; the port's two ranks
(``tests/torch_dist_runner.py``, one launch for every case) start from the
same state (carried across as numpy, ``convert.state_from_numpy``) and
each feeds its half of the same global batches. f32 tolerances: rtol 1e-5,
atol 1e-6 unless a test says why not."""
import warnings

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu.comm import compress
from tests import torch_dist_runner as runner
from tests.test_torch_collective import run_ranks

TOL = dict(rtol=1e-5, atol=1e-6)
CASES = ["mlp", "fetch", "dropout", "capture", "feedcheck", "bn", "compress"]


def _jax_cp(main, reduce=False, reduce_params=False):
    bs = fluid.BuildStrategy()
    if reduce:
        bs.reduce_strategy = fluid.BuildStrategy.ReduceStrategy.Reduce
        bs.reduce_params = reduce_params
    return fluid.CompiledProgram(main, build_strategy=bs).with_strategy(
        fluid.DistributedStrategy(mesh_shape={"dp": 2}))


def _jax_train(build, feeds, fetch, init_prefix, inputs, reduce=False, reduce_params=False):
    """The JAX dp-2 run: (startup state, per-step fetches, final state)."""
    main, startup, *outs = build(fluid)
    fetch = [outs[i] for i in fetch]
    names = runner.persistables(main)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        sc = fluid.global_scope()
        exe.run(startup)
        for n in names:
            inputs[f"{init_prefix}{n}"] = np.asarray(sc.find_var(n))
        cp = _jax_cp(main, reduce, reduce_params)
        got = [[np.asarray(v) for v in exe.run(cp, feed=f, fetch_list=fetch)] for f in feeds]
        final = {n: np.asarray(sc.find_var(n)) for n in names}
    return got, final


def _jax_compress(mode, inputs):
    """The JAX explicit-dp run at dp 2 with ``comm_compression`` ``mode``
    (every gradient compressed): 6 Momentum steps from the startup state
    (kept as ``mom_init/``); the per-step losses and the final state,
    error-feedback residuals (ndp, ...) included."""
    main, startup, loss, _ = runner.build_mlp(fluid, opt="momentum")
    ds = fluid.DistributedStrategy(mesh_shape={"dp": 2})
    ds.comm_compression = mode
    ds.comm_compress_min_bytes = 0
    cp = fluid.CompiledProgram(main).with_strategy(ds)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        sc = fluid.global_scope()
        exe.run(startup)
        for n in runner.persistables(main):
            inputs[f"mom_init/{n}"] = np.asarray(sc.find_var(n))
        losses = [float(np.asarray(exe.run(cp, feed=f, fetch_list=[loss])[0]).reshape(()))
                  for f in runner.mlp_feeds(6, seed=2)]
        final = {n: np.asarray(sc.find_var(n)) for n in runner.persistables(main)}
    return np.asarray(losses, np.float32), final


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The JAX references and the port's two ranks' results."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs, ref = {}, {}
    feeds = runner.mlp_feeds()
    ref["mlp"] = _jax_train(runner.build_mlp, feeds, [0], "init/", inputs)
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    for static in (False, True):
        ref[f"fetch/{static}"] = _jax_train(lambda p: runner.build_fc_fetch(p, static),
                                            [{"x": x}], [0], "fetch_init/", inputs)
    rs = np.random.RandomState(4)
    imgs = [rs.randn(8, 3, 6, 6).astype("float32") for _ in range(2)]
    for i, im in enumerate(imgs):
        inputs[f"bn_img{i}"] = im
    ref["bn"] = _jax_train(runner.build_conv_bn, [{"img": im} for im in imgs], [0],
                           "bn_init/", inputs)
    for mode in ("int8", "bf16"):
        ref[f"compress/{mode}"] = _jax_compress(mode, inputs)
    np.savez(tmp / "inputs.npz", **inputs)
    return ref, run_ranks(tmp, 2, CASES, timeout=150)


def _blocks(res, key, n, full_shape):
    """A state tensor from the ranks: whole, or its two blocks joined."""
    a, b = res[0][f"{key}/state/{n}"], res[1][f"{key}/state/{n}"]
    if a.shape == tuple(full_shape):
        return a
    d = next(i for i, (s, f) in enumerate(zip(a.shape, full_shape)) if s != f)
    return np.concatenate([a, b], axis=d)


@pytest.mark.parametrize("mode", ["allreduce", "reduce", "reduce_params"])
def test_dp2_losses_and_state_match_jax(dp, mode):
    """test_dp8_loss_parity / test_dp_params_stay_synchronized / the ZeRO
    cases of test_parallel.py at dp 2: the losses of 3 Adam steps and every
    state tensor against the JAX dp-2 run (Adam's moments joined from the
    ranks' blocks under Reduce)."""
    ref, res = dp
    got, final = ref["mlp"]
    jl = np.asarray([float(g[0].reshape(())) for g in got], np.float32)
    for r in range(2):
        np.testing.assert_allclose(res[r][f"{mode}/loss"], jl, **TOL)
    for n, want in final.items():
        np.testing.assert_allclose(_blocks(res, mode, n, want.shape), want,
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_dp2_parameters_stay_byte_equal_across_ranks(dp):
    _, res = dp
    for mode in ("allreduce", "reduce"):
        for k in res[0]:
            if k.startswith(f"{mode}/state/") and "moment" not in k:
                assert res[0][k].tobytes() == res[1][k].tobytes(), k


def test_reduce_strategy_shards_the_moments_over_the_ranks(dp):
    """Each rank holds half of the Adam moments' bytes; the beta powers and
    a moment with no even dim stay whole (the JAX package's rule)."""
    ref, res = dp
    _, final = ref["mlp"]
    for mode in ("reduce", "reduce_params"):
        full = held = 0
        for n, want in final.items():
            if "moment" in n:
                full += want.nbytes
                held += res[0][f"{mode}/state/{n}"].nbytes
                assert res[0][f"{mode}/state/{n}"].nbytes == res[1][f"{mode}/state/{n}"].nbytes
        assert held * 2 == full, (mode, held, full)
    w = "fc_0.w_0"
    assert res[0][f"reduce/state/{w}"].shape == final[w].shape
    assert res[0][f"reduce_params/state/{w}"].shape[0] * 2 == final[w].shape[0]


@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_batch_fetch_is_all_gathered(dp, kind):
    """test_explicit_mode_batch_fetch_matches_gspmd and its static twin: a
    fetch with a batch dim comes back whole on every rank."""
    ref, res = dp
    got, _ = ref[f"fetch/{kind == 'static'}"]
    for r in range(2):
        assert res[r][f"fetch/{kind}"].shape == (16, 4)
        np.testing.assert_allclose(res[r][f"fetch/{kind}"], got[0][0], **TOL)


def test_dropout_draws_a_stream_a_rank(dp):
    """test_explicit_mode_dropout_draws_per_shard_streams: both ranks fed the
    same rows draw different masks (the rank is folded into the seed), the
    losses are finite and the ranks agree on them; by statistics, each
    rank keeps about half of the units relu left (p 0.5)."""
    _, res = dp
    h = res[0]["dropout/h"]          # the gathered (3, 16, 64) activations
    np.testing.assert_array_equal(h, res[1]["dropout/h"])
    m0, m1 = h[:, :8] != 0, h[:, 8:] != 0
    assert (m0 != m1).mean() > 0.2
    assert np.isfinite(res[0]["dropout/loss"]).all()
    np.testing.assert_array_equal(res[0]["dropout/loss"], res[1]["dropout/loss"])
    both = (m0 | m1).mean()
    assert 0.15 < m0.mean() / both < 0.85 and 0.15 < m1.mean() / both < 0.85


def test_capture_is_refused_over_gloo(dp):
    _, res = dp
    assert "gloo" in str(res[0]["capture/refusal"])
    assert str(res[0]["capture/unbound"]) == ""


def test_feed_check_refuses_unequal_rows_on_every_rank(dp):
    _, res = dp
    for r in range(2):
        assert "different row counts [8, 10]" in str(res[r]["feedcheck/error"])


@pytest.mark.parametrize("axis", ["dp", "batch"])
def test_batch_norm_statistics_are_the_global_batch(dp, axis):
    """A conv + batch_norm net at dp 2 against JAX's GSPMD dp 2 (whose
    statistics are the global batch's, sync_batch_norm, whatever the data
    axis is called): losses, the parameters and the running mean and
    variance, with the port's data axis named ``dp`` and ``batch``. The
    statistics are sums over a different order than XLA's reduction:
    rtol 1e-5, atol 1e-5 on the state."""
    ref, res = dp
    got, final = ref["bn"]
    jl = np.asarray([float(g[0].reshape(())) for g in got], np.float32)
    for r in range(2):
        np.testing.assert_allclose(res[r][f"bn/{axis}/loss"], jl, rtol=1e-5)
        for n, want in final.items():
            np.testing.assert_allclose(res[r][f"bn/{axis}/state/{n}"], want, rtol=1e-5,
                                       atol=1e-5, err_msg=n)


def test_compressed_allreduce_tracks_the_uncompressed_one(dp):
    """test_int8_error_feedback_convergence_parity / test_bf16_mode_tracks:
    6 Momentum steps with int8 (error feedback) and bf16 gradients within
    5e-3 of the uncompressed run (the JAX package's pin), equal on both
    ranks."""
    _, res = dp
    off = res[0]["compress/off"]
    for mode in ("int8", "bf16"):
        assert np.abs(res[0][f"compress/{mode}"] - off).max() <= 5e-3, mode
        np.testing.assert_array_equal(res[0][f"compress/{mode}"], res[1][f"compress/{mode}"])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_compressed_allreduce_matches_jax(dp, mode):
    """The compressed explicit-dp run against the JAX package's at dp 2 from
    the same startup and feeds: the 6 losses at f32 tolerances (rtol 1e-5,
    atol 1e-6), and every parameter, velocity and each rank's
    error-feedback residual (against its row of the JAX (ndp, ...)
    residual). Both sides quantize local gradients that agree to f32
    rounding, so an element lying on a rounding boundary of the wire type
    may round to the neighbouring code on one side (seen on bf16: 2 of
    2048 elements); error feedback carries that one quantum q in the
    residual. So each state tensor holds at f32 tolerances but for at most
    4 such elements, each within 6q (the residual moves by q, the velocity
    by at most 6q over 6 steps, a parameter by lr times that); q is two
    of the run's largest residual, an upper bound of one quantum. A
    dropped or mis-threaded residual moves most elements and fails."""
    ref, res = dp
    jl, final = ref[f"compress/{mode}"]
    residuals = [n for n in final if compress.is_residual(n)]
    assert len(residuals) == 4, residuals
    q = 2 * max(float(np.abs(final[n]).max()) for n in residuals)
    for r in range(2):
        np.testing.assert_allclose(res[r][f"compress/{mode}"], jl, **TOL)
        for n, want in final.items():
            got = res[r][f"compress/{mode}/state/{n}"]
            if n in residuals:
                assert got.shape == (1,) + want.shape[1:], (n, got.shape)
                want = want[r:r + 1]
            off = ~np.isclose(got, want, **TOL)
            assert off.sum() <= 4, (n, int(off.sum()))
            np.testing.assert_allclose(got[off], want[off], rtol=0, atol=6 * q, err_msg=n)


def test_world_1_data_parallel_is_the_plain_run_bit_for_bit():
    """test_world_1_compressed_is_byte_identical_to_off and the single-process
    dp of test_dp8_loss_parity: a CompiledProgram with no process group runs
    the plain step (its syncs are the identity), bit for bit, in either
    reduce strategy and under int8 compression."""
    feeds = runner.mlp_feeds()

    def train(wrap):
        main, startup, loss, _ = runner.build_mlp(pt)
        prog = wrap(main)
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            return np.asarray([exe.run(prog, feed=f, fetch_list=[loss])[0] for f in feeds])

    plain = train(lambda m: m)
    bs = pt.BuildStrategy()
    bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
    ds = pt.DistributedStrategy(mesh_shape={"dp": 1}, comm_compression="int8")
    for wrap in (lambda m: pt.CompiledProgram(m).with_data_parallel(),
                 lambda m: pt.CompiledProgram(m, bs).with_data_parallel(),
                 lambda m: pt.CompiledProgram(m).with_strategy(ds)):
        assert train(wrap).tobytes() == plain.tobytes()


def test_run_fused_takes_a_compiled_program():
    """run_fused(CompiledProgram) as the JAX one takes it: K steps stacked,
    bit for bit to K runs of the wrapper (one process: no group bound)."""
    feeds = runner.mlp_feeds(2)
    outs = []
    for fused in (False, True):
        main, startup, loss, _ = runner.build_mlp(pt)
        cp = pt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(pt.Scope()):
            exe.run(startup)
            if fused:
                got = exe.run_fused(cp, feeds=feeds, fetch_list=[loss], return_numpy=True)[0]
            else:
                got = np.stack([exe.run(cp, feed=f, fetch_list=[loss])[0] for f in feeds])
        outs.append(np.asarray(got).reshape(-1))
    assert outs[0].tobytes() == outs[1].tobytes()


def test_the_port_raises_for_what_it_does_not_run():
    """An mp axis, param_rules and auto_shard name ROADMAP item 13's later
    parts; a dp mesh larger than the world names the world."""
    main, startup, loss, _ = runner.build_mlp(pt)
    exe = pt.Executor(pt.CPUPlace())
    feed = runner.mlp_feeds(1)[0]
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for ds, what in [
                (pt.DistributedStrategy(mesh_shape={"dp": 1, "mp": 2}), "13 \\(b\\)"),
                (pt.DistributedStrategy(param_rules=[("fc", (None, "mp"))]), "13 \\(b\\)"),
                (pt.DistributedStrategy(auto_shard="static"), "13 \\(c\\)")]:
            with pytest.raises((NotImplementedError, ValueError), match=what):
                exe.run(pt.CompiledProgram(main).with_strategy(ds), feed=feed,
                        fetch_list=[loss])
        with pytest.raises(ValueError, match="needs 2 ranks"):
            exe.run(pt.CompiledProgram(main).with_strategy(
                pt.DistributedStrategy(mesh_shape={"dp": 2})), feed=feed, fetch_list=[loss])


def test_backend_rule_nccl_gloo_and_the_shared_card(monkeypatch):
    """nccl for one card a rank, gloo on the CPU, two ranks on one card
    raise unless gloo is asked; nccl without a card raises."""
    from paddle_tpu_torch.parallel import env
    assert env.choose_backend(None, local_world=2, cards=2) == "nccl"
    assert env.choose_backend(None, local_world=1, cards=0) == "gloo"
    with pytest.raises(RuntimeError, match="share 1 card"):
        env.choose_backend(None, local_world=2, cards=1)
    assert env.choose_backend("gloo", local_world=2, cards=1) == "gloo"
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        env.choose_backend("nccl", local_world=1, cards=0)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert str(env.rank_device("gloo", cards=1)) == "cuda:0"
    assert str(env.rank_device("nccl", cards=2)) == "cuda:1"
    assert str(env.rank_device("gloo", cards=0)) == "cpu"
    # the launcher named two processes but no group exists: no silent world 1
    monkeypatch.setenv("NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="init_parallel_env"):
        env.dist_world_size()


def test_noop_knobs_warn_with_the_ports_reason():
    bs = pt.BuildStrategy()
    with pytest.warns(UserWarning, match="multi-tensor update"):
        bs.fuse_all_optimizer_ops = False
    with pytest.raises(NotImplementedError, match="CoeffNumDevice"):
        bs.gradient_scale_strategy = pt.BuildStrategy.GradientScaleStrategy.One
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pt.BuildStrategy().reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
