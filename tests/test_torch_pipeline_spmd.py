"""The GPipe schedule of the port (``parallel/pipeline.py`` and the
``temporal_pipeline`` op over a bound ``pp`` group) at world 2 and 4 over
gloo on the CPU, against the JAX package.

One launch of ``tests/torch_dist_runner.py`` a world runs every case:

- ``pipeline_spmd`` at pp 2 and pp 4 against the JAX ``pipeline_spmd`` on
  the CPU mesh (``tests/test_multihost.py::test_pipeline_spmd_matches_serial``),
  and its gradients (each rank's block of the stacked parameters, the
  input's on every rank) against the JAX serial schedule's
  (``tests/test_pipeline.py::test_pipeline_spmd_gradient_matches_serial``):
  rtol 2e-5 / atol 1e-5 on the outputs, rtol 2e-4 / atol 1e-5 on the
  gradients, the JAX tests' tolerances; the telemetry's M + S - 1 ticks and
  bubble (S - 1) / (M + S - 1); the PT040 error without the axis;
- the staged MLP of ``tests/test_pipeline.py`` trained under
  ``PipelineOptimizer(SGD, 2, schedule="temporal")`` with pp = world, and
  at world 4 under dp 2 x pp 2, against the JAX package's one-process run
  of the same program (the serial schedule), 4 steps from its startup
  state: losses rtol 1e-5, and every parameter (the stacks joined from the
  ranks' blocks) atol 1e-5; the replicated parameters byte-equal on every
  pp rank;
- at world 2, tiny BERT (L2, H64, A2, S16, B4, ``pp_stages`` 2) under
  ``PipelineOptimizer(Adam, 2, "temporal")``, 3 steps against the JAX
  serial run (losses rtol 1e-5, state atol 5e-5, as
  ``tests/test_torch_pipeline.py``'s BERT parities), the capture refusal's
  reason, and a ``Checkpointer`` save of the pp run restored in one
  process (the stacks whole) byte for byte to the ranks' blocks.
"""
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from tests import torch_dist_runner as runner
from tests.test_torch_collective import run_ranks


def _jax_run(program, feeds, fetch, inputs, prefix):
    """The JAX one-process run from its startup: the losses and the final
    state, the startup state stored under ``prefix`` for the ranks."""
    main, startup = program[:2]
    names = runner.persistables(main)
    exe = fluid.Executor()
    with fluid.scope_guard(fluid.Scope()):
        sc = fluid.global_scope()
        exe.run(startup)
        for n in names:
            inputs[f"{prefix}{n}"] = np.asarray(sc.find_var(n))
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[fetch])[0]).reshape(-1)[0])
                  for f in feeds]
        final = {n: np.asarray(sc.find_var(n), np.float32) for n in names}
    return np.asarray(losses, np.float32), final


_RUNS = {}


def _launch(world, tmp_path_factory):
    """The references and the ranks' results at ``world``, one launch a
    world for the module."""
    if world not in _RUNS:
        _RUNS[world] = _run(world, tmp_path_factory.mktemp(f"pp{world}"))
    return _RUNS[world]


@pytest.fixture(scope="module", params=[2, 4])
def pp(request, tmp_path_factory):
    return _launch(request.param, tmp_path_factory)


@pytest.fixture(scope="module")
def pp2(tmp_path_factory):
    return _launch(2, tmp_path_factory)


@pytest.fixture(scope="module")
def pp4(tmp_path_factory):
    return _launch(4, tmp_path_factory)


def _run(world, tmp):
    inputs, ref = {}, {}
    for stages in sorted({world, 2}):
        prog = runner.build_staged_mlp(fluid, stages)
        ref[f"staged{stages}"] = _jax_run(prog, runner.staged_feeds(), prog[2], inputs,
                                          f"staged{stages}/")
    if world == 2:
        prog = runner.bert_pp(fluid, jbert)
        ref["bert"] = _jax_run(prog, [runner.bert_feed()] * 3, prog[2], inputs, "bert/")
    np.savez(tmp / "inputs.npz", **inputs)
    return world, ref, run_ranks(tmp, world, ["pipe", "pp_train"], timeout=150), tmp


def _jax_pipe(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from paddle_tpu.parallel import pipeline_spmd
    Ws, bs, x, tgt = runner.pipe_inputs(world)
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world), ("pp",))

    def stage(params, h):
        W, b = params
        return jnp.tanh(h @ W + b)

    out = jax.jit(lambda p, xx: pipeline_spmd(stage, p, xx, mesh, axis="pp"))(
        (jnp.asarray(Ws), jnp.asarray(bs)), jnp.asarray(x))

    def serial_loss(params, xx):
        h = xx
        for s in range(world):
            h = jnp.tanh(h @ params[0][s] + params[1][s])
        return jnp.mean((h - tgt) ** 2)

    loss, grads = jax.jit(jax.value_and_grad(serial_loss, argnums=(0, 1)))(
        (jnp.asarray(Ws), jnp.asarray(bs)), jnp.asarray(x))
    return np.asarray(out), float(loss), grads


def test_pipeline_spmd_matches_jax_and_the_serial_gradients(pp):
    world, _, res, _ = pp
    out, loss, ((gW, gb), gx) = _jax_pipe(world)
    for r in range(world):
        np.testing.assert_allclose(res[r]["pipe/out"], out, rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(float(res[r]["pipe/loss"]), loss, rtol=2e-5)
        np.testing.assert_allclose(res[r]["pipe/gW"], np.asarray(gW)[r], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(res[r]["pipe/gb"], np.asarray(gb)[r], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(res[r]["pipe/gx"], np.asarray(gx), rtol=2e-4, atol=1e-5)


def test_pipeline_telemetry_and_the_axis_error(pp):
    world, _, res, _ = pp
    M = runner.PIPE_M
    for r in range(world):
        assert int(res[r]["pipe/traces"]) == 1
        assert float(res[r]["pipe/ticks"]) == M + world - 1
        assert float(res[r]["pipe/bubble"]) == pytest.approx((world - 1) / (M + world - 1))
        assert "PT040" in str(res[r]["pipe/no_axis"]) and "'pp'" in str(res[r]["pipe/no_axis"])


def _joined(res, key, name, world, npp):
    """A state tensor of the run ``key``: whole, or the pp ranks' blocks
    joined (the ranks of dp coordinate 0)."""
    a = res[0][f"{key}/state/{name}"]
    if "@pp_stacked" not in name or "_pow_acc" in name:
        return a
    return np.concatenate([res[r][f"{key}/state/{name}"] for r in range(npp)], 0)


def _trains_as_one_process(run, key):
    world, ref, res, _ = run
    stages = world if key == "pp" else 2
    losses, final = ref[f"staged{stages}"]
    npp = stages
    for r in range(world):
        np.testing.assert_allclose(res[r][f"{key}/loss"], losses, rtol=1e-5)
    assert int(res[0]["pp/traces"]) > 0
    for n, want in final.items():
        np.testing.assert_allclose(_joined(res, key, n, world, npp), want, atol=1e-5,
                                   err_msg=n)
        if "@pp_stacked" not in n:
            for r in range(1, world):   # replicated: equal on every rank
                assert res[r][f"{key}/state/{n}"].tobytes() == \
                    res[0][f"{key}/state/{n}"].tobytes(), n


def test_temporal_pipeline_trains_as_one_process(pp):
    """pp = world: one stage a rank."""
    _trains_as_one_process(pp, "pp")


def test_dp2_pp2_trains_as_one_process(pp4):
    _trains_as_one_process(pp4, "dppp")


def test_tiny_bert_under_pp2_matches_jax(pp2):
    world, ref, res, _ = pp2
    losses, final = ref["bert"]
    for r in range(2):
        np.testing.assert_allclose(res[r]["bert/loss"], losses, rtol=1e-5)
    assert losses[2] < losses[0]
    for n, want in final.items():
        np.testing.assert_allclose(_joined(res, "bert", n, 2, 2), want, atol=5e-5, err_msg=n)
    assert "gloo" in str(res[0]["pp/refusal"])


def test_a_pp2_checkpoint_restores_in_one_process(pp2):
    world, _, res, tmp = pp2
    from paddle_tpu_torch.utils.checkpointer import Checkpointer
    main, _, _ = runner.build_staged_mlp(pt, 2)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    with pt.scope_guard(scope):
        step = Checkpointer(exe, main, str(tmp / "pp_ckpt")).restore()
    assert step == 3
    for n in runner.persistables(main):
        got = scope.find_var(n).numpy()
        want = _joined(res, "pp", n, 2, 2)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), n
