"""The port's launcher (``parallel/launch.py``), ``fleet``, the multi-process
``Checkpointer`` and dygraph ``DataParallel`` over two gloo ranks on the CPU.

- the launcher kills the survivors when a rank dies (printing its log
  tail), kills every rank at its timeout, restarts the job up to
  ``max_restarts`` (a ``PREEMPTED_EXIT`` relaunch uses no budget), and
  refuses the elastic mode (ROADMAP item 13 (c));
- two-process data parallel against one process on the same global
  batches (``tests/test_multihost.py::test_two_process_dp_matches_single_process``);
- ``fleet`` on ``tests/dist_fleet_runner.py``'s program shape, against the
  JAX ``fleet`` on the 8-device CPU mesh;
- a ``Checkpointer`` save and restore of ZeRO state at world 2;
- dygraph ``DataParallel`` at world 2 against the JAX ``DataParallel`` on
  the 8-device CPU mesh
  (``tests/test_dygraph.py::test_dygraph_data_parallel_matches_single``).

f32 tolerances: rtol 1e-5, atol 1e-6 unless a test says why not."""

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch.parallel import launch as pt_launch
from tests import torch_dist_runner as runner
from tests.test_torch_collective import run_ranks

TOL = dict(rtol=1e-5, atol=1e-6)


def _script(tmp, name, body):
    p = tmp / name
    p.write_text("import os, sys, time\nr = int(os.environ['PROCESS_ID'])\n"
                 "a = int(os.environ['PADDLE_RESTART_ATTEMPT'])\n" + body)
    return str(p)


def test_launcher_kills_the_survivors_and_prints_the_tail(tmp_path, capfd):
    s = _script(tmp_path, "die.py",
                "if r == 1:\n    print('rank one gives up', flush=True)\n    sys.exit(3)\n"
                "time.sleep(60)\n")
    codes = pt_launch.launch(2, [s], log_dir=str(tmp_path / "logs"), timeout=30)
    assert codes[1] == 3 and codes[0] != 0, codes
    err = capfd.readouterr().err
    assert "rank 1 died with exit code 3" in err and "rank one gives up" in err


def test_launcher_timeout_kills_every_rank(tmp_path, capfd):
    s = _script(tmp_path, "hang.py", "time.sleep(60)\n")
    codes = pt_launch.launch(2, [s], log_dir=str(tmp_path / "logs"), timeout=1.5)
    assert all(c not in (0, None) for c in codes), codes
    assert "still running at the 1.5s limit" in capfd.readouterr().err


def test_launcher_restarts_and_preemption_is_free(tmp_path):
    """Attempt 0 is preempted (exit 75: no budget used), attempt 1 fails
    (the one restart of the budget), attempt 2 succeeds; each rank sees its
    environment."""
    s = _script(tmp_path, "flaky.py",
                "assert os.environ['NUM_PROCESSES'] == '2' and "
                "os.environ['LOCAL_RANK'] == str(r)\n"
                "assert os.environ['PADDLE_TRAINER_ENDPOINTS'].count(',') == 1\n"
                "sys.exit({0: 75, 1: 1}.get(a, 0) if r == 0 else 0)\n")
    codes = pt_launch.launch(2, [s], log_dir=str(tmp_path / "logs"), max_restarts=1,
                             restart_backoff=0.01, timeout=30)
    assert codes == [0, 0]
    assert (tmp_path / "logs" / "rank0.attempt2.log").exists()
    # the budget spent: the failure comes back
    s2 = _script(tmp_path, "bad.py", "sys.exit(2 if r == 0 else 0)\n")
    codes = pt_launch.launch(2, [s2], log_dir=str(tmp_path / "logs2"), max_restarts=1,
                             restart_backoff=0.01, timeout=30)
    assert codes[0] == 2


def test_launcher_elastic_mode_is_item_13c(tmp_path):
    with pytest.raises(NotImplementedError, match="13 \\(c\\)"):
        pt_launch.launch(2, ["x.py"], elastic=True)
    ok = _script(tmp_path, "ok.py", "sys.exit(0)\n")
    assert pt_launch.main(["--nproc", "2", "--timeout", "30", "--log_dir",
                           str(tmp_path / "logs"), ok]) == 0


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One launch of two ranks: the one-process comparison, fleet, the
    Checkpointer and dygraph DataParallel; the JAX DataParallel and fleet
    references on the 8-device CPU mesh."""
    import paddle_tpu as fluid
    from paddle_tpu import dygraph as jdy
    tmp = tmp_path_factory.mktemp("lf")
    inputs = {}
    for prefix, opt in (("mom_init/", "momentum"), ("init/", "adam")):
        main, startup, *_ = runner.build_mlp(fluid, opt=opt)
        with fluid.scope_guard(fluid.Scope()):
            fluid.Executor().run(startup)
            for n in runner.persistables(main):
                inputs[prefix + n] = np.asarray(fluid.global_scope().find_var(n))
    rng = np.random.RandomState(3)
    W = rng.randn(16, 4).astype("float32")
    xs = [rng.randn(32, 16).astype("float32") for _ in range(6)]
    inputs["dy_W"] = W
    for i, x in enumerate(xs):
        inputs[f"dy_x{i}"] = x

    class MLP(jdy.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = jdy.Linear(16, 32, act="relu")
            self.l2 = jdy.Linear(32, 4)

        def forward(self, x):
            return self.l2(self.l1(x))

    with jdy.guard():
        model = MLP()
        for i, v in enumerate(model.state_dict().values()):
            inputs[f"dy_init/{i}"] = np.asarray(v)
        model = jdy.DataParallel(model, jdy.prepare_context())
        opt = jdy.SGDOptimizer(0.1)
        losses = []
        for x in xs:
            pred = model(jdy.to_variable(x))
            diff = pred - jdy.to_variable(x @ W)
            loss = jdy.trace_op("mean", {"X": [diff * diff]}, {}, ["Out"])["Out"][0]
            loss = model.scale_loss(loss)
            loss.backward()
            model.apply_collective_grads()
            opt.minimize(loss, parameter_list=model.parameters())
            losses.append(float(loss.numpy().reshape(())))
        jparams = [np.asarray(p) for p in model.state_dict().values()]
    ref = {"dygraph": (np.asarray(losses, np.float32), jparams),
           "fleet": _jax_fleet(inputs)}
    np.savez(tmp / "inputs.npz", **inputs)
    res = run_ranks(tmp, 2, ["single", "fleet", "ckpt", "dygraph"], timeout=150)
    return inputs, res, ref, tmp


def _jax_fleet(inputs):
    """The JAX fleet on the 8-device CPU mesh, fed the two ranks' rows as
    one global batch: 3 losses and the trained weight. Its startup state is
    the ranks' (``fleet_init/``)."""
    import paddle_tpu as fluid
    from paddle_tpu import fleet as jfleet
    main, startup, loss = runner.build_fleet(fluid, jfleet)
    exe = fluid.Executor()
    feed = {"x": np.concatenate([runner.fleet_feed(r)["x"] for r in range(2)])}
    with fluid.scope_guard(fluid.Scope()):
        sc = fluid.global_scope()
        exe.run(startup)
        for n in runner.persistables(main):
            inputs[f"fleet_init/{n}"] = np.asarray(sc.find_var(n))
        losses = [float(np.asarray(exe.run(jfleet.main_program, feed=feed,
                                           fetch_list=[loss])[0]).reshape(()))
                  for _ in range(3)]
        return np.asarray(losses), np.asarray(sc.find_var("fc_0.w_0"))



def test_two_process_dp_matches_one_process(ranks):
    """The same global batches through one process and through two ranks of
    half the rows: the losses and the trained weights (the gradient sum's
    order differs: rtol 1e-5, atol 1e-6)."""
    inputs, res, _, _ = ranks
    main, _, loss, _ = runner.build_mlp(pt, opt="momentum")
    scope = runner._init_scope(pt, _Npz(inputs), "mom_init/")
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        one = np.asarray([exe.run(main, feed=f, fetch_list=[loss])[0]
                          for f in runner.mlp_feeds(4, seed=2)]).reshape(-1)
    for r in range(2):
        np.testing.assert_allclose(res[r]["single/loss"], one, **TOL)
        np.testing.assert_allclose(res[r]["single/w"], scope.find_var("fc_0.w_0").numpy(),
                                   **TOL)
    assert res[0]["single/w"].tobytes() == res[1]["single/w"].tobytes()


class _Npz(dict):
    """A dict with the ``files`` view of an npz (``runner._init_scope``)."""

    @property
    def files(self):
        return list(self)


def test_fleet_trains_and_the_first_worker_saves(ranks):
    """fleet.init / distributed_optimizer(...).minimize / main_program over two
    ranks fed different rows: the ranks agree on the averaged loss and the
    weights, which equal the JAX fleet's on the 8-device CPU mesh fed both
    ranks' rows; the save holds rank 0's manifest and an empty one of rank 1
    (the state is replicated)."""
    _, res, ref, tmp = ranks
    jl, jw = ref["fleet"]
    np.testing.assert_array_equal(res[0]["fleet/loss"], res[1]["fleet/loss"])
    assert res[0]["fleet/w"].tobytes() == res[1]["fleet/w"].tobytes()
    np.testing.assert_allclose(res[0]["fleet/loss"], jl, **TOL)
    np.testing.assert_allclose(res[0]["fleet/w"], jw, **TOL)
    assert res[0]["fleet/index"].tolist() == [0, 2, 1]
    assert res[1]["fleet/index"].tolist() == [1, 2, 0]
    saved = set(res[0]["fleet/saved"].tolist())
    assert {"__manifest__.json", "__manifest__.json.rank1", "fc_0.w_0.npy"} <= saved
    assert pt.io.verify_checkpoint(str(tmp / "fleet_model"))["ok"]


def test_checkpointer_round_trip_at_world_2(ranks):
    """A ZeRO run's Checkpointer save at world 2 and its restore after one
    more step: every rank's state byte for byte, each rank holding half of
    the Adam moments; the tree verifies at crc level."""
    _, res, _, tmp = ranks
    for r in range(2):
        assert int(res[r]["ckpt/step"]) == 1 and bool(res[r]["ckpt/equal"])
    assert int(res[0]["ckpt/moment_bytes"]) == int(res[1]["ckpt/moment_bytes"])
    rep = pt.io.verify_checkpoint(str(tmp / "ckpt" / "ckpt-1"), level="crc")
    assert rep["ok"] and rep["nranks"] == 2, rep


def test_dygraph_data_parallel_matches_the_jax_one(ranks):
    """The JAX DataParallel over 8 CPU devices (global batch 32) against two
    ranks of 16 rows each: rank 1 starts from other weights, which the wrap
    replaces with rank 0's; each rank's loss is its rows' mean, whose
    average over the ranks is the JAX global loss; the trained parameters
    equal on both ranks and to the JAX ones."""
    _, res, ref, _ = ranks
    jl, jparams = ref["dygraph"]
    np.testing.assert_allclose((res[0]["dy/loss"] + res[1]["dy/loss"]) / 2, jl, **TOL)
    for i, want in enumerate(jparams):
        assert res[0][f"dy/param/{i}"].tobytes() == res[1][f"dy/param/{i}"].tobytes()
        np.testing.assert_allclose(res[0][f"dy/param/{i}"], want, **TOL)
