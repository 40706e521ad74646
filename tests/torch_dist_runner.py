"""Rank script of the port's multi-process tests (``test_torch_collective.py``,
``test_torch_data_parallel.py``, ``test_torch_launch_fleet.py``), launched by
``paddle_tpu_torch.parallel.launch``: ``python tests/torch_dist_runner.py
OUT_DIR CASE[,CASE...]``. Each rank joins the gloo group on the CPU, reads
the parent's inputs from ``OUT_DIR/inputs.npz`` (the JAX startup state under
``init/<name>`` and the global batches), runs the cases and writes its
results to ``OUT_DIR/rank<r>.npz``.

The builders take ``pkg`` (``paddle_tpu`` or ``paddle_tpu_torch``) so the
parent builds the same programs for the JAX oracle. This file imports the
port only when run as a script.
"""
import os
import sys

import numpy as np

TIMEOUT = 60   # seconds: the process group's rendezvous and collective limit

#: the collective op cases: type, attrs, local input shape at world w
OP_CASES = [
    ("c_allreduce_sum", {}, lambda w: (4, 6)),
    ("c_allreduce_avg", {}, lambda w: (4, 6)),
    ("c_allreduce_max", {}, lambda w: (4, 6)),
    ("c_allreduce_min", {}, lambda w: (4, 6)),
    ("c_allreduce_prod", {}, lambda w: (4, 6)),
    ("c_allgather", {}, lambda w: (2, 3)),
    ("c_reducescatter", {}, lambda w: (2 * w, 3)),
    ("c_broadcast", {"root": 1}, lambda w: (3, 5)),
    ("alltoall", {"split_axis": 1, "concat_axis": 0}, lambda w: (2, 2 * w)),
    ("collective_permute", {"offset": 1}, lambda w: (3, 4)),
    ("reshard", {"src_dim": -1, "dst_dim": 0}, lambda w: (2 * w, 3)),
    ("c_sync_calc_stream", {}, lambda w: (2, 2)),
    ("c_sync_comm_stream", {}, lambda w: (2, 2)),
]
#: the ops whose gradient is held (max and min give none, as in the JAX package)
GRAD_OPS = ("c_allreduce_sum", "c_allreduce_avg", "c_allreduce_prod", "c_allgather",
            "c_reducescatter", "c_broadcast", "alltoall", "collective_permute")


def op_input(op_type, rank, world, kind="x"):
    """Rank ``rank``'s input (``kind`` x) or output cotangent (``kind`` w,
    of shape given by the caller) for an op case: one seed a (op, rank)."""
    shape = dict((t, s) for t, _, s in OP_CASES)[op_type](world)
    rs = np.random.RandomState(1000 * OP_CASES.index(
        next(c for c in OP_CASES if c[0] == op_type)) + 10 * rank + world)
    x = rs.uniform(0.5, 1.5, shape).astype("float32")
    if op_type in ("c_allreduce_max", "c_allreduce_min"):
        x = rs.randn(*shape).astype("float32")   # distinct values: no ties
    return x


def cotangent(op_type, rank, shape):
    rs = np.random.RandomState(7 + 31 * rank + len(op_type))
    return rs.randn(*shape).astype("float32")


def build_mlp(pkg, seed=11, opt="adam", dropout=0.0, in_dim=32, hidden=64, classes=8):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [in_dim], "float32")
        label = pkg.data("label", [1], "int64")
        h = pkg.layers.fc(x, hidden, act="relu")
        if dropout:
            h = pkg.layers.dropout(h, dropout)
        logits = pkg.layers.fc(h, classes)
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, label))
        {"adam": lambda: pkg.optimizer.Adam(0.01),
         "momentum": lambda: pkg.optimizer.Momentum(0.05, 0.9),
         "sgd": lambda: pkg.optimizer.SGD(0.05)}[opt]().minimize(loss)
    return main, startup, loss, h


def build_fc_fetch(pkg, static=False):
    """An fc whose output is a batch-carrying fetch (dim 0 -1, or static 16)."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = (pkg.data("x", [16, 8], "float32", append_batch_size=False) if static
             else pkg.data("x", [8], "float32"))
        y = pkg.layers.fc(x, 4)
        loss = pkg.layers.mean(y)
        pkg.optimizer.SGD(0.01).minimize(loss)
    return main, startup, y, loss


def build_conv_bn(pkg):
    """A tiny conv + batch_norm net: its statistics are the global batch's."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, 6, 6], "float32")
        c = pkg.layers.conv2d(img, 4, 3, padding=1)
        b = pkg.layers.batch_norm(c, act="relu")
        loss = pkg.layers.mean(pkg.layers.reduce_sum(b * b, dim=[1, 2, 3]))
        pkg.optimizer.SGD(0.05).minimize(loss)
    return main, startup, loss, b


def mlp_feeds(steps=3, batch=16, in_dim=32, classes=8, seed=5):
    rs = np.random.RandomState(seed)
    return [{"x": rs.randn(batch, in_dim).astype("float32"),
             "label": rs.randint(0, classes, (batch, 1)).astype("int64")}
            for _ in range(steps)]


def persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


# ------------------------------------------------------------------ cases --

def case_ops(pt, rank, world, data, res):
    """Every collective op type's lowering at this world, and the gradients
    of the linear ones, on this rank's inputs."""
    import torch
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import collective as coll
    with coll.bind({"dp": coll.world_group("dp")}):
        for t, attrs, _ in OP_CASES:
            x = torch.from_numpy(op_input(t, rank, world))
            ctx = registry.LowerCtx(dict(attrs, axis_name="dp"), "cpu")
            res[f"ops/{t}"] = registry.get(t).lower(ctx, {"X": [x]})["Out"][0].numpy()
            if t in GRAD_OPS:
                xg = x.clone().requires_grad_(True)
                with torch.enable_grad():
                    y = registry.get(t).lower(ctx, {"X": [xg]})["Out"][0]
                    w = torch.from_numpy(cotangent(t, rank, tuple(y.shape)))
                    (y * w).sum().backward()
                res[f"grad/{t}"] = xg.grad.numpy()
        # the reverse reshard: the block of rank r back to the whole tensor
        x = torch.from_numpy(op_input("reshard", rank, world))
        ctx = registry.LowerCtx({"axis_name": "dp", "src_dim": 0, "dst_dim": -1}, "cpu")
        res["ops/reshard_gather"] = registry.get("reshard").lower(ctx, {"X": [x]})["Out"][0].numpy()
    # unbound: the identity
    x = torch.from_numpy(op_input("c_allreduce_sum", rank, world))
    ctx = registry.LowerCtx({"axis_name": "dp"}, "cpu")
    res["ops/unbound"] = registry.get("c_allreduce_sum").lower(ctx, {"X": [x]})["Out"][0].numpy()


def _init_scope(pt, data, prefix="init/"):
    from paddle_tpu_torch import convert
    scope = pt.Scope()
    init = {k[len(prefix):]: data[k] for k in data.files if k.startswith(prefix)}
    convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
    return scope


def _slice(feed, rank, world):
    from paddle_tpu_torch.parallel import env
    return {k: env.shard_batch(v, rank, world) for k, v in feed.items()}


def case_mlp(pt, rank, world, data, res):
    """Adam MLP steps under AllReduce, Reduce (ZeRO) and Reduce with
    reduce_params, from the parent's startup state, each rank on its rows."""
    feeds = mlp_feeds()
    for mode in ("allreduce", "reduce", "reduce_params"):
        main, _, loss, _ = build_mlp(pt)
        bs = pt.BuildStrategy()
        if mode != "allreduce":
            bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
            bs.reduce_params = mode == "reduce_params"
        cp = pt.CompiledProgram(main, bs).with_data_parallel(loss_name=loss.name)
        exe = pt.Executor(pt.CPUPlace())
        scope = _init_scope(pt, data)
        losses = []
        with pt.scope_guard(scope):
            for f in feeds:
                lv, = exe.run(cp, feed=_slice(f, rank, world), fetch_list=[loss])
                losses.append(float(np.asarray(lv).reshape(())))
        res[f"{mode}/loss"] = np.asarray(losses, np.float32)
        for n in persistables(main):
            v = scope.find_var(n)
            res[f"{mode}/state/{n}"] = v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def case_fetch(pt, rank, world, data, res):
    """A batch-carrying fetch comes back whole on every rank."""
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    for static in (False, True):
        main, _, y, _ = build_fc_fetch(pt, static)
        cp = pt.CompiledProgram(main).with_data_parallel()
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(_init_scope(pt, data, "fetch_init/")):
            out, = exe.run(cp, feed={"x": _slice({"x": x}, rank, world)["x"]},
                           fetch_list=[y])
        res[f"fetch/{'static' if static else 'dynamic'}"] = out


def case_dropout(pt, rank, world, data, res):
    """Every rank fed the same rows: the ranks' dropout masks differ."""
    main, startup, loss, h = build_mlp(pt, seed=3, dropout=0.5, opt="sgd")
    cp = pt.CompiledProgram(main).with_data_parallel()
    exe = pt.Executor(pt.CPUPlace())
    rs = np.random.RandomState(0)
    hs, losses = [], []
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(3):
            f = {"x": rs.randn(8, 32).astype("float32"),
                 "label": rs.randint(0, 8, (8, 1)).astype("int64")}
            lv, hv = exe.run(cp, feed=f, fetch_list=[loss, h])
            losses.append(float(np.asarray(lv).reshape(())))
            hs.append(hv)
    res["dropout/loss"] = np.asarray(losses)
    res["dropout/h"] = np.stack(hs)


def case_capture(pt, rank, world, data, res):
    """Under gloo the step is refused capture, with the reason."""
    from paddle_tpu_torch.core.executor import capture_refusal
    from paddle_tpu_torch.ops import collective as coll
    main, _, loss, _ = build_mlp(pt)
    cp = pt.CompiledProgram(main).with_data_parallel()
    from paddle_tpu_torch import comm
    comm.sync_program(main, cp, explicit=True)
    with coll.bind({"dp": coll.world_group("dp")}):
        res["capture/refusal"] = np.array(capture_refusal(main) or "")
    res["capture/unbound"] = np.array(capture_refusal(main) or "")


def case_feedcheck(pt, rank, world, data, res):
    """Ranks feeding different row counts raise on every rank."""
    main, startup, loss, _ = build_mlp(pt)
    cp = pt.CompiledProgram(main).with_data_parallel()
    exe = pt.Executor(pt.CPUPlace())
    rows = 8 + 2 * rank
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        try:
            exe.run(cp, feed={"x": np.zeros((rows, 32), "float32"),
                              "label": np.zeros((rows, 1), "int64")}, fetch_list=[loss])
            res["feedcheck/error"] = np.array("")
        except ValueError as e:
            res["feedcheck/error"] = np.array(str(e))


def case_bn(pt, rank, world, data, res):
    """conv + batch_norm: the statistics over the global batch, with the
    data axis named ``dp`` (``with_data_parallel``) and ``batch`` (a
    strategy's own ``data_axis``)."""
    for axis in ("dp", "batch"):
        main, _, loss, _ = build_conv_bn(pt)
        cp = pt.CompiledProgram(main)
        if axis == "dp":
            cp = cp.with_data_parallel()
        else:
            cp = cp.with_strategy(pt.DistributedStrategy(
                data_axis=axis, mesh_shape={axis: world}))
        exe = pt.Executor(pt.CPUPlace())
        scope = _init_scope(pt, data, "bn_init/")
        losses = []
        with pt.scope_guard(scope):
            for i in range(2):
                img = data[f"bn_img{i}"]
                lv, = exe.run(cp, feed={"img": _slice({"i": img}, rank, world)["i"]},
                              fetch_list=[loss])
                losses.append(float(np.asarray(lv).reshape(())))
        res[f"bn/{axis}/loss"] = np.asarray(losses, np.float32)
        for n in persistables(main):
            res[f"bn/{axis}/state/{n}"] = scope.find_var(n).numpy()


def case_dygraph(pt, rank, world, data, res):
    """dygraph DataParallel: 6 SGD steps of an MLP on this rank's rows."""
    from paddle_tpu_torch import dygraph
    W = data["dy_W"]

    class MLP(dygraph.Layer):
        def __init__(self):
            super().__init__()
            self.l1 = dygraph.Linear(16, 32, act="relu")
            self.l2 = dygraph.Linear(32, 4)

        def forward(self, x):
            return self.l2(self.l1(x))

    with dygraph.guard(pt.CPUPlace()):
        model = MLP()
        # rank 1 starts from other weights: the wrap broadcasts rank 0's
        keys = list(model.state_dict())
        model.set_dict({k: data[f"dy_init/{i}"] + (0.0 if rank == 0 else 1.0)
                        for i, k in enumerate(keys)})
        model = dygraph.DataParallel(model, dygraph.prepare_context())
        opt = dygraph.SGDOptimizer(0.1)
        losses = []
        for i in range(6):
            xb = _slice({"x": data[f"dy_x{i}"]}, rank, world)["x"]
            pred = model(dygraph.to_variable(xb))
            diff = pred - dygraph.to_variable(xb @ W)
            loss = dygraph.trace_op("mean", {"X": [diff * diff]}, {}, ["Out"])["Out"][0]
            loss = model.scale_loss(loss)
            loss.backward()
            model.apply_collective_grads()
            opt.minimize(loss, parameter_list=model.parameters())
            losses.append(float(loss.numpy().reshape(())))
        res["dy/loss"] = np.asarray(losses, np.float32)
        for i, v in enumerate(model.state_dict().values()):
            res[f"dy/param/{i}"] = np.asarray(v)


def case_ckpt(pt, rank, world, data, res, out_dir):
    """A Checkpointer save and restore of ZeRO state at this world: every
    rank's state byte for byte after the round trip."""
    from paddle_tpu_torch.utils.checkpointer import Checkpointer
    main, _, loss, _ = build_mlp(pt)
    bs = pt.BuildStrategy()
    bs.reduce_strategy = pt.BuildStrategy.ReduceStrategy.Reduce
    cp = pt.CompiledProgram(main, bs).with_data_parallel()
    exe = pt.Executor(pt.CPUPlace())
    scope = _init_scope(pt, data)
    names = persistables(main)
    ck_dir = os.path.join(out_dir, "ckpt")
    with pt.scope_guard(scope):
        for f in mlp_feeds(2):
            exe.run(cp, feed=_slice(f, rank, world), fetch_list=[loss])
        ck = Checkpointer(exe, cp, ck_dir, max_to_keep=2)
        ck.save(1)
        saved = {n: scope.find_var(n).numpy().copy() for n in names}
        exe.run(cp, feed=_slice(mlp_feeds(1, seed=9)[0], rank, world), fetch_list=[loss])
        step = ck.restore()
        restored = {n: scope.find_var(n).numpy() for n in names}
    res["ckpt/step"] = np.array(step)
    res["ckpt/equal"] = np.array(all(saved[n].tobytes() == restored[n].tobytes()
                                     for n in names))
    res["ckpt/moment_bytes"] = np.array(sum(saved[n].nbytes for n in names if "moment" in n))


def build_fleet(pkg, fleet):
    """``tests/dist_fleet_runner.py``'s program shape through ``fleet``:
    init, distributed_optimizer(...).minimize."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [32], "float32")
        loss = pkg.layers.mean(pkg.layers.fc(x, 32))
        fleet.init()
        opt = fleet.distributed_optimizer(pkg.optimizer.SGD(0.01))
        opt.minimize(loss)
    return main, startup, loss


def fleet_feed(rank):
    """Rank ``rank``'s 8 rows of the fleet case (the global batch is the
    ranks' rows in order)."""
    return {"x": np.random.RandomState(rank).rand(8, 32).astype("float32")}


def case_fleet(pt, rank, world, data, res, out_dir):
    """fleet: init, distributed_optimizer(...).minimize, main_program, the
    first worker's save, barrier_worker; from the parent's startup state."""
    from paddle_tpu_torch import convert, fleet
    main, startup, loss = build_fleet(pt, fleet)
    exe = pt.Executor(pt.CPUPlace())
    feed = fleet_feed(rank)
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        init = {k[len("fleet_init/"):]: data[k] for k in data.files
                if k.startswith("fleet_init/")}
        convert.load_state(pt.global_scope(), convert.state_from_numpy(init, device="cpu"))
        losses = [float(np.asarray(exe.run(fleet.main_program, feed=feed,
                                           fetch_list=[loss])[0]).reshape(()))
                  for _ in range(3)]
        d = os.path.join(out_dir, "fleet_model")
        fleet.save_persistables(exe, d)
        fleet.barrier_worker()
        res["fleet/w"] = pt.global_scope().find_var("fc_0.w_0").numpy()
    res["fleet/loss"] = np.asarray(losses)
    res["fleet/index"] = np.array([fleet.worker_index(), fleet.worker_num(),
                                   int(fleet.is_first_worker())])
    res["fleet/saved"] = np.array(sorted(os.listdir(d)))


def case_compress(pt, rank, world, data, res):
    """comm_compression off, int8 and bf16 (Momentum MLP, 6 steps): the
    losses and the final state, error-feedback residuals included."""
    for mode in ("off", "int8", "bf16"):
        main, _, loss, _ = build_mlp(pt, opt="momentum")
        ds = pt.DistributedStrategy(mesh_shape={"dp": world})
        ds.comm_compression = mode
        ds.comm_compress_min_bytes = 0
        cp = pt.CompiledProgram(main).with_strategy(ds)
        exe = pt.Executor(pt.CPUPlace())
        losses = []
        with pt.scope_guard(_init_scope(pt, data, "mom_init/")):
            for f in mlp_feeds(6, seed=2):
                lv, = exe.run(cp, feed=_slice(f, rank, world), fetch_list=[loss])
                losses.append(float(np.asarray(lv).reshape(())))
            res[f"compress/{mode}"] = np.asarray(losses, np.float32)
            for n in persistables(main):
                res[f"compress/{mode}/state/{n}"] = pt.global_scope().find_var(n).numpy()


def case_single(pt, rank, world, data, res):
    """4 Momentum steps of the MLP on this rank's rows, for the one-process
    comparison."""
    main, _, loss, _ = build_mlp(pt, opt="momentum")
    cp = pt.CompiledProgram(main).with_data_parallel(loss_name=loss.name)
    exe = pt.Executor(pt.CPUPlace())
    scope = _init_scope(pt, data, "mom_init/")
    with pt.scope_guard(scope):
        res["single/loss"] = np.asarray(
            [exe.run(cp, feed=_slice(f, rank, world), fetch_list=[loss])[0]
             for f in mlp_feeds(4, seed=2)]).reshape(-1)
        res["single/w"] = scope.find_var("fc_0.w_0").numpy()


CASES = {"ops": case_ops, "single": case_single, "mlp": case_mlp, "fetch": case_fetch, "dropout": case_dropout,
         "capture": case_capture, "feedcheck": case_feedcheck, "bn": case_bn,
         "dygraph": case_dygraph, "ckpt": case_ckpt, "fleet": case_fleet,
         "compress": case_compress}
NEEDS_DIR = ("ckpt", "fleet")


def main():
    out_dir, cases = sys.argv[1], sys.argv[2].split(",")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import env
    env.init_parallel_env(timeout_seconds=TIMEOUT)
    rank, world = env.get_rank(), env.get_world_size()
    path = os.path.join(out_dir, "inputs.npz")
    data = np.load(path) if os.path.exists(path) else None
    res = {}
    for c in cases:
        if c in NEEDS_DIR:
            CASES[c](pt, rank, world, data, res, out_dir)
        else:
            CASES[c](pt, rank, world, data, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    env.barrier("results written")


if __name__ == "__main__":
    main()
    # leave without the process group's C++ teardown: under a loaded host a
    # gloo rank has aborted in it ("terminate called without an active
    # exception") after every rank had written its results
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
