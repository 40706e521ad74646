"""The host-resident embedding table (``paddle_tpu_torch/ops/host_table.py``,
``layers.host_embedding``) and the executor's parameter-server schedule
around a step, held against the JAX package on the CPU.

Tolerances: the table's own arithmetic (the gather, the push's
``np.unique`` / ``np.add.at`` and the SGD / Adagrad update) is numpy in both
packages, so it is held bit for bit on the same gradients. Through a
training step the gradients that reach the table differ by the two
frameworks' f32 sums: losses ``rtol 1e-5``, dense state ``atol 5e-5`` (as
``tests/test_torch_ctr.py``), the table ``atol 1e-6`` (Adagrad divides each
row's gradient by the root of its square sum, so a relative gap of ~1e-6
in a gradient moves the update by about that much of lr = 0.05). The
port's own paths (serial against prefetch, eager against the stand-in
graph) run the same lowerings on the same tensors: bit for bit.
"""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.ops import host_table as jht
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor as ex
from paddle_tpu_torch.ops import host_table as tht
from tests.test_torch_graph_step import stand_in  # noqa: F401  (the fixture)

VOCAB, FIELDS, DIM, DENSE, BATCH = 200, 5, 4, 3, 16
TABLE = "ctr_table"


@pytest.fixture(autouse=True)
def _no_tables():
    for mod in (jht, tht):
        for name in list(mod._TABLES):
            mod.drop_table(name)
    yield
    for mod in (jht, tht):
        for name in list(mod._TABLES):
            mod.drop_table(name)


def _ctr(pkg, optimizer="adagrad", vocab=VOCAB):
    """``examples/ctr_deepfm.py``'s program at narrow widths."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data("ids", [FIELDS], "int64")
        dense = pkg.data("dense", [DENSE], "float32")
        label = pkg.data("label", [1], "float32")
        emb = pkg.layers.host_embedding(ids, (vocab, DIM), name=TABLE, optimizer=optimizer,
                                        learning_rate=0.05, seed=1)
        deep = pkg.layers.concat([pkg.layers.reshape(emb, [-1, FIELDS * DIM]), dense], axis=1)
        for width in (16, 8):
            deep = pkg.layers.fc(deep, width, act="relu")
        logit = pkg.layers.fc(deep, 1)
        prob = pkg.layers.sigmoid(logit)
        loss = pkg.layers.mean(pkg.layers.sigmoid_cross_entropy_with_logits(logit, label))
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss, prob


def _feeds(n, seed=0, shared=False):
    """``n`` batches; ``shared``: every batch repeats ids of the one before."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ids = rng.randint(0, VOCAB, (BATCH, FIELDS)).astype("int64")
        ids[0, 0] = ids[1, 0]                       # a duplicate within the batch
        if shared and out:
            ids[:4] = out[-1]["ids"][-4:]           # rows the last push just wrote
        out.append({"ids": ids, "dense": rng.rand(BATCH, DENSE).astype("float32"),
                    "label": (rng.rand(BATCH, 1) < 0.5).astype("float32")})
    return out


def _persistables(main):
    return sorted(n for n, v in main.global_block().vars.items() if v.persistable)


def _jax_startup(jm, js):
    scope = fluid.Scope()
    exe = fluid.Executor()
    with fluid.scope_guard(scope):
        exe.run(js)
    return scope, exe, {n: np.asarray(scope.find_var(n)) for n in _persistables(jm)}


def _port_scope(init):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
    return scope


# -------------------------------------------------------------------- the table


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_gather_push_and_update_equal_jax_bit_for_bit(optimizer):
    """The same seed draws the same table; pushes with duplicate ids (summed
    first), then the update, leave both packages' tables and accumulators
    equal, bit for bit, after several pushes."""
    jt = jht.create_table("t", 50, 6, optimizer=optimizer, lr=0.3, seed=4)
    tt = tht.create_table("t", 50, 6, optimizer=optimizer, lr=0.3, seed=4)
    assert np.array_equal(jt.table, tt.table)
    rng = np.random.RandomState(0)
    for _ in range(4):
        ids = rng.randint(0, 50, (7, 3))
        ids[0, 0] = ids[0, 1] = ids[2, 2]
        g = rng.randn(7, 3, 6).astype(np.float32)
        jt.push(ids, g)
        tt.push(ids, g)
        assert np.array_equal(jt.gather(ids), tt.gather(ids))
    assert np.array_equal(jt.table, tt.table) and np.array_equal(jt._accum, tt._accum)
    assert tt.push_count == jt.push_count == 4


def test_async_updates_equal_sync_after_flush():
    sync = tht.create_table("s", 30, 4, optimizer="adagrad", lr=0.1, seed=2)
    asy = tht.create_table("a", 30, 4, optimizer="adagrad", lr=0.1, seed=2, async_updates=True)
    rng = np.random.RandomState(1)
    for _ in range(6):
        ids, g = rng.randint(0, 30, 9), rng.randn(9, 4).astype(np.float32)
        sync.push(ids, g)
        asy.push(ids, g)
    asy.flush()
    assert np.array_equal(sync.table, asy.table) and asy.push_count == 6


def test_memmap_table_and_out_of_range_ids(tmp_path):
    t = tht.create_table("mm", 40, 4, optimizer="sgd", lr=1.0, mmap_dir=str(tmp_path))
    assert isinstance(t.table, np.memmap)
    before = t.table[5].copy()
    t.push(np.array([5]), np.ones((1, 4), np.float32))
    np.testing.assert_array_equal(t.table[5], before - 1.0)
    with pytest.raises(IndexError, match="out of range"):
        t.gather(np.array([3, 40]))
    with pytest.raises(ValueError, match="already exists"):
        tht.create_table("mm", 40, 8)


def test_save_all_and_load_all_across_packages(tmp_path):
    """The ``.npz`` format is the JAX package's: a port save loads in JAX
    and a JAX save in the port, table, accumulator and push count."""
    tt = tht.create_table("x", 25, 3, optimizer="adagrad", lr=0.2, seed=5)
    jt = jht.create_table("x", 25, 3, optimizer="adagrad", lr=0.2, seed=9)
    tt.push(np.array([1, 1, 4]), np.ones((3, 3), np.float32))
    tht.save_all(str(tmp_path / "port"))
    jht.load_all(str(tmp_path / "port"))
    assert np.array_equal(jt.table, tt.table) and np.array_equal(jt._accum, tt._accum)
    assert jt.push_count == 1
    jt.push(np.array([7]), np.full((1, 3), 2.0, np.float32))
    jht.save_all(str(tmp_path / "jax"))
    tht.load_all(str(tmp_path / "jax"))
    assert np.array_equal(jt.table, tt.table) and tt.push_count == 2


def test_the_unported_paths_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="item 13"):
        tht.HostTable("r", 10, 2, row_shard=(0, 2))
    t = tht.create_table("e", 10, 2)
    with pytest.raises(NotImplementedError, match="online/.*item 10"):
        t.export_delta(0)
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup):
        ids = pt.data("ids", [2], "int64")
        with pytest.raises(NotImplementedError, match="item 13"):
            pt.layers.host_embedding(ids, (10, 2), name="rs", row_shard_axis="host")


# ------------------------------------------------------------------ the program


def test_the_program_and_its_hoisting_match_jax():
    """The same ops in order; hoisting drops the pull and the push, makes
    the lookup's output a feed and zero-fills the anchor's gradient, with
    the same pulls and pushes as the JAX executor's."""
    jm, *_ = _ctr(fluid)
    tm, *_ = _ctr(pt)
    assert tm.to_dict()["blocks"][0]["ops"] == jm.to_dict()["blocks"][0]["ops"]
    jh, jpulls, jpushes = jht.hoist_host_pulls(jm)
    th, tpulls, tpushes = tht.hoist_host_pulls(tm)
    assert (tpulls, tpushes) == (jpulls, jpushes) and len(tpulls) == 1
    assert th.to_dict()["blocks"][0]["ops"] == jh.to_dict()["blocks"][0]["ops"]
    types = [op.type for op in th.global_block().ops]
    assert "host_lookup_table" not in types and "host_push_grad" not in types
    assert th.global_block().var(tpulls[0][2]).is_data
    assert ex.capture_refusal(th) is None
    assert "host memory" in ex.capture_refusal(tm)


def test_three_steps_of_the_tiny_ctr_deepfm_match_jax():
    """``examples/ctr_deepfm.py``'s program at narrow widths, 3 Adam steps
    with Adagrad on the host table: losses, every dense state tensor and the
    table against the JAX package, from its startup state."""
    jm, js, jl, _ = _ctr(fluid)
    tm, _, tl, _ = _ctr(pt)
    feeds = _feeds(3)
    jscope, jexe, init = _jax_startup(jm, js)
    with fluid.scope_guard(jscope):
        jloss = [jexe.run(jm, feed=f, fetch_list=[jl])[0] for f in feeds]
    tscope = _port_scope(init)
    with pt.scope_guard(tscope):
        tloss = [pt.Executor(pt.CPUPlace()).run(tm, feed=f, fetch_list=[tl])[0]
                 for f in feeds]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for n in init:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), np.asarray(jscope.find_var(n)),
                                   atol=5e-5, err_msg=n)
    jt, tt = jht.get_table(TABLE), tht.get_table(TABLE)
    np.testing.assert_allclose(tt.table, jt.table, atol=1e-6)
    np.testing.assert_allclose(tt._accum, jt._accum, rtol=1e-5, atol=1e-9)
    assert tt.push_count == jt.push_count == 3
    # the run counter: the port keeps it on the caller's program, the JAX
    # package on its hoisted copy (ROADMAP fault 3.16)
    assert tm._rng_run_counter == 3 and getattr(jm, "_rng_run_counter", 0) == 0


def test_a_checkpoint_does_not_hold_the_host_table_in_either_package(tmp_path):
    """ROADMAP fault 3.14, kept by the port: ``Checkpointer`` saves the
    scope's persistables (the anchor, not the table), so a restore leaves
    the table as the later pushes left it; ``save_all`` / ``load_all`` at
    the same boundary carry it."""
    from paddle_tpu.utils.checkpointer import Checkpointer as JCheckpointer
    from paddle_tpu_torch.utils.checkpointer import Checkpointer
    feeds = _feeds(2)
    jm, js, jl, _ = _ctr(fluid)
    tm, ts, tl, _ = _ctr(pt)
    jscope, jexe, init = _jax_startup(jm, js)
    tscope, texe = _port_scope(init), pt.Executor(pt.CPUPlace())
    for pkg, ck_cls, m, lv, scope, exe, guard, mod in (
            ("jax", JCheckpointer, jm, jl, jscope, jexe, fluid.scope_guard, jht),
            ("port", Checkpointer, tm, tl, tscope, texe, pt.scope_guard, tht)):
        d = str(tmp_path / pkg)
        with guard(scope):
            exe.run(m, feed=feeds[0], fetch_list=[lv])
            ck = ck_cls(exe, m, d)
            ck.save(0)
            mod.save_all(os.path.join(d, "tables"))
            saved = mod.get_table(TABLE).table.copy()
            exe.run(m, feed=feeds[1], fetch_list=[lv])
            ck.restore()
        assert not os.path.exists(os.path.join(d, "ckpt-0", f"host_table.{TABLE}.npz"))
        assert not np.array_equal(mod.get_table(TABLE).table, saved), pkg
        mod.load_all(os.path.join(d, "tables"))
        assert np.array_equal(mod.get_table(TABLE).table, saved) and \
            mod.get_table(TABLE).push_count == 1


def test_a_pruned_eval_pulls_what_it_reads_and_pushes_nothing():
    """``use_prune=True`` fetching ``prob`` pulls (it reads the rows) but
    pushes nothing and updates nothing; fetching ``dense`` alone needs no
    ids at all; an unpruned run without the ids raises naming use_prune."""
    tm, ts, tl, prob = _ctr(pt)
    scope, exe = pt.Scope(), pt.Executor(pt.CPUPlace())
    f = _feeds(1)[0]
    with pt.scope_guard(scope):
        exe.run(ts)
        before = {n: scope.find_var(n).clone() for n in _persistables(tm)}
        table = tht.get_table(TABLE).table.copy()
        p, = exe.run(tm, feed=f, fetch_list=[prob], use_prune=True)
        d, = exe.run(tm, feed={"dense": f["dense"]}, fetch_list=["dense"], use_prune=True)
        with pytest.raises(KeyError, match="use_prune"):
            exe.run(tm, feed={"dense": f["dense"], "label": f["label"]}, fetch_list=[tl])
    assert p.shape == (BATCH, 1) and np.array_equal(d, f["dense"])
    assert tht.get_table(TABLE).push_count == 0
    assert np.array_equal(tht.get_table(TABLE).table, table)
    assert all(torch.equal(scope.find_var(n), t) for n, t in before.items())


def test_serial_and_prefetch_loops_are_bit_equal_with_shared_ids(tmp_path):
    """Consecutive batches share ids, so a pull that ran ahead of the last
    push would read a stale row: ``train_from_dataset``'s prefetch loop
    (the pull in ``run``, never on the worker) equals the serial loop bit
    for bit, table, accumulator and dense state."""
    tm, ts, tl, _ = _ctr(pt)
    feeds = _feeds(6, shared=True)
    path = str(tmp_path / "part-0.txt")
    with open(path, "w") as fh:
        for f in feeds:
            for i in range(BATCH):
                fh.write(" ".join(map(str, f["ids"][i])) + ";"
                         + " ".join(repr(float(x)) for x in f["dense"][i]) + ";"
                         + repr(float(f["label"][i, 0])) + "\n")
    init_scope = pt.Scope()
    with pt.scope_guard(init_scope):
        pt.Executor(pt.CPUPlace()).run(ts)
    init = {n: init_scope.find_var(n).clone() for n in _persistables(tm)}
    table0 = tht.get_table(TABLE).table.copy()
    results = {}
    for loop in ("serial", "prefetch"):
        t = tht.get_table(TABLE)
        t.table[:], t._accum[:], t.push_count = table0, 0, 0
        scope = pt.Scope()
        for n, v in init.items():
            scope.set_var(n, v.clone())
        tm._rng_run_counter = 0
        exe = pt.Executor(pt.CPUPlace())
        with pt.scope_guard(scope):
            if loop == "serial":
                for f in feeds:
                    exe.run(tm, feed=f, fetch_list=[tl])
            else:
                ds = pt.DatasetFactory().create_dataset("QueueDataset")
                ds.set_batch_size(BATCH)
                ds.set_use_var([tm.global_block().var(n) for n in ("ids", "dense", "label")])
                ds.set_filelist([path])
                exe.train_from_dataset(tm, ds, fetch_list=[tl], thread=3)
        results[loop] = ({n: scope.find_var(n).clone() for n in init}, t.table.copy(),
                         t._accum.copy(), t.push_count)
    (sa, st, sc, sn), (pa, pt_, pc, pn) = results["serial"], results["prefetch"]
    assert sn == pn == len(feeds)
    assert np.array_equal(st, pt_) and np.array_equal(sc, pc)
    assert all(torch.equal(sa[n], pa[n]) for n in sa)


def test_pulls_and_pushes_around_a_replay(stand_in):
    """On the CPU stand-in graph: the hoisted step is captured once (the
    rows a feed staged into the graph's buffer, the row gradient an extra
    fetch read after the replay, the push on the host between replays),
    keyed by the hoisted program; 4 steps equal 4 eager steps bit for bit,
    losses, dense state and table."""
    tm, ts, tl, _ = _ctr(pt)
    feeds = _feeds(4, shared=True)
    init_scope = pt.Scope()
    with pt.scope_guard(init_scope):
        pt.Executor(pt.CPUPlace()).run(ts)
    init = {n: init_scope.find_var(n).clone() for n in _persistables(tm)}
    table0 = tht.get_table(TABLE).table.copy()
    out = {}
    for graphs in (True, False):
        t = tht.get_table(TABLE)
        t.table[:], t._accum[:], t.push_count = table0, 0, 0
        scope = pt.Scope()
        for n, v in init.items():
            scope.set_var(n, v.clone())
        exe = pt.Executor(pt.CPUPlace())
        exe._use_graphs = graphs
        with pt.scope_guard(scope):
            losses = [exe.run(tm, feed=f, fetch_list=[tl])[0] for f in feeds]
        out[graphs] = (losses, {n: scope.find_var(n) for n in init}, t.table.copy(), exe)
    (gl, gs, gt, gexe), (el, es, et, _) = out[True], out[False]
    assert all(np.array_equal(a, b) for a, b in zip(gl, el))
    assert all(torch.equal(gs[n], es[n]) for n in gs) and np.array_equal(gt, et)
    assert stand_in.captures == 1 and tht.get_table(TABLE).push_count == 4
    (key, step), = gexe._cache.items()
    _, hoisted, pulls, pushes = gexe._hoisted(tm)
    rows, grad = pulls[0][2], pushes[0][2]
    assert key[0] == id(hoisted) and rows in step.feeds and grad in key[3]


@pytest.mark.parametrize("graphs", [False, True])
def test_a_fetch_fault_is_retried_with_one_update_and_one_push(graphs, request):
    """``exc@fetch`` on a host-table program under the guardian, eagerly
    and on the CPU stand-in graph: the executor undoes the step's dense
    update before it raises and pushes nothing, so the retry leaves the
    losses, the dense state, the table and ``push_count`` as the clean run
    does, bit for bit."""
    from paddle_tpu_torch.resilience import StepGuardian, faults
    if graphs:
        request.getfixturevalue("stand_in")
    tm, ts, tl, _ = _ctr(pt)
    feeds = _feeds(3, shared=True)
    init_scope = pt.Scope()
    with pt.scope_guard(init_scope):
        pt.Executor(pt.CPUPlace()).run(ts)
    init = {n: init_scope.find_var(n).clone() for n in _persistables(tm)}
    table0 = tht.get_table(TABLE).table.copy()
    out = {}
    try:
        for spec in (None, "exc@fetch:step=1"):
            t = tht.get_table(TABLE)
            t.table[:], t._accum[:], t.push_count = table0, 0, 0
            scope = pt.Scope()
            for n, v in init.items():
                scope.set_var(n, v.clone())
            tm._rng_run_counter = 0
            if spec:
                faults.install(spec)
            exe = pt.Executor(pt.CPUPlace())
            exe._use_graphs = graphs
            with pt.scope_guard(scope):
                g = StepGuardian(exe, tm, retry_backoff=0.001)
                losses = [g.run(feed=f, fetch_list=[tl])[0] for f in feeds]
            out[spec] = (losses, {n: scope.find_var(n) for n in init}, t.table.copy(),
                         t._accum.copy(), t.push_count, [f.fired for f in faults.active()])
            faults.clear()
    finally:
        faults.clear()
    (cl, cs, ct, ca, cp, _), (fl, fs, ft, fa, fp, fired) = out[None], out["exc@fetch:step=1"]
    assert all(np.array_equal(a, b) for a, b in zip(cl, fl))
    assert all(torch.equal(cs[n], fs[n]) for n in cs)
    assert np.array_equal(ct, ft) and np.array_equal(ca, fa)
    assert cp == fp == 3 and fired == [1]


def test_run_fused_is_refused_and_the_dataset_loop_runs_unfused(tmp_path):
    """The JAX reason, from ``run_fused`` and ``train_from_dataset(fuse_steps=2)``
    (a warning, then the unfused loop)."""
    tm, ts, tl, _ = _ctr(pt)
    feeds = _feeds(2)
    exe, scope = pt.Executor(pt.CPUPlace()), pt.Scope()
    with pt.scope_guard(scope):
        exe.run(ts)
        with pytest.raises(ValueError, match=r"host-table pulls/pushes \(PS schedule\)"):
            exe.run_fused(tm, feeds=feeds, fetch_list=[tl])
        assert exe._fuse_ineligible(tm) == "host-table pulls/pushes (PS schedule)"
        path = str(tmp_path / "p.txt")
        with open(path, "w") as fh:
            for f in feeds:
                for i in range(BATCH):
                    fh.write(" ".join(map(str, f["ids"][i])) + ";0.1 0.2 0.3;1\n")
        ds = pt.DatasetFactory().create_dataset("QueueDataset")
        ds.set_batch_size(BATCH)
        ds.set_use_var([tm.global_block().var(n) for n in ("ids", "dense", "label")])
        ds.set_filelist([path])
        with pytest.warns(UserWarning, match=r"host-table pulls/pushes.*running unfused"):
            exe.train_from_dataset(tm, ds, fetch_list=[tl], fuse_steps=2)
    assert tht.get_table(TABLE).push_count == 2


def test_a_lookup_on_computed_ids_runs_in_the_step_and_is_not_captured(stand_in):
    """Ids that do not come straight from a feed keep the in-step pull and
    push (not hoisted): the program is refused capture and runs eagerly,
    and one step equals the JAX package's (its in-graph callbacks)."""
    def build(pkg):
        main, startup = pkg.Program(), pkg.Program()
        main.random_seed = startup.random_seed = 3
        with pkg.unique_name.guard(), pkg.program_guard(main, startup):
            raw = pkg.data("raw", [FIELDS], "int64")
            ids = pkg.layers.elementwise_add(raw, raw)      # computed ids
            label = pkg.data("label", [1], "float32")
            emb = pkg.layers.host_embedding(ids, (2 * VOCAB, DIM), name=TABLE,
                                            optimizer="sgd", learning_rate=0.5, seed=1)
            logit = pkg.layers.fc(pkg.layers.reshape(emb, [-1, FIELDS * DIM]), 1)
            loss = pkg.layers.mean(pkg.layers.sigmoid_cross_entropy_with_logits(logit, label))
            pkg.optimizer.SGD(0.1).minimize(loss)
        return main, startup, loss
    jm, js, jl = build(fluid)
    tm, _, tl = build(pt)
    f = _feeds(1)[0]
    feed = {"raw": f["ids"], "label": f["label"]}
    assert tht.hoist_host_pulls(tm)[1] == []
    jscope, jexe, init = _jax_startup(jm, js)
    with fluid.scope_guard(jscope):
        jloss = jexe.run(jm, feed=feed, fetch_list=[jl])[0]
    tscope = _port_scope(init)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(tscope), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tloss = exe.run(tm, feed=feed, fetch_list=[tl])[0]
    assert any("host memory" in str(w.message) for w in caught)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(tht.get_table(TABLE).table, jht.get_table(TABLE).table,
                               atol=1e-6)
    assert stand_in.captures == 0
