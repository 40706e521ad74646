"""The executor's compiled training step (``core/executor.py``,
``core/graphs.py``), ``run_fused`` and the freeing of dead intermediates,
held on the CPU.

A CUDA graph runs only on the card (``chip_smoke.py`` holds the captured
BERT-base and ResNet-50 steps there against the eager executor, bit for
bit). Here a stand-in takes ``graphs.Graph``'s place -- its capture runs
nothing, its replay runs the captured function again -- and ``warm_up`` runs
its function directly, so the executor's cache, its binding of the scope's
state, the copy-back of state that is not updated in place, the identity
guard, the write-only persistables and the run counter written before each
replay run as they do on the card, with the plain versions of the kernels.
The dropout masks of a replay come from the counter tensor alone (the
captured step's host counter is 0), so a replay that drew the wrong masks
would part from the eager run. Tolerances: bit for bit (``torch.equal``)
between the port's own paths, which run the same lowerings on the same
tensors; against the JAX package's ``run_fused`` the f32 tolerances of
``tests/test_torch_training.py`` (losses ``rtol 1e-5``, state ``atol
5e-5``: the frameworks sum in other orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import executor as ex
from paddle_tpu_torch.core.executor import dead_after, trace_block
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.contrib import fuse_conv_bn_stats as tfuse
from tests import test_torch_resnet as tr
from tests import test_torch_training as tt


class _StandInGraph:
    """``graphs.Graph`` without a card: the capture runs nothing; each replay
    runs the captured function, whose outputs are then the graph's."""
    captures = 0

    def __init__(self, device, fn):
        _StandInGraph.captures += 1
        self.fn, self.outputs, self.memory_bytes, self.launches = fn, None, 0, {}

    def replay(self):
        self.outputs = self.fn()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(ex.cuda_graphs, "Graph", _StandInGraph)
    monkeypatch.setattr(ex.cuda_graphs, "warm_up", lambda device, fn: fn())
    monkeypatch.setattr(ex.Executor, "_captures", lambda self: self._use_graphs)
    _StandInGraph.captures = 0
    return _StandInGraph


def _init(startup, main):
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    return {n: scope.find_var(n).clone() for n, v in main.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _scope(init):
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    return scope


def _run(main, loss, feed, init, steps, graphs=True, fetch=(), exe=None):
    """``steps`` runs from ``init``, counter from 0: (fetches per step, scope, exe)."""
    exe = exe or pt.Executor(pt.CPUPlace())
    exe._use_graphs = graphs
    scope = _scope(init)
    main._rng_run_counter = 0
    with pt.scope_guard(scope):
        outs = [exe.run(main, feed=feed, fetch_list=[loss, *fetch], return_numpy=False)
                for _ in range(steps)]
    return outs, scope, exe


@pytest.fixture(scope="module")
def bert():
    main, startup, loss, _ = tt._build(pt, tbert, dropout=0.1)
    return main, loss, tt._feeds(), _init(startup, main)


def _same_state(a, b, names):
    return [n for n in names if not torch.equal(a.find_var(n), b.find_var(n))]


# ------------------------------------------------------------- the captured step


def test_the_captured_step_equals_the_eager_one_bit_for_bit(bert, stand_in):
    """Tiny BERT with dropout 0.1: four steps through the cache (warm-up,
    capture + replay, replays) against four eager steps: every loss, a
    dropout op's Mask and every state tensor bit for bit; the Mask differs
    between steps; one step captured once."""
    main, loss, feed, init = bert
    mask = next(op for op in main.global_block().ops if op.type == "dropout").output("Mask")[0]
    g, gs, exe = _run(main, loss, feed, init, 4, graphs=True, fetch=[mask])
    e, es, _ = _run(main, loss, feed, init, 4, graphs=False, fetch=[mask])
    for a, b in zip(g, e):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(g[1][1], g[2][1])
    assert _same_state(gs, es, init) == []
    assert stand_in.captures == 1 and len(exe._cache) == 1
    step, = exe._cache.values()
    assert step.warmed and step.graph is not None and step.refusal is None
    assert main._rng_run_counter == 4
    # the graph's state tensors are the scope's: updated in place, not rebound
    assert all(gs.find_var(n) is t for n, t in step.state.items())


def test_batch_norm_state_is_copied_back(stand_in, monkeypatch):
    """A one-block-per-stage ResNet at 64 x 64 (batch norms, whose MeanOut is
    a new tensor each step, and Momentum): three captured steps equal three
    eager ones bit for bit, the running statistics included."""
    monkeypatch.setitem(tres._DEPTHS, 50, [1, 1, 1, 1])
    main, startup, loss, fused, _ = tr._build(pt, tres, tfuse)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(2, 64, 64, 3).astype("float32"),
            "label": rng.randint(0, 10, (2, 1)).astype("int64")}
    init = _init(startup, main)
    g, gs, _ = _run(main, loss, feed, init, 3, graphs=True)
    e, es, _ = _run(main, loss, feed, init, 3, graphs=False)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(g, e))
    means = [n for n in init if ".global_" in n]       # the running mean and variance
    assert means and _same_state(gs, es, init) == []
    assert any(not torch.equal(gs.find_var(n), init[n]) for n in means)


def test_the_identity_guard_copies_in_a_rebound_state(bert, stand_in):
    """A state tensor the scope rebinds between replays (a load) is copied
    into the graph's, and the scope is bound to the graph's tensor again."""
    main, loss, feed, init = bert
    name = "layer0_attn_qkv_w"
    new = torch.from_numpy(np.random.RandomState(5).randn(*init[name].shape).astype("float32"))
    losses = {}
    for graphs in (True, False):
        exe = pt.Executor(pt.CPUPlace())
        exe._use_graphs = graphs
        scope = _scope(init)
        main._rng_run_counter = 0
        with pt.scope_guard(scope):
            for _ in range(2):
                exe.run(main, feed=feed, fetch_list=[loss])
            held = scope.find_var(name)
            scope.set_var(name, new.numpy())
            losses[graphs] = exe.run(main, feed=feed, fetch_list=[loss], return_numpy=False)[0]
        if graphs:
            step, = exe._cache.values()
            assert scope.find_var(name) is step.state[name] is held
    assert torch.equal(losses[True], losses[False])


def _write_only_program():
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        x = pt.data("x", [3], "float32", append_batch_size=False)
        snap = main.global_block().create_var("snap", [3], "float32")
        snap.persistable = True
        main.global_block().append_op("scale", inputs={"X": [x]}, outputs={"Out": ["snap"]},
                                      attrs={"scale": 2.0})
    return main


def test_a_write_only_persistable_comes_back_as_a_copy(stand_in):
    main = _write_only_program()
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    seen = []
    with pt.scope_guard(scope):
        for i in range(4):
            exe.run(main, feed={"x": np.full(3, i, "float32")})
            seen.append(scope.find_var("snap"))
    assert [t.tolist() for t in seen] == [[2.0 * i] * 3 for i in range(4)]
    assert stand_in.captures == 1


def test_a_host_rng_program_is_not_captured(stand_in):
    """A startup program (gaussian_random, uniform_random) runs eagerly on
    every run; the cache records why."""
    main, startup, _, _ = tt._build(pt, tbert)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        for _ in range(3):
            exe.run(startup)
    step, = exe._cache.values()
    assert "host-seeded" in step.refusal and step.graph is None
    assert stand_in.captures == 0
    assert ex.capture_refusal(main) is None


def test_the_cache_key_and_its_bound(bert, stand_in, monkeypatch):
    main, loss, feed, init = bert
    monkeypatch.setattr(ex.Executor, "_CACHE_CAP", 2)
    exe = pt.Executor(pt.CPUPlace())
    scope = _scope(init)
    with pt.scope_guard(scope):
        exe.run(main, feed=feed, fetch_list=[loss])
        exe.run(main, feed=feed, fetch_list=[loss, "mask_pos"])        # another fetch list
        assert len(exe._cache) == 2
        exe.run(main, feed=feed, fetch_list=[loss], scope=_scope(init))  # another scope
    assert len(exe._cache) == 2                                         # LRU: the oldest went
    keys = list(exe._cache)
    assert keys[0][3] == (loss.name, "mask_pos") and keys[1][5] != id(scope)
    exe.close()
    assert len(exe._cache) == 0


def test_eager_state_is_updated_in_place(bert):
    """On the CPU too the update writes the scope's own tensors: one the
    caller holds changes, as donation does in JAX."""
    main, loss, feed, init = bert
    scope = _scope(init)
    name = next(n for n in init if n.endswith("moment1_0"))
    held = scope.find_var(name)
    before = held.clone()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[loss])
    assert scope.find_var(name) is held and not torch.equal(held, before)


def test_numpy_state_is_not_written_through(bert):
    main, loss, feed, init = bert
    scope = _scope(init)
    name = next(n for n in init if n.endswith("moment1_0"))
    arr = init[name].numpy().copy()
    scope.set_var(name, arr)
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[loss])
    assert np.array_equal(arr, init[name].numpy())
    assert isinstance(scope.find_var(name), torch.Tensor)


# ------------------------------------------------------------- run_fused


def test_run_fused_contract(bert):
    """Mirrors tests/test_fused_steps.py: K = 3 equals three ``run`` calls bit
    for bit, fetches stacked (K, ...) as tensors (numpy on request), the
    counter advanced by K; K = 1 delegates to ``run``."""
    main, loss, feed, init = bert
    feeds = [tt._feeds(seed=s) for s in range(3)]
    three, scope3, _ = [], _scope(init), None
    exe = pt.Executor(pt.CPUPlace())
    main._rng_run_counter = 0
    with pt.scope_guard(scope3):
        three = [exe.run(main, feed=f, fetch_list=[loss], return_numpy=False)[0] for f in feeds]
    main._rng_run_counter = 0
    scope = _scope(init)
    with pt.scope_guard(scope):
        stacked, = pt.Executor(pt.CPUPlace()).run_fused(main, feeds=feeds, fetch_list=[loss])
        assert isinstance(stacked, torch.Tensor) and stacked.shape == (3,) + tuple(three[0].shape)
        assert main._rng_run_counter == 3
        host, = pt.Executor(pt.CPUPlace()).run_fused(main, feeds=feeds, fetch_list=[loss],
                                                     return_numpy=True)
        assert isinstance(host, np.ndarray) and host.shape[0] == 3
    assert main._rng_run_counter == 6
    assert torch.equal(stacked, torch.stack(three))
    # scope went through 6 steps; a fresh one through the fused 3 equals three runs
    main._rng_run_counter = 0
    scope = _scope(init)
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run_fused(main, feeds=feeds, fetch_list=[loss])
    assert _same_state(scope, scope3, init) == []
    # K = 1
    main._rng_run_counter = 0
    with pt.scope_guard(_scope(init)):
        one, = pt.Executor(pt.CPUPlace()).run_fused(main, feeds=feeds[:1], fetch_list=[loss],
                                                    return_numpy=True)
    assert one.shape == (1,) + tuple(three[0].shape) and one[0] == three[0].numpy()
    assert main._rng_run_counter == 1


def test_run_fused_takes_a_stacked_feed(bert):
    main, loss, feed, init = bert
    feeds = [tt._feeds(seed=s) for s in range(2)]
    stacked = {n: np.stack([f[n] for f in feeds]) for n in feeds[0]}
    out = {}
    for kw in ({"feeds": feeds}, {"stacked_feed": stacked}):
        main._rng_run_counter = 0
        with pt.scope_guard(_scope(init)):
            out[len(out)], = pt.Executor(pt.CPUPlace()).run_fused(main, fetch_list=[loss], **kw)
    assert torch.equal(out[0], out[1])


def test_run_fused_refuses_what_it_cannot_fuse(bert):
    main, loss, feed, init = bert
    _, startup, _, _ = tt._build(pt, tbert)
    exe = pt.Executor(pt.CPUPlace())
    with pytest.raises(ValueError, match="cannot run fused.*host-seeded"):
        exe.run_fused(startup, feeds=[{}, {}])
    with pytest.raises(TypeError, match="CompiledProgram"):
        exe.run_fused(object(), feeds=[feed, feed])
    with pytest.raises(ValueError, match="non-empty"):
        exe.run_fused(main, feeds=[])


def test_run_fused_replays_the_graph(bert, stand_in):
    """K = 3 on the stand-in graph: warm-up, capture, replays, equal to three
    eager runs bit for bit, with the counter written before each replay."""
    main, loss, feed, init = bert
    feeds = [tt._feeds(seed=s) for s in range(3)]
    out = {}
    for graphs in (True, False):
        exe = pt.Executor(pt.CPUPlace())
        exe._use_graphs = graphs
        main._rng_run_counter = 0
        scope = _scope(init)
        with pt.scope_guard(scope):
            losses, = exe.run_fused(main, feeds=feeds, fetch_list=[loss])
        out[graphs] = (losses, scope)
    assert torch.equal(out[True][0], out[False][0])
    assert _same_state(out[True][1], out[False][1], init) == []
    assert stand_in.captures == 1


def test_run_fused_matches_jax():
    """Tiny BERT, f32, dropout 0, K = 3: the port's stacked losses and final
    state against the JAX package's ``run_fused`` from the same weights."""
    jm, js, jt, _ = tt._build(fluid, jbert)
    tm, _, ttot, _ = tt._build(pt, tbert)
    feeds = [tt._feeds(seed=s) for s in range(3)]
    names = sorted(n for n, v in jm.global_block().vars.items() if v.persistable)
    jscope = fluid.Scope()
    with fluid.scope_guard(jscope):
        exe = fluid.Executor()
        exe.run(js)
        init = {n: np.asarray(jscope.find_var(n)) for n in names}
        jl, = exe.run_fused(jm, feeds=feeds, fetch_list=[jt], return_numpy=True)
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in names}
    tscope = pt.Scope()
    convert.load_state(tscope, convert.state_from_numpy(init, device="cpu"))
    with pt.scope_guard(tscope):
        tl, = pt.Executor(pt.CPUPlace()).run_fused(tm, feeds=feeds, fetch_list=[ttot],
                                                   return_numpy=True)
    assert tl.shape == np.shape(jl)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], atol=5e-5, err_msg=n)


# ------------------------------------------------------------- dead intermediates


def _chain():
    """a -> tanh -> b -> scale -> c -> tanh -> d, and e = scale(b)."""
    prog = pt.Program()
    blk = prog.global_block()
    for n in "abcde":
        blk.create_var(n, [4], "float32")
    blk.append_op("tanh", inputs={"X": ["a"]}, outputs={"Out": ["b"]})
    blk.append_op("scale", inputs={"X": ["b"]}, outputs={"Out": ["c"]}, attrs={"scale": 2.0})
    blk.append_op("scale", inputs={"X": ["b"]}, outputs={"Out": ["e"]}, attrs={"scale": 3.0})
    blk.append_op("tanh", inputs={"X": ["c"]}, outputs={"Out": ["d"]})
    return blk


def test_each_variable_is_dropped_after_its_last_reader():
    blk = _chain()
    assert dead_after(blk, frozenset("ad")) == [(), (), ("b", "e"), ("c",)]
    assert dead_after(blk, frozenset("ad")) is dead_after(blk, frozenset("ad"))   # kept
    a = torch.randn(4)
    env = trace_block(blk, {"a": a}, "cpu", keep=frozenset("ad"))
    assert sorted(env) == ["a", "d"] and env["a"] is a
    assert torch.equal(env["d"], torch.tanh(2.0 * torch.tanh(a)))
    env = trace_block(blk, {"a": a}, "cpu", keep=frozenset("abd"))     # a fetched intermediate
    assert sorted(env) == ["a", "b", "d"]
    assert sorted(trace_block(blk, {"a": a}, "cpu")) == list("abcde")    # no keep: no freeing


def test_freeing_leaves_the_results_bit_equal(bert):
    main, loss, feed, init = bert
    out = {}
    for free in (True, False):
        exe = pt.Executor(pt.CPUPlace())
        exe._free_dead = free
        losses, scope, _ = _run(main, loss, feed, init, 2, exe=exe,
                                fetch=["mask_pos", main.global_block().ops[3].output_arg_names()[0]])
        out[free] = (losses, scope)
    for a, b in zip(out[True][0], out[False][0]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _same_state(out[True][1], out[False][1], init) == []


def test_a_capture_counts_only_the_launches_on_its_stream(monkeypatch):
    """``graphs.Graph`` with the card's calls stood in: while one thread
    captures, 6 launches of a counted wrapper come from the capturing thread
    and 6 from another thread on the capture stream (as autograd's device
    thread launches a backward), and a third thread runs the wrapper eagerly
    on its own stream (12 launches). The graph keeps its 12 as one replay's;
    the eager thread's stay counted, and each replay adds 12 again."""
    import threading
    from paddle_tpu_torch.core import cuda_build, graphs

    class _Stream:
        def __init__(self, handle):
            self.cuda_stream = handle

    tls, eager_stream = threading.local(), _Stream(1)

    class _Capture:
        capture_stream = _Stream(2)

        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            tls.stream = self.capture_stream

        def __exit__(self, *exc):
            tls.stream = None

    class _CUDAGraph:
        def replay(self):
            pass

    for name, value in [("synchronize", lambda *a: None), ("empty_cache", lambda: None),
                        ("memory_reserved", lambda *a: 0), ("CUDAGraph", _CUDAGraph),
                        ("graph_pool_handle", lambda: None), ("graph", _Capture),
                        ("current_stream",
                         lambda *a: getattr(tls, "stream", None) or eager_stream)]:
        monkeypatch.setattr(torch.cuda, name, value)

    def wrapper():
        cuda_build.launched(wrapper)

    wrapper.launches = 0                      # counted, but not registered in COUNTED
    captured, eager_done = threading.Barrier(2), threading.Event()

    def eager():
        captured.wait()
        for _ in range(12):
            wrapper()
        eager_done.set()

    def backward_thread():
        tls.stream = _Capture.capture_stream
        for _ in range(6):
            wrapper()

    def capture_fn():
        for _ in range(3):
            wrapper()
        captured.wait()                       # the eager thread launches meanwhile
        assert eager_done.wait(10)
        side = threading.Thread(target=backward_thread)
        side.start()
        side.join()
        for _ in range(3):
            wrapper()

    other = threading.Thread(target=eager)
    other.start()
    g = graphs.Graph(torch.device("cpu"), capture_fn)
    other.join()
    assert g.launches == {wrapper: 12}
    assert wrapper.launches == 12             # the eager thread's, none of the capture's
    g.replay()
    g.replay()
    assert wrapper.launches == 36
    assert not cuda_build._tallies


def test_the_collector_is_off_during_a_capture(monkeypatch):
    """A cyclic collection inside a capture can destroy an older CUDA graph
    that an executor left in a reference cycle, which invalidates the
    capture: ``graphs.Graph`` keeps the collector off while it captures
    (with the card's calls stood in), overlapping captures of two threads
    included, and turns it back on after the last, only if it was on."""
    import gc
    import threading
    from paddle_tpu_torch.core import graphs

    class _Capture:
        capture_stream = type("S", (), {"cuda_stream": 2})()

        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            pass

        def __exit__(self, *exc):
            pass

    for name, value in [("synchronize", lambda *a: None), ("empty_cache", lambda: None),
                        ("memory_reserved", lambda *a: 0), ("CUDAGraph", object),
                        ("graph_pool_handle", lambda: None), ("graph", _Capture)]:
        monkeypatch.setattr(torch.cuda, name, value)
    seen, inside, release = [], threading.Barrier(2), threading.Event()

    def other():
        with graphs.no_collection():
            inside.wait()
            assert release.wait(10)
            seen.append(gc.isenabled())

    def capture_fn():
        inside.wait()                          # the other thread's capture overlaps this one
        seen.append(gc.isenabled())
        return []

    assert gc.isenabled()
    t = threading.Thread(target=other)
    t.start()
    graphs.Graph(torch.device("cpu"), capture_fn)
    seen.append(gc.isenabled())                # this capture ended, the other has not
    release.set()
    t.join()
    assert seen == [False, False, False] and gc.isenabled()
    gc.disable()
    try:
        graphs.Graph(torch.device("cpu"), lambda: [])
        assert not gc.isenabled()
    finally:
        gc.enable()
