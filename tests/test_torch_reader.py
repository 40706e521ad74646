"""The port's reader pipeline and persistables on the CPU: ``DataLoader``
(each ``set_*_generator``), ``PyReader``, the reader layers, ``DataFeeder``
and the reader decorators against the JAX package's, training fed by a
``DataLoader``, and ``save_persistables`` / ``load_persistables`` across
the two packages.

Tolerances: feed dicts, decorator items and loaded values equal (the same
numpy data through the same host code; the JAX loader's device-staged
values read back with ``np.asarray``); the port's steps fed by the loader
against the same steps fed by hand, bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert

CPU = pt.CPUPlace()


def _vars(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        return [pkg.data("x", [4], "float32"), pkg.data("y", [1], "int64")]


def _samples(n=10, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(4).astype("float32"), np.array([i], "int64")) for i in range(n)]


def _batches():
    return [(np.full((2, 4), i, "float32"), np.full((2, 1), i, "int64")) for i in range(7)]


def _as_np(feeds):
    return [{k: np.asarray(v) for k, v in f.items()} for f in feeds]


def _assert_feeds_equal(got, want):
    got, want = _as_np(got), _as_np(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for n in w:
            np.testing.assert_array_equal(g[n], w[n], err_msg=n)
            # the JAX loader stages int64 as int32 (x64 off): values and kinds compared
            assert g[n].dtype.kind == w[n].dtype.kind, n


GENERATORS = {
    "batch": lambda ld, place: ld.set_batch_generator(lambda: iter(_batches()), place),
    "sample_list": lambda ld, place: ld.set_sample_list_generator(
        lambda: (_samples()[i:i + 3] for i in range(0, 10, 3)), place),
    "sample": lambda ld, place: ld.set_sample_generator(
        lambda: iter(_samples()), 4, drop_last=True, places=place),
    "sample_keep_last": lambda ld, place: ld.set_sample_generator(
        lambda: iter(_samples()), 4, drop_last=False, places=place),
}


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_dataloader_yields_the_jax_feed_dicts(kind):
    got = list(GENERATORS[kind](pt.DataLoader.from_generator(_vars(pt), capacity=2), CPU))
    want = list(GENERATORS[kind](fluid.DataLoader.from_generator(_vars(fluid), capacity=2),
                                 None))
    assert got and all(isinstance(v, np.ndarray) for f in got for v in f.values())
    assert all(f["y"].dtype == np.int64 for f in got)
    _assert_feeds_equal(got, want)


def test_pyreader_decorators_equal_jax():
    def feeds(pkg, place):
        r = pkg.PyReader(_vars(pkg), capacity=3)
        r.decorate_sample_list_generator(
            lambda: (_samples()[i:i + 5] for i in range(0, 10, 5)), place)
        a = list(r)
        r.decorate_batch_generator(lambda: iter(_batches()), place)
        return a + list(r)
    _assert_feeds_equal(feeds(pt, CPU), feeds(fluid, None))


def test_py_reader_and_read_file_equal_jax():
    """``layers.py_reader`` declares the feed variables (the same unique
    names), ``read_file`` returns them, ``double_buffer`` is the identity,
    and ``create_py_reader_by_data`` feeds existing variables."""
    def feeds(pkg, place):
        main = pkg.Program()
        with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
            reader = pkg.layers.py_reader(capacity=4, shapes=[(-1, 4), (-1, 1)],
                                          dtypes=["float32", "int64"])
            assert pkg.layers.double_buffer(reader) is reader
            names = [v.name for v in pkg.layers.read_file(reader)]
            reader.decorate_batch_generator(lambda: iter(_batches()), place)
            by_data = pkg.layers.create_py_reader_by_data(2, _vars(pkg))
            by_data.decorate_sample_list_generator(
                lambda: (_samples()[i:i + 4] for i in range(0, 8, 4)), place)
            return names, list(reader) + list(by_data)
    t_names, t_feeds = feeds(pt, CPU)
    j_names, j_feeds = feeds(fluid, None)
    assert t_names == j_names and len(t_names) == 2
    _assert_feeds_equal(t_feeds, j_feeds)
    with pytest.raises(ValueError, match="DataLoader"):
        pt.layers.read_file(object())


def test_data_feeder_equals_jax():
    """Float columns cast to the variable's dtype, others kept."""
    samples = [(np.arange(4) * 0.5 + i, [i]) for i in range(5)]     # float64 in
    got = pt.DataFeeder(_vars(pt), CPU).feed(samples)
    want = fluid.DataFeeder(_vars(fluid), None).feed(samples)
    _assert_feeds_equal([got], [want])
    assert got["x"].dtype == np.float32 and got["y"].dtype.kind == "i"


def test_a_producers_error_surfaces():
    def bad():
        yield (np.zeros((2, 4), "float32"), np.zeros((2, 1), "int64"))
        raise RuntimeError("boom in generator")
    loader = pt.DataLoader.from_generator(_vars(pt)).set_batch_generator(bad, CPU)
    it = iter(loader)
    assert next(it)["x"].shape == (2, 4)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def test_the_loader_stages_for_the_card_by_default():
    """Placed on the card (no ``places``), the producer would pin host
    memory for the copy: with no card that raises, as the Executor does;
    without double buffering nothing is staged."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default place exists")
    loader = pt.DataLoader.from_generator(_vars(pt)).set_batch_generator(
        lambda: iter(_batches()))
    with pytest.raises(RuntimeError, match="CUDA"):
        list(loader)
    plain = pt.DataLoader.from_generator(_vars(pt), use_double_buffer=False)
    assert len(list(plain.set_batch_generator(lambda: iter(_batches())))) == 7


def test_each_process_feeds_its_rows(monkeypatch):
    """Process 1 of 2 (``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``) takes
    the second half of each global batch; ``shard_by_host=False`` keeps it."""
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    rng = np.random.RandomState(0)
    batches = [(rng.rand(4, 4).astype("float32"), np.arange(4)[:, None]) for _ in range(3)]
    got = list(pt.DataLoader.from_generator(_vars(pt)).set_batch_generator(
        lambda: iter(batches), CPU))
    for g, (x, y) in zip(got, batches):
        np.testing.assert_array_equal(g["x"], x[2:])
        np.testing.assert_array_equal(g["y"], y[2:])
    whole = list(pt.DataLoader.from_generator(_vars(pt), shard_by_host=False)
                 .set_batch_generator(lambda: iter(batches), CPU))
    assert whole[0]["x"].shape == (4, 4)


# -- reader decorators ---------------------------------------------------------------------------

def _r():
    return iter(range(10))


def _pairs():
    return iter([(i, -i) for i in range(10)])


DECORATORS = {
    "batch": lambda m: m.batch(_r, 3),
    "batch_drop_last": lambda m: m.batch(_r, 3, drop_last=True),
    "shuffle": lambda m: m.shuffle(_r, 4, seed=3),
    "cache": lambda m: m.cache(_r),
    "firstn": lambda m: m.firstn(_r, 4),
    "map_readers": lambda m: m.map_readers(lambda a, b: a * 10 + b, _r, _r),
    "chain": lambda m: m.chain(_r, m.firstn(_r, 2)),
    "compose": lambda m: m.compose(_pairs, _r),
    "buffered": lambda m: m.buffered(_r, 2),
    "xmap_readers": lambda m: m.xmap_readers(lambda v: v * v, _r, 3, 4, order=True),
    "shard": lambda m: m.shard(_r, 4, 1),
}


@pytest.mark.parametrize("name", sorted(DECORATORS))
def test_reader_decorators_equal_jax(name):
    t = DECORATORS[name](pt.reader)
    j = DECORATORS[name](fluid.reader)
    assert list(t()) == list(j())
    assert list(t()) == list(j())     # read again: shuffle's generator has moved on


# -- training fed by the loader ------------------------------------------------------------------

def test_steps_fed_by_the_dataloader_equal_steps_fed_by_hand():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = 9
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [16], "float32")
        label = pt.data("label", [1], "int64")
        loss = pt.layers.mean(pt.layers.softmax_with_cross_entropy(
            pt.layers.fc(pt.layers.fc(x, 8, act="relu"), 4), label))
        pt.optimizer.Adam(0.01).minimize(loss)
    rng = np.random.RandomState(0)
    batches = [(rng.randn(32, 16).astype("float32"),
                rng.randint(0, 4, (32, 1)).astype("int64")) for _ in range(4)]
    exe = pt.Executor(CPU)
    init_scope = pt.Scope()
    with pt.scope_guard(init_scope):
        exe.run(startup)
    init = {n: init_scope.find_var(n).clone() for n in init_scope.var_names()}
    runs = []
    for by_loader in (True, False):
        scope = pt.Scope()
        for n, t in init.items():
            scope.set_var(n, t.clone())
        main._rng_run_counter = 0
        feeds = (pt.DataLoader.from_generator([x, label], capacity=2)
                 .set_batch_generator(lambda: iter(batches), CPU) if by_loader
                 else [{"x": a, "label": b} for a, b in batches])
        with pt.scope_guard(scope):
            losses = [exe.run(main, feed=f, fetch_list=[loss], return_numpy=False)[0]
                      for f in feeds]
        runs.append((losses, scope))
    (a, sa), (b, sb) = runs
    assert len(a) == 4 and all(torch.equal(p, q) for p, q in zip(a, b))
    assert [n for n in init if not torch.equal(sa.find_var(n), sb.find_var(n))] == []


# -- persistables across the packages ------------------------------------------------------------

def _mlp(pkg):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [8], "float32")
        label = pkg.data("label", [1], "int64")
        loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            pkg.layers.fc(pkg.layers.fc(x, 16, act="relu"), 4), label))
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(8, 8).astype("float32"),
            "label": rng.randint(0, 4, (8, 1)).astype("int64")}


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items()
                  if v.persistable and not v.is_data)


@pytest.fixture(scope="module")
def trained():
    """The JAX MLP after 2 Adam steps (moments and beta powers moved)."""
    jm, js, jl = _mlp(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor()
    with fluid.scope_guard(scope):
        exe.run(js)
        for _ in range(2):
            exe.run(jm, feed=_feed(), fetch_list=[jl])
        state = {n: np.asarray(scope.find_var(n)) for n in _persistables(jm)}
    return jm, state


def test_persistables_saved_by_the_port_load_in_jax(trained, tmp_path):
    jm, state = trained
    tm, _, _ = _mlp(pt)
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(state, device="cpu"))
    with pt.scope_guard(scope):
        nbytes = pt.io.save_persistables(pt.Executor(CPU), str(tmp_path), tm)
    assert nbytes > 0
    with fluid.scope_guard(fluid.Scope()):
        fluid.io.load_persistables(fluid.Executor(), str(tmp_path), jm)
        for n, a in state.items():
            np.testing.assert_array_equal(np.asarray(fluid.global_scope().find_var(n)), a,
                                          err_msg=n)


def test_persistables_saved_by_jax_load_in_the_port(trained, tmp_path):
    jm, state = trained
    with fluid.scope_guard(fluid.Scope()):
        for n, a in state.items():
            fluid.global_scope().set_var(n, a)
        fluid.io.save_persistables(fluid.Executor(), str(tmp_path), jm)
    tm, _, tl = _mlp(pt)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.io.load_persistables(pt.Executor(CPU), str(tmp_path), tm)
    assert sorted(scope.var_names()) == sorted(state)
    for n, a in state.items():
        np.testing.assert_array_equal(scope.find_var(n).numpy(), a, err_msg=n)
    with pt.scope_guard(scope):       # and a step runs from it
        loss, = pt.Executor(CPU).run(tm, feed=_feed(), fetch_list=[tl])
    assert np.isfinite(loss).all()


def test_a_step_after_load_equals_the_live_one(trained, tmp_path):
    _, state = trained
    tm, _, tl = _mlp(pt)
    live = pt.Scope()
    convert.load_state(live, convert.state_from_numpy(state, device="cpu"))
    exe = pt.Executor(CPU)
    with pt.scope_guard(live):
        pt.io.save_persistables(exe, str(tmp_path), tm)
        tm._rng_run_counter = 2
        want, = exe.run(tm, feed=_feed(), fetch_list=[tl], return_numpy=False)
    loaded = pt.Scope()
    with pt.scope_guard(loaded):
        pt.io.load_persistables(exe, str(tmp_path), tm)
        tm._rng_run_counter = 2
        got, = exe.run(tm, feed=_feed(), fetch_list=[tl], return_numpy=False)
    assert torch.equal(got, want)
    assert [n for n in state if not torch.equal(live.find_var(n), loaded.find_var(n))] == []


def test_save_params_and_vars(trained, tmp_path):
    """``save_params`` keeps no optimizer state; ``save_vars`` /
    ``load_vars`` by name with a manifest ``filename``; a shape that
    differs from the program's, a missing variable and a multi-process
    save raise."""
    _, state = trained
    tm, _, _ = _mlp(pt)
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(state, device="cpu"))
    exe = pt.Executor(CPU)
    with pt.scope_guard(scope):
        pt.io.save_params(exe, str(tmp_path / "p"), tm)
        pt.io.save_vars(exe, str(tmp_path / "v"), tm, vars=["fc_0.w_0"], filename="m.json")
    with open(tmp_path / "p" / "__manifest__.json") as f:
        names = {m["name"] for m in json.load(f)["vars"]}
    assert names == {p.name for p in tm.all_parameters()}
    fresh = pt.Scope()
    with pt.scope_guard(fresh):
        pt.io.load_vars(exe, str(tmp_path / "v"), tm, vars=["fc_0.w_0"], filename="m.json")
        np.testing.assert_array_equal(fresh.find_var("fc_0.w_0").numpy(), state["fc_0.w_0"])
        with pytest.raises(RuntimeError, match="no variable"):
            pt.io.load_persistables(exe, str(tmp_path / "p"), tm)
    wide = pt.Program()
    with pt.unique_name.guard(), pt.program_guard(wide, pt.Program()):
        pt.layers.fc(pt.data("x", [8], "float32"), 32)
    with pt.scope_guard(pt.Scope()), pytest.raises(RuntimeError, match="shape mismatch"):
        pt.io.load_params(exe, str(tmp_path / "p"), wide)
    path = tmp_path / "p" / "__manifest__.json"
    head = json.loads(path.read_text())
    path.write_text(json.dumps(dict(head, nranks=2)))
    with pt.scope_guard(pt.Scope()), pytest.raises(NotImplementedError, match="2 processes"):
        pt.io.load_params(exe, str(tmp_path / "p"), tm)


def test_layers_load_takes_a_whole_variable(tmp_path):
    a = np.arange(6, dtype="float32").reshape(2, 3)
    np.save(tmp_path / "w.npy", a)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.layers.load("w", str(tmp_path / "w.npy"))
    np.testing.assert_array_equal(scope.find_var("w").numpy(), a)
    with pytest.raises(ValueError, match="shard chunk"):
        pt.layers.load("w", str(tmp_path / "w.r0c1.npy"))
    assert os.path.exists(tmp_path / "w.npy")
