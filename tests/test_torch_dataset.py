"""The port's dataset pipeline on the CPU: the native slot parser,
``QueueDataset`` / ``InMemoryDataset`` and their policies, the MultiSlot
data generator, the executor's prefetch loop, and ``train_from_dataset`` /
``infer_from_dataset`` on a tiny DeepFM, held against the JAX package on the
same files.

Tolerances. Batches, shuffles, dead letters, the generator's output and the
native parses: equal (the same text parsed by the same rules; the port keeps
ids as int64, the JAX package's numpy batches are int64 too). Training the
tiny DeepFM against the JAX package, as tests/test_torch_ctr.py's Adam
steps: the last loss ``rtol 1e-5``, the AUC ``atol 1e-6``, every state
tensor ``atol 5e-5`` (the histograms equal). The port's own paths (the
prefetch loop, ``fuse_steps``, the stand-in graph, a resume after
save/load) against a loop of its ``Executor.run`` over the same batches:
bit for bit. ``infer_from_dataset``'s probabilities against the JAX
package's ``rtol 1e-5``. No test times anything.
"""
import itertools
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import native as jnative
from paddle_tpu.dataset_factory import PoisonFeed as JPoisonFeed
from paddle_tpu.incubate import data_generator as jdg
from paddle_tpu.models import deepfm as jdeepfm
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, native
from paddle_tpu_torch.core import executor as ex
from paddle_tpu_torch.dataset_factory import PoisonFeed
from paddle_tpu_torch.incubate import data_generator as tdg
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.observability import journal
from paddle_tpu_torch.observability.metrics import REGISTRY
from tests.test_torch_graph_step import stand_in  # noqa: F401  (the fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS, VOCAB, EMBED, DENSE, BATCH = 4, 1000, 4, 13, 32
PART_ROWS = (37, 50, 41)          # 128 rows: 4 batches of 32, remainders carried


def _write_parts(d, rows=PART_ROWS, seed=0, big_id_in=None):
    """MultiSlot part files as bench_workloads.py writes them: ids;dense;label."""
    rng = np.random.RandomState(seed)
    paths = []
    for p, n in enumerate(rows):
        path = os.path.join(d, f"part-{p}.txt")
        with open(path, "w") as f:
            for r in range(n):
                ids = rng.randint(0, VOCAB, FIELDS)
                if p == big_id_in and r == 3:
                    ids[1] = 2 ** 24 + 1          # exact in int64, not in float32
                f.write(" ".join(map(str, ids)) + ";"
                        + " ".join(f"{x:.4f}" for x in rng.rand(DENSE)) + ";"
                        + str(rng.randint(0, 2)) + "\n")
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    return _write_parts(str(tmp_path_factory.mktemp("torch_parts")))


def _vars(pkg):
    main = pkg.Program()
    with pkg.program_guard(main, pkg.Program()):
        return [pkg.data("ids", [FIELDS], "int64"), pkg.data("dense", [DENSE], "float32"),
                pkg.data("label", [1], "int64")]


def _dataset(pkg, cls, use_vars, paths, bs=BATCH, drop_last=False, thread=2):
    ds = pkg.DatasetFactory().create_dataset(cls)
    ds.set_batch_size(bs)
    ds.set_thread(thread)
    ds.set_use_var(use_vars)
    ds.set_filelist(paths)
    ds.drop_last = drop_last
    if cls == "InMemoryDataset":
        ds.load_into_memory()
    return ds


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for n in w:
            np.testing.assert_array_equal(np.asarray(g[n]), np.asarray(w[n]), err_msg=n)
            assert np.asarray(g[n]).dtype == np.asarray(w[n]).dtype, n


def _python_parse_only(monkeypatch):
    monkeypatch.setattr(native, "parse_slot_file", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "available", lambda: False)


# -- batches against the JAX package -----------------------------------------------------------

@pytest.mark.parametrize("parse", ["native", "python"])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("bs", [32, 24])
@pytest.mark.parametrize("cls", ["QueueDataset", "InMemoryDataset"])
def test_batches_equal_jax(parts, cls, bs, drop_last, parse, monkeypatch):
    """Three part files of 37, 50 and 41 rows: B 32 (no remainder) and B 24
    (an 8-row tail, dropped or kept), the rows a file leaves over carried
    into the next, natively parsed or by the Python parser."""
    if parse == "python":
        _python_parse_only(monkeypatch)
    before = native.parses
    got = list(_dataset(pt, cls, _vars(pt), parts, bs, drop_last)._iter_batches())
    want = list(_dataset(fluid, cls, _vars(fluid), parts, bs, drop_last)._iter_batches())
    _assert_same_batches(got, want)
    assert [len(b["label"]) for b in got] == [bs] * (128 // bs) + (
        [] if drop_last or 128 % bs == 0 else [128 % bs])
    if parse == "native" and native.available():
        assert native.parses - before == len(parts)
    elif parse == "python":
        assert native.parses == before


@pytest.mark.parametrize("cls", ["QueueDataset", "InMemoryDataset"])
def test_a_file_float32_cannot_hold_demotes_to_rows(tmp_path, cls):
    """An id of 2^24 + 1 in the middle file: that file takes the exact
    Python parse and the columns read before it become rows, as in the JAX
    package; the id comes through exactly."""
    paths = _write_parts(str(tmp_path), big_id_in=1)
    got = list(_dataset(pt, cls, _vars(pt), paths, 24)._iter_batches())
    want = list(_dataset(fluid, cls, _vars(fluid), paths, 24)._iter_batches())
    _assert_same_batches(got, want)
    ids = np.concatenate([b["ids"] for b in got])
    assert (ids == 2 ** 24 + 1).sum() == 1


@pytest.mark.parametrize("world", [1, 2])
def test_shuffles_and_stripes_equal_jax(parts, world, monkeypatch):
    """``local_shuffle`` and two ``global_shuffle`` epochs (the stripe of
    process 1 of 2 from ``PADDLE_TRAINERS_NUM`` / ``PADDLE_TRAINER_ID``),
    and a ``QueueDataset`` streaming that stripe by global row."""
    if world == 2:
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
        monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    t = _dataset(pt, "InMemoryDataset", _vars(pt), parts, 16)
    j = _dataset(fluid, "InMemoryDataset", _vars(fluid), parts, 16)
    for shuffle in ("local_shuffle", "global_shuffle", "global_shuffle"):
        getattr(t, shuffle)()
        getattr(j, shuffle)()
        np.testing.assert_array_equal(t._perm, j._perm)
        want = (1, 2) if world == 2 and shuffle == "global_shuffle" else None
        assert t._stripe == j._stripe == want
        _assert_same_batches(list(t._iter_batches()), list(j._iter_batches()))
    t_q = _dataset(pt, "QueueDataset", _vars(pt), parts, 16)
    j_q = _dataset(fluid, "QueueDataset", _vars(fluid), parts, 16)
    t_q._stripe = j_q._stripe = (1, 2)
    _assert_same_batches(list(t_q._iter_batches()), list(j_q._iter_batches()))
    with pytest.raises(ValueError, match="InMemoryDataset"):
        t_q.local_shuffle()


@pytest.mark.parametrize("cls", ["QueueDataset", "InMemoryDataset"])
def test_missing_file_policy(parts, tmp_path, cls):
    """``raise`` (default): FileNotFoundError. ``skip``: the batches of the
    other files, equal to the JAX package's, the remainder flushed though
    the last file is the missing one; journaled and counted."""
    gone = str(tmp_path / "gone.txt")
    files = [parts[0], gone, parts[1], gone]
    with pytest.raises(FileNotFoundError):
        list(_dataset(pt, cls, _vars(pt), [gone], 24)._iter_batches())
    counter = REGISTRY.counter("sources_skipped_total")
    before = counter.value

    def skipping(pkg):
        ds = pkg.DatasetFactory().create_dataset(cls)
        ds.set_batch_size(24)
        ds.set_use_var(_vars(pkg))
        ds.set_filelist(files)
        ds.set_missing_file_policy("skip")
        if cls == "InMemoryDataset":
            ds.load_into_memory()
        return list(ds._iter_batches())
    got = skipping(pt)
    _assert_same_batches(got, skipping(fluid))
    assert sum(len(b["label"]) for b in got) == PART_ROWS[0] + PART_ROWS[1]
    assert counter.value - before == 2
    assert journal.recent(event="source_skipped")[-1]["file"] == gone
    with pytest.raises(ValueError):
        pt.DatasetFactory().create_dataset(cls).set_missing_file_policy("bogus")


def _poisoned(d):
    """40 lines, 4 of them bad: two with a missing slot, two that do not parse."""
    path = os.path.join(d, "poisoned.txt")
    rng = np.random.RandomState(3)
    with open(path, "w") as f:
        for r in range(40):
            ids = " ".join(map(str, rng.randint(0, VOCAB, FIELDS)))
            dense = " ".join(f"{x:.4f}" for x in rng.rand(DENSE))
            if r in (5, 17):
                f.write(f"{ids};{dense}\n")
            elif r in (9, 30):
                f.write(f"{ids};{dense};not_a_label\n")
            else:
                f.write(f"{ids};{dense};{r % 2}\n")
    return path


@pytest.mark.parametrize("cls", ["QueueDataset", "InMemoryDataset"])
def test_quarantine_dead_letters_equal_jax(tmp_path, cls):
    """Quarantined lines: the batches of the good ones, the dead-letter
    records (equal, one per position, not repeated by a second epoch), the
    counter by reason and the journal; raised past the ceiling
    (``PoisonFeed``, with the JAX package's counts)."""
    path = _poisoned(str(tmp_path))
    counts = {r: REGISTRY.counter("samples_quarantined_total", reason=r).value
              for r in ("slot_count", "parse_error")}

    def run(pkg, tag, **policy):
        ds = pkg.DatasetFactory().create_dataset(cls)
        ds.set_batch_size(8)
        ds.set_use_var(_vars(pkg))
        ds.set_filelist([path])
        dl = str(tmp_path / f"{tag}.jsonl")
        ds.set_bad_sample_policy("quarantine", dead_letter_path=dl, **policy)
        if cls == "InMemoryDataset":
            ds.load_into_memory()
        batches = list(ds._iter_batches())
        if cls == "QueueDataset":
            list(ds._iter_batches())      # a second epoch parses the file again
        with open(dl) as f:
            return batches, [json.loads(ln) for ln in f]
    got, t_dead = run(pt, "port")
    want, j_dead = run(fluid, "jax")
    _assert_same_batches(got, want)
    assert t_dead == j_dead and len(t_dead) == 4
    assert {d["where"] for d in t_dead} == {f"{path}:{r + 1}" for r in (5, 17, 9, 30)}
    assert [REGISTRY.counter("samples_quarantined_total", reason=r).value - counts[r]
            for r in ("slot_count", "parse_error")] == [2, 2]
    assert journal.recent(event="sample_quarantined")[-1]["dead_letter"].endswith("port.jsonl")
    with pytest.raises(PoisonFeed) as t_err:
        run(pt, "port_ceiling", max_poison_rate=0.05, poison_floor=10)
    with pytest.raises(JPoisonFeed) as j_err:
        run(fluid, "jax_ceiling", max_poison_rate=0.05, poison_floor=10)
    # lines 6 and 10 are bad: at line 10, 2 of 10 parsed pass 5% with the floor reached
    assert (t_err.value.quarantined, t_err.value.total) == \
        (j_err.value.quarantined, j_err.value.total) == (2, 10)


def test_a_malformed_line_raises_with_its_position(tmp_path):
    path = _poisoned(str(tmp_path))
    ds = _dataset(pt, "QueueDataset", _vars(pt), [path], 8)
    with pytest.raises(ValueError, match=r"poisoned\.txt:6 has 2 slots"):
        list(ds._iter_batches())


def test_the_factory_names_what_is_not_ported():
    """Every class the JAX factory makes is ported (``StreamingDataset``
    since the streaming slice); a name the JAX factory does not know
    raises, naming it."""
    from paddle_tpu_torch.data import StreamingDataset
    assert isinstance(pt.DatasetFactory().create_dataset("StreamingDataset"), StreamingDataset)
    with pytest.raises(ValueError, match="unknown dataset class"):
        pt.DatasetFactory().create_dataset("Nope")


# -- the data generator -------------------------------------------------------------------------

def _generator(mod, batch_hook):
    class Gen(mod.MultiSlotDataGenerator):
        def generate_sample(self, line):
            def it():
                v = [int(t) for t in line.split()]
                yield [("ids", v[:FIELDS]), ("dense", [x / 8 for x in v[FIELDS:]]),
                       ("label", [v[0] % 2])]
            return it

        if batch_hook:
            def generate_batch(self, samples):
                yield from reversed(samples)
    g = Gen()
    g.set_batch(3)
    return g


@pytest.mark.parametrize("batch_hook", [False, True])
def test_data_generator_output_is_byte_equal_to_jax(tmp_path, batch_hook):
    """Lines through ``run_from_memory`` and ``run_from_files``: the same
    bytes; and the port's datasets read what it wrote."""
    rng = np.random.RandomState(1)
    lines = [" ".join(map(str, rng.randint(0, 100, FIELDS + DENSE))) for _ in range(10)]
    src = tmp_path / "raw.txt"
    src.write_text("\n".join(lines) + "\n")
    t = _generator(tdg, batch_hook)
    j = _generator(jdg, batch_hook)
    assert t.run_from_memory(lines) == j.run_from_memory(lines)
    t.run_from_files([str(src)], str(tmp_path / "t.txt"))
    j.run_from_files([str(src)], str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    batches = list(_dataset(pt, "QueueDataset", _vars(pt), [str(tmp_path / "t.txt")],
                            4)._iter_batches())
    assert sum(len(b["label"]) for b in batches) == 10
    with pytest.raises(NotImplementedError):
        tdg.DataGenerator().run_from_memory(["x"])


# -- the native parser ----------------------------------------------------------------------

@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this host: the native parser cannot be built here "
                    "(the datasets take the Python parser)")


def test_the_native_parser_builds_into_the_ignored_directory(gxx):
    assert native.available(), native.build_error
    lib = native.library_path()
    assert lib.exists()
    assert lib.parent == native.SOURCE.parent / "build"
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "paddle_tpu_torch/native/build/" in f.read().split()
    assert not os.path.exists(os.path.join(ROOT, "paddle_tpu_torch", "native",
                                           "libfast_parser.so"))


def test_the_native_parser_parses_as_the_jax_one(gxx, parts, tmp_path):
    """The same rows and columns from a rectangular file, and the same error
    texts for a ragged line, a malformed value and a missing file."""
    assert jnative.available()
    for path in parts:
        rows, cols = native.parse_slot_file(path, 3, n_threads=3)
        j_rows, j_cols = jnative.parse_slot_file(path, 3, n_threads=3)
        assert rows == j_rows
        for c, jc in zip(cols, j_cols):
            assert c.dtype == np.float32
            np.testing.assert_array_equal(c, jc)
    ragged = tmp_path / "ragged.txt"
    ragged.write_text("1 2;3\n1;3\n")
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2;3\n1 x;3\n")
    for path in (str(ragged), str(bad)):
        with pytest.raises(ValueError) as t_err:
            native.parse_slot_file(path, 2)
        with pytest.raises(ValueError) as j_err:
            jnative.parse_slot_file(path, 2)
        assert str(t_err.value) == str(j_err.value)
    for parse in (native.parse_slot_file, jnative.parse_slot_file):
        with pytest.raises(FileNotFoundError):
            parse(str(tmp_path / "missing.txt"), 2)


# -- the tiny DeepFM from files -------------------------------------------------------------

def _build(pkg, model):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        use_vars = [pkg.data("ids", [FIELDS], "int64"), pkg.data("dense", [DENSE], "float32"),
                    pkg.data("label", [1], "int64")]
        loss, auc, prob = model.deepfm(*use_vars, num_fields=FIELDS, vocab_size=VOCAB,
                                       embed_dim=EMBED, hidden=(16, 16))
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, use_vars, loss, auc, prob


def _persistables(program):
    return sorted(n for n, v in program.global_block().vars.items() if v.persistable)


@pytest.fixture(scope="module")
def tiny():
    """The JAX and the port's tiny DeepFM and the JAX startup state."""
    jm, js, *jrest = _build(fluid, jdeepfm)
    tm, ts, *trest = _build(pt, tdeepfm)
    with fluid.scope_guard(fluid.Scope()):
        fluid.Executor().run(js)
        init = {n: np.asarray(fluid.global_scope().find_var(n)) for n in _persistables(jm)}
    return (jm, *jrest), (tm, *trest), init


def _scope(init):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
    return scope


def _state(scope, names):
    return {n: scope.find_var(n).clone() for n in names}


def _assert_bit_equal(a, b):
    assert sorted(a) == sorted(b)
    assert [n for n in a if not torch.equal(a[n], b[n])] == []


def test_train_from_dataset_matches_jax(tiny, parts):
    """One epoch (4 batches) through each package's ``train_from_dataset``
    from the same init: the last loss and AUC, every state tensor."""
    (jm, juv, jl, ja, _), (tm, tuv, tl, ta, _), init = tiny
    jm._rng_run_counter = 0
    with fluid.scope_guard(fluid.Scope()):
        scope = fluid.global_scope()
        for n, a in init.items():
            scope.set_var(n, a)
        jl_v, ja_v = fluid.Executor().train_from_dataset(
            jm, _dataset(fluid, "QueueDataset", juv, parts), fetch_list=[jl, ja])
        jfinal = {n: np.asarray(scope.find_var(n)) for n in init}
    tscope = _scope(init)
    tm._rng_run_counter = 0
    with pt.scope_guard(tscope):
        tl_v, ta_v = pt.Executor(pt.CPUPlace()).train_from_dataset(
            tm, _dataset(pt, "QueueDataset", tuv, parts), fetch_list=[tl, ta])
    np.testing.assert_allclose(tl_v, jl_v, rtol=1e-5)
    np.testing.assert_allclose(ta_v, ja_v, atol=1e-6)
    for n in init:
        tol = dict(atol=0, rtol=0) if n.startswith("auc") else dict(atol=5e-5)
        np.testing.assert_allclose(tscope.find_var(n).numpy(), jfinal[n], err_msg=n, **tol)
    hist = sum(float(tscope.find_var(n).sum()) for n in init if n.startswith("auc"))
    assert hist == sum(PART_ROWS)


def _run_loop(program, init, batches, fetch, exe=None):
    """Executor.run over ``batches`` from ``init``, the counter from 0."""
    scope = _scope(init)
    program._rng_run_counter = 0
    exe = exe or pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        outs = [exe.run(program, feed=b, fetch_list=fetch, return_numpy=False)
                for b in batches]
    return outs, scope


@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("fuse", [1, 2])
def test_train_from_dataset_is_the_run_loop_bit_for_bit(tiny, parts, fuse, graphs, request):
    """``train_from_dataset`` (``fuse_steps`` 1 and 2; eager, and through the
    executor's cache on the stand-in graph of tests/test_torch_graph_step.py)
    against a loop of ``Executor.run`` over the same batches from the same
    init and run counter: the last fetches and every state tensor."""
    _, (tm, tuv, tl, ta, _), init = tiny
    names = _persistables(tm)
    ref_outs, ref_scope = _run_loop(tm, init, list(
        _dataset(pt, "QueueDataset", tuv, parts)._iter_batches()), [tl, ta])
    if graphs:
        request.getfixturevalue("stand_in")
    exe = pt.Executor(pt.CPUPlace())
    scope = _scope(init)
    tm._rng_run_counter = 0
    with pt.scope_guard(scope):
        last = exe.train_from_dataset(tm, _dataset(pt, "QueueDataset", tuv, parts),
                                      fetch_list=[tl, ta], fuse_steps=fuse,
                                      return_numpy=False)
    assert tm._rng_run_counter == 4
    assert all(torch.equal(a, b) for a, b in zip(last, ref_outs[-1]))
    _assert_bit_equal(_state(scope, names), _state(ref_scope, names))
    if graphs:
        assert len(exe._cache) == 1 and next(iter(exe._cache.values())).graph is not None


def test_skip_batches_resumes_after_save_and_load(tiny, parts, tmp_path):
    """Two batches, ``save_persistables``, ``load_persistables`` into a fresh
    scope, then ``train_from_dataset(skip_batches=2)``: the state of the
    uninterrupted epoch, bit for bit."""
    _, (tm, tuv, tl, _, _), init = tiny
    names = _persistables(tm)
    batches = list(_dataset(pt, "QueueDataset", tuv, parts)._iter_batches())
    _, whole = _run_loop(tm, init, batches, [tl])
    _, half = _run_loop(tm, init, batches[:2], [tl])
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(half):
        pt.io.save_persistables(exe, str(tmp_path / "ckpt"), tm)
    resumed = pt.Scope()
    with pt.scope_guard(resumed):
        pt.io.load_persistables(exe, str(tmp_path / "ckpt"), tm)
        exe.train_from_dataset(tm, _dataset(pt, "QueueDataset", tuv, parts),
                               fetch_list=[tl], skip_batches=2)
    assert tm._rng_run_counter == 4
    _assert_bit_equal(_state(resumed, names), _state(whole, names))


def test_a_program_that_cannot_be_captured_runs_unfused(tiny, parts, monkeypatch):
    """``fuse_steps=2`` on a program ``capture_refusal`` refuses: a warning,
    then the unfused epoch, bit for bit."""
    _, (tm, tuv, tl, ta, _), init = tiny
    names = _persistables(tm)
    ref_outs, ref_scope = _run_loop(tm, init, list(
        _dataset(pt, "QueueDataset", tuv, parts)._iter_batches()), [tl, ta])
    monkeypatch.setattr(ex, "capture_refusal", lambda program: "a host-seeded draw")
    monkeypatch.setattr(pt.Executor, "run_fused", None)   # never reached
    scope = _scope(init)
    tm._rng_run_counter = 0
    with pt.scope_guard(scope), pytest.warns(UserWarning, match="running unfused"):
        last = pt.Executor(pt.CPUPlace()).train_from_dataset(
            tm, _dataset(pt, "QueueDataset", tuv, parts), fetch_list=[tl, ta], fuse_steps=2,
            return_numpy=False)
    assert all(torch.equal(a, b) for a, b in zip(last, ref_outs[-1]))
    _assert_bit_equal(_state(scope, names), _state(ref_scope, names))


def test_fuse_steps_zero_is_not_ported(tiny, parts, monkeypatch):
    """``fuse_steps=0`` consults the autotuner (tests/test_torch_tuning.py
    holds its search); with tuning off it is the unfused epoch, bit for bit
    to the run loop."""
    _, (tm, tuv, tl, _, _), init = tiny
    names = _persistables(tm)
    _, ref_scope = _run_loop(tm, init, list(
        _dataset(pt, "QueueDataset", tuv, parts)._iter_batches()), [tl])
    monkeypatch.setenv("PADDLE_TPU_TUNE", "off")
    scope = _scope(init)
    tm._rng_run_counter = 0
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).train_from_dataset(
            tm, _dataset(pt, "QueueDataset", tuv, parts), fetch_list=[tl], fuse_steps=0)
    assert tm._rng_run_counter == 4
    _assert_bit_equal(_state(scope, names), _state(ref_scope, names))
    with pytest.raises(ValueError, match="needs a dataset"):
        pt.Executor(pt.CPUPlace()).train_from_dataset(tm)


@pytest.mark.parametrize("fuse", [1, 2])
def test_debug_prints_at_the_print_period(tiny, parts, fuse, capsys, monkeypatch):
    """``print_period=2`` over 4 batches prints batches 0 and 2 with the
    same values fused or not, and reads the fetches to the host once per
    chunk that crosses a boundary, plus once for the return."""
    _, (tm, tuv, tl, ta, _), init = tiny
    reads = []
    real = ex.materialize_fetches
    monkeypatch.setattr(ex, "materialize_fetches", lambda f: reads.append(1) or real(f))
    tm._rng_run_counter = 0
    with pt.scope_guard(_scope(init)):
        pt.Executor(pt.CPUPlace()).train_from_dataset(
            tm, _dataset(pt, "QueueDataset", tuv, parts), fetch_list=[tl, ta],
            fetch_info=["loss", "auc"], debug=True, print_period=2, fuse_steps=fuse)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["[train_from_dataset] batch 0",
                                                  "[train_from_dataset] batch 2"]
    assert all("loss=" in ln and "auc=" in ln for ln in lines)
    assert len(reads) == 3
    outs, _ = _run_loop(tm, init, list(
        _dataset(pt, "QueueDataset", tuv, parts)._iter_batches()), [tl, ta])
    loss2, auc2 = (float(t.reshape(-1)[0]) for t in outs[2])
    assert lines[1] == f"[train_from_dataset] batch 2: loss={loss2:.6g}, auc={auc2:.6g}"


def test_infer_from_dataset(tiny, parts):
    """Pruned to ``prob``: every state tensor unchanged (the update and the
    AUC histograms pruned away); the last batch's probabilities equal the
    JAX package's and ``run(use_prune=True)`` on that batch; no fetch list
    raises."""
    (jm, juv, _, _, jp), (tm, tuv, _, _, tp), init = tiny
    names = _persistables(tm)
    scope = _scope(init)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(scope):
        before = _state(scope, names)
        prob, = exe.infer_from_dataset(tm, _dataset(pt, "QueueDataset", tuv, parts),
                                       fetch_list=[tp])
        _assert_bit_equal(_state(scope, names), before)
        last = list(_dataset(pt, "QueueDataset", tuv, parts)._iter_batches())[-1]
        again, = exe.run(tm, feed=last, fetch_list=[tp], use_prune=True)
        _assert_bit_equal(_state(scope, names), before)
        with pytest.raises(ValueError, match="fetch_list"):
            exe.infer_from_dataset(tm, _dataset(pt, "QueueDataset", tuv, parts))
    np.testing.assert_array_equal(prob, again)
    assert prob.shape == (BATCH, 1)
    with fluid.scope_guard(fluid.Scope()):
        for n, a in init.items():
            fluid.global_scope().set_var(n, a)
        jprob, = fluid.Executor().infer_from_dataset(
            jm, _dataset(fluid, "QueueDataset", juv, parts), fetch_list=[jp])
    np.testing.assert_allclose(prob, jprob, rtol=1e-5)


def test_the_prune_cache_keeps_its_source_program(tiny):
    """One pruned copy per (program, version, fetches), holding its source."""
    _, (tm, _, tl, _, tp), _ = tiny
    exe = pt.Executor(pt.CPUPlace())
    a = exe._pruned(tm, ["ids", "dense"], [tp.name])
    assert exe._pruned(tm, ["ids", "dense"], [tp.name]) is a
    assert len(exe._prune_cache) == 1 and next(iter(exe._prune_cache.values()))[0] is tm
    types = {op.type for op in a.global_block().ops}
    assert "adam" not in types and "auc" not in types and "sigmoid" in types
    assert exe._pruned(tm, ["ids", "dense", "label"], [tl.name]) is not a


# -- the prefetch loop --------------------------------------------------------------------------

def _feeds(n, odd_at=None):
    rng = np.random.RandomState(7)
    return [{"x": rng.rand(3 if i == odd_at else 4, 2).astype("float32"),
             "y": np.full((3 if i == odd_at else 4, 1), i, "int64")} for i in range(n)]


def _same_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            _assert_same_batches([x], [y])
        else:
            assert x[0] == y[0] and x[2:] == y[2:]
            _assert_same_batches([x[1]], [y[1]])


@pytest.mark.parametrize("fuse", [1, 3])
def test_prefetch_keeps_order_and_groups_as_jax(fuse):
    """The items in order; with ``fuse`` 3, stacked groups, a group holding
    an odd-shaped batch and the trailing partial group as singles, as the
    JAX package's loop groups them."""
    feeds = _feeds(11, odd_at=4)
    got = list(pt.Executor._prefetch_batches(iter(feeds), 2, fuse=fuse))
    want = list(fluid.Executor._prefetch_batches(iter(feeds), 2, fuse=fuse))
    _same_items(got, want)
    if fuse == 3:
        assert [it[0] for it in got] == ["mega", "one", "one", "one", "mega", "one", "one"]
        assert got[0][1]["x"].shape == (3, 4, 2) and got[0][2] == 3
    else:
        assert [int(it["y"][0, 0]) for it in got] == list(range(11))


def test_a_generators_error_surfaces_in_the_consumer():
    def gen():
        yield {"x": np.zeros(2)}
        raise RuntimeError("parse exploded")
    it = pt.Executor._prefetch_batches(gen(), 2)
    assert next(it)["x"].shape == (2,)
    with pytest.raises(RuntimeError, match="parse exploded"):
        next(it)


class _BlockingBatches:
    """A dataset's batch iterator whose source blocks after ``n`` batches
    until ``abort`` is called (a stream with no data yet)."""

    def __init__(self, batches, n):
        self.batches, self.n, self.i = batches, n, 0
        self.released = threading.Event()
        self.aborted = self.closed = False

    def __iter__(self):
        return self

    def __next__(self):
        if self.i >= self.n:
            self.released.wait()
            raise StopIteration
        self.i += 1
        return self.batches[self.i - 1]

    def abort(self):
        self.aborted = True
        self.released.set()

    def close(self):
        self.closed = True


class _Dataset:
    thread_num = 2

    def __init__(self, it):
        self.it = it

    def _iter_batches(self):
        return self.it


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "dataset-prefetch"]


def test_an_abandoned_epoch_ends_its_worker(tiny, parts):
    """A step raises on the second batch (it lacks a feed) while the worker
    is parked inside a blocking source: the error comes through, the
    source's ``abort`` and ``close`` run, and the worker ends within 10 s."""
    _, (tm, tuv, tl, _, _), init = tiny
    batches = list(_dataset(pt, "QueueDataset", tuv, parts)._iter_batches())
    broken = dict(batches[1])
    del broken["label"]
    src = _BlockingBatches([batches[0], broken, batches[2]], 3)
    before = set(_prefetch_threads())
    with pt.scope_guard(_scope(init)), pytest.raises(KeyError, match="label"):
        pt.Executor(pt.CPUPlace()).train_from_dataset(tm, _Dataset(src), fetch_list=[tl])
    assert src.aborted
    for t in set(_prefetch_threads()) - before:
        t.join(timeout=10)
        assert not t.is_alive()
    assert src.closed


def test_a_consumer_that_stops_early_frees_a_worker_on_a_full_queue():
    """An endless source and a consumer that takes 3 items: closing the loop
    ends the worker parked on the full queue within 10 s."""
    closed = []

    def endless():
        try:
            yield from ({"i": np.array([i])} for i in itertools.count())
        finally:
            closed.append(True)
    before = set(_prefetch_threads())
    it = pt.Executor._prefetch_batches(endless(), 2)
    assert [int(next(it)["i"][0]) for _ in range(3)] == [0, 1, 2]
    it.close()
    for t in set(_prefetch_threads()) - before:
        t.join(timeout=10)
        assert not t.is_alive()
    assert closed == [True]
