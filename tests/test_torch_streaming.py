"""The streaming data plane (``paddle_tpu_torch/data/streaming.py``) against
the JAX package's ``StreamingDataset`` on the same files.

Both packages parse each record with numpy on the host, so batches, stream
positions and dead letters are held equal exactly. The JAX package's fault
registry and the port's are separate modules: each test arms the one of the
package it drives. Retry backoff runs on a ``FakeClock`` (no real sleeps).
"""
import json
import os
import socket
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu.data import FileTailSource as JFileTailSource
from paddle_tpu.data import StreamingDataset as JStreamingDataset
from paddle_tpu.resilience import faults as jfaults
import paddle_tpu_torch as pt
from paddle_tpu_torch.data import (FileTailSource, GeneratorSource, PoisonFeed, SocketSource,
                                   SourceLost, StreamingDataset)
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.observability import journal
from paddle_tpu_torch.resilience import faults, recovery
from paddle_tpu_torch.utils.clock import FakeClock


@pytest.fixture(autouse=True)
def _clean_faults():
    for f in (faults, jfaults):
        f.clear()
    recovery.clear_preemption()
    yield
    for f in (faults, jfaults):
        f.clear()
    recovery.clear_preemption()


def _vars(pkg):
    main = pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, pkg.Program()):
        return pkg.data("x", [2], "float32"), pkg.data("y", [1], "int64")


def _write(path, n, start=0):
    with open(path, "w") as f:
        for i in range(start, start + n):
            f.write(f"{i} {i + 0.5};{i % 3}\n")


def _ds(pkg_ds, pkg, batch=4, **kw):
    ds = pkg_ds(**kw)
    ds.set_use_var(list(_vars(pkg)))
    ds.set_batch_size(batch)
    return ds


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def test_batches_and_stream_state_equal_jax(tmp_path):
    p = str(tmp_path / "s.txt")
    _write(p, 10)
    t = _ds(StreamingDataset, pt)
    t.add_source(FileTailSource(p))
    j = _ds(JStreamingDataset, fluid)
    j.add_source(JFileTailSource(p))
    tb, jb = list(t._iter_batches()), list(j._iter_batches())
    _equal(tb, jb)
    assert len(tb) == 3 and tb[0]["y"].dtype == np.int64
    assert t.stream_state() == j.stream_state()
    assert t.stream_state()["sources"][p] == os.path.getsize(p)


def test_a_watermark_resumes_exactly_in_either_package(tmp_path):
    """The watermark after one batch, from either package, seeks the other
    to the same next batch."""
    p = str(tmp_path / "s.txt")
    _write(p, 14)
    full = _ds(StreamingDataset, pt)
    full.add_source(FileTailSource(p))
    batches = list(full._iter_batches())
    jfull = _ds(JStreamingDataset, fluid)
    jfull.add_source(JFileTailSource(p))
    list(jfull._iter_batches())
    for mark in (full.watermark(1), jfull.watermark(1)):
        rest = _ds(StreamingDataset, pt)
        rest.add_source(FileTailSource(p))
        rest.seek(mark)
        _equal(list(rest._iter_batches()), batches[1:])
    jrest = _ds(JStreamingDataset, fluid)
    jrest.add_source(JFileTailSource(p))
    jrest.seek(full.watermark(2))
    _equal(list(jrest._iter_batches()), batches[2:])


def test_source_retry_is_bit_identical_to_a_clean_read(tmp_path):
    p = str(tmp_path / "s.txt")
    _write(p, 16)
    clean = _ds(JStreamingDataset, fluid)
    clean.add_source(JFileTailSource(p))
    faults.install("exc@read:prob=0.3:seed=5:times=0")
    flaky = _ds(StreamingDataset, pt, clock=FakeClock(), retry_seed=0)
    flaky.add_source(FileTailSource(p))
    _equal(list(flaky._iter_batches()), list(clean._iter_batches()))
    retries = journal.recent(event="source_retry")
    assert retries and retries[-1]["source"] == p and "UNAVAILABLE" in retries[-1]["error"]


def test_source_lost_and_idle_timeout_are_typed(tmp_path):
    p = str(tmp_path / "s.txt")
    _write(p, 8)
    faults.install("exc@read:times=0")
    ds = _ds(StreamingDataset, pt, clock=FakeClock(), max_retries=3, retry_seed=0)
    ds.add_source(FileTailSource(p, name="flaky"))
    with pytest.raises(SourceLost) as ei:
        list(ds._iter_batches())
    assert ei.value.source == "flaky" and ei.value.attempts == 3
    faults.clear()
    _write(p, 2)
    ds = _ds(StreamingDataset, pt, batch=2, clock=FakeClock(), idle_timeout=5.0)
    ds.add_source(FileTailSource(p, follow=True, poll_interval=0.5))
    with pytest.raises(SourceLost, match="idle_timeout"):
        list(ds._iter_batches())


def test_quarantine_and_the_poison_ceiling_equal_jax(tmp_path):
    p = str(tmp_path / "s.txt")
    with open(p, "w") as f:
        f.write("0 0.5;0\nGARBAGE;;;\n1 1.5;1\nnot a; number\n2 2.5;2\n")
    out = {}
    for name, dsc, src, pkg in (("port", StreamingDataset, FileTailSource, pt),
                                ("jax", JStreamingDataset, JFileTailSource, fluid)):
        dl = str(tmp_path / f"dead_{name}.jsonl")
        ds = _ds(dsc, pkg, batch=3)
        ds.add_source(src(p, name="clicks"))
        ds.set_bad_sample_policy("quarantine", dead_letter_path=dl)
        out[name] = (list(ds._iter_batches()), [json.loads(ln) for ln in open(dl)],
                     ds.stream_state())
    (tb, tdead, tst), (jb, jdead, jst) = out["port"], out["jax"]
    _equal(tb, jb)
    assert tst == jst and tst["dead_letters"] == 2
    assert [(r["where"], r["reason"], r["line"]) for r in tdead] == \
        [(r["where"], r["reason"], r["line"]) for r in jdead]
    with open(p, "w") as f:
        for i in range(30):
            f.write(f"{i} {i};0\n" if i % 2 else "JUNK;;;\n")
    ds = _ds(StreamingDataset, pt)
    ds.add_source(FileTailSource(p))
    ds.set_bad_sample_policy("quarantine", dead_letter_path=str(tmp_path / "d.jsonl"),
                             max_poison_rate=0.3, poison_floor=10)
    with pytest.raises(PoisonFeed) as ei:
        list(ds._iter_batches())
    assert ei.value.quarantined >= 3 and ei.value.total >= 10


@pytest.mark.parametrize("spec", ["corrupt@read:step=2", "corrupt@parse:step=3",
                                  "exc@parse:step=1"])
def test_stream_faults_quarantine_as_in_jax(tmp_path, spec):
    p = str(tmp_path / "s.txt")
    _write(p, 9)
    out = {}
    for name, dsc, src, pkg, reg in (("port", StreamingDataset, FileTailSource, pt, faults),
                                     ("jax", JStreamingDataset, JFileTailSource, fluid,
                                      jfaults)):
        reg.install(spec)
        dl = str(tmp_path / f"{name}.jsonl")
        ds = _ds(dsc, pkg, batch=4)
        ds.add_source(src(p, name="s"))
        ds.set_bad_sample_policy("quarantine", dead_letter_path=dl)
        out[name] = (list(ds._iter_batches()), [json.loads(ln)["line"] for ln in open(dl)],
                     ds.stream_state())
        reg.clear()
    _equal(out["port"][0], out["jax"][0])
    assert out["port"][1:] == out["jax"][1:] and len(out["port"][1]) == 1


def test_ordered_merge_is_reproducible_and_resumes_across_sources(tmp_path):
    """Three sources in a fixed rotation: two reads give the same batches,
    the watermark carries whose turn is next, and a seek after any batch
    continues with the same ones; the rows are the JAX package's (its
    arrival order is not reproducible, so as a multiset)."""
    paths = []
    for k in range(3):
        paths.append(str(tmp_path / f"part-{k}.txt"))
        _write(paths[-1], 5 + 2 * k, start=100 * k)

    def make(**kw):
        ds = _ds(StreamingDataset, pt, batch=4, ordered=True, **kw)
        for q in paths:
            ds.add_source(FileTailSource(q, name=os.path.basename(q)))
        return ds
    a = make()
    first = list(a._iter_batches())
    _equal(list(make()._iter_batches()), first)
    assert [int(v) for v in first[0]["x"][:, 0]] == [0, 100, 200, 1]
    for n in (1, 3, 5):
        mark = a.watermark(n)
        assert mark["next_source"] in {os.path.basename(q) for q in paths}
        rest = make()
        rest.seek(json.loads(json.dumps(mark)))
        _equal(list(rest._iter_batches()), first[n:])
    j = _ds(JStreamingDataset, fluid, batch=4)
    for q in paths:
        j.add_source(JFileTailSource(q, name=os.path.basename(q)))
    rows = sorted(map(tuple, np.concatenate([b["x"] for b in j._iter_batches()])))
    assert sorted(map(tuple, np.concatenate([b["x"] for b in first]))) == rows


def test_epoch_bounds_over_an_unbounded_source_lose_nothing():
    gen = GeneratorSource(lambda: (f"{i} {i};0\n" for i in range(10 ** 9)), name="gen")
    ds = _ds(StreamingDataset, pt, batch=2)
    ds.add_source(gen)
    ds.set_epoch_bound(steps=3)
    e1, e2 = list(ds._iter_batches()), list(ds._iter_batches())
    assert len(e1) == len(e2) == 3
    np.testing.assert_array_equal(e1[-1]["x"][-1], [5, 5])
    np.testing.assert_array_equal(e2[0]["x"][0], [6, 6])


def test_a_socket_source_reconnects_after_a_drop():
    lines = [f"{i} {i + 0.5};{i % 3}\n" for i in range(8)]
    srv = socket.create_server(("127.0.0.1", 0))
    port = srv.getsockname()[1]

    def serve():
        served = 0
        for cut in (4, None):          # drop the first connection mid-stream
            conn, _ = srv.accept()
            with conn:
                for ln in lines[served:served + (cut or len(lines))]:
                    conn.sendall(ln.encode())
                    served += 1
        srv.close()
    t = threading.Thread(target=serve, daemon=True)
    t.start()
    ds = _ds(StreamingDataset, pt, batch=4, retry_backoff=0.01, max_retries=8)
    ds.add_source(SocketSource("127.0.0.1", port, name="sock"))
    ds.set_epoch_bound(steps=2)
    batches = list(ds._iter_batches())
    t.join(timeout=5)
    assert not t.is_alive() and len(batches) == 2
    np.testing.assert_array_equal(batches[1]["x"][-1], [7, 7.5])
    assert journal.recent(event="source_retry")


def test_the_factory_the_filelist_and_the_data_shim(tmp_path):
    """``create_dataset("StreamingDataset")`` streams a ``set_filelist`` as
    finite tail sources; ``pt.data`` stays the input layer after the
    package is imported."""
    p = str(tmp_path / "s.txt")
    _write(p, 6)
    ds = pt.DatasetFactory().create_dataset("StreamingDataset")
    assert isinstance(ds, StreamingDataset)
    ds.set_use_var(list(_vars(pt)))
    ds.set_batch_size(3)
    ds.set_filelist([p])
    assert len(list(ds._iter_batches())) == 2
    assert isinstance(ds.sources[0], FileTailSource)
    main = pt.Program()
    with pt.program_guard(main, pt.Program()):
        v = pt.data("z", [3], "float32")
    assert v.name == "z" and callable(pt.data)


def test_a_stream_trains_as_the_same_file_through_queue_dataset(tmp_path):
    """A tiny DeepFM through ``train_from_dataset`` from a stream equals the
    same file through ``QueueDataset``, bit for bit: every state tensor."""
    rng = np.random.RandomState(0)
    p = str(tmp_path / "part.txt")
    with open(p, "w") as f:
        for _ in range(64):
            f.write(" ".join(map(str, rng.randint(0, 30, 4))) + ";"
                    + " ".join(f"{x:.4f}" for x in rng.rand(3)) + ";"
                    + str(rng.randint(0, 2)) + "\n")
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 1
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        ids, dense = pt.data("ids", [4], "int64"), pt.data("dense", [3], "float32")
        label = pt.data("label", [1], "int64")
        loss, auc, _ = tdeepfm.deepfm(ids, dense, label, num_fields=4, vocab_size=30,
                                      embed_dim=4, hidden=(8,))
        pt.optimizer.Adam(0.01).minimize(loss)
    init_scope = pt.Scope()
    with pt.scope_guard(init_scope):
        pt.Executor(pt.CPUPlace()).run(startup)
    names = [n for n, v in main.global_block().vars.items() if v.persistable]
    states = {}
    for kind in ("StreamingDataset", "QueueDataset"):
        ds = pt.DatasetFactory().create_dataset(kind)
        ds.set_use_var([ids, dense, label])
        ds.set_batch_size(8)
        ds.set_filelist([p])
        scope = pt.Scope()
        for n in names:
            scope.set_var(n, init_scope.find_var(n).clone())
        main._rng_run_counter = 0
        with pt.scope_guard(scope):
            pt.Executor(pt.CPUPlace()).train_from_dataset(main, ds, fetch_list=[loss, auc])
        states[kind] = {n: scope.find_var(n) for n in names}
        assert main._rng_run_counter == 8
    assert all(torch.equal(states["StreamingDataset"][n], states["QueueDataset"][n])
               for n in names)
