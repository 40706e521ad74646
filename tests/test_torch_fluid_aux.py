"""The port's fluid helper modules against the JAX package's, on
``tests/test_aux.py``'s and ``tests/test_facades.py``'s cases: ``metrics``,
``average``, ``debugger``, ``net_drawer``, ``install_check`` and the
``transpiler`` facade. The metric classes run the same numpy on the host,
so each is held to 1e-7 on the same inputs (made from a seed); the
programs' listings and dot texts are compared as text, each program built
by its own package's DSL.
"""
import warnings

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import metrics as jmetrics
import paddle_tpu_torch as pt
from paddle_tpu_torch import metrics as tmetrics

TOL = dict(rtol=1e-7, atol=1e-7)


def _tiny(pkg, optimize=True):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [4], "float32")
        y = pkg.layers.fc(x, 2, act="relu")
        loss = pkg.layers.mean(y)
        if optimize:
            pkg.optimizer.SGD(0.1).minimize(loss)
    return main, startup


def _both(make, feed):
    """``make(module)`` for each package's metrics module, fed by
    ``feed(metric)``; returns the two evals."""
    out = []
    for mod in (jmetrics, tmetrics):
        m = make(mod)
        feed(m)
        out.append(m.eval())
    return out


def test_exported_as_in_the_jax_package():
    for name in ("nets", "metrics", "average", "debugger", "net_drawer", "install_check",
                 "transpiler", "DistributeTranspiler", "DistributeTranspilerConfig",
                 "memory_optimize", "release_memory"):
        assert hasattr(fluid, name) and hasattr(pt, name), name
    assert pt.metrics is tmetrics and pt.transpiler.__all__ == fluid.transpiler.__all__


@pytest.mark.parametrize("case", ["accuracy", "precision", "recall", "auc", "composite",
                                  "edit_distance"])
def test_metric_classes_equal_jax(case):
    rng = np.random.RandomState(7)
    preds = rng.rand(64, 2)
    labels = rng.randint(0, 2, (64, 1))
    if case == "accuracy":
        def feed(m):
            for i in range(5):
                m.update(np.array([rng2[i]]), weight=int(4 + i))
        rng2 = np.random.RandomState(3).rand(5)
        a, b = _both(lambda mod: mod.Accuracy(), feed)
    elif case in ("precision", "recall"):
        cls = {"precision": "Precision", "recall": "Recall"}[case]
        a, b = _both(lambda mod: getattr(mod, cls)(),
                     lambda m: [m.update(preds[i::4, 1], labels[i::4]) for i in range(4)])
    elif case == "auc":
        a, b = _both(lambda mod: mod.Auc(num_thresholds=255),
                     lambda m: [m.update(preds[i::2], labels[i::2]) for i in range(2)])
        assert 0.0 < a < 1.0
    elif case == "composite":
        def make(mod):
            c = mod.CompositeMetric()
            c.add_metric(mod.Precision())
            c.add_metric(mod.Recall())
            return c
        a, b = _both(make, lambda m: m.update(preds[:, 1], labels))
    else:
        d = np.random.RandomState(5).randint(0, 6, (3, 8))
        a, b = _both(lambda mod: mod.EditDistance(),
                     lambda m: [m.update(d[i], 8) for i in range(3)])
    np.testing.assert_allclose(b, a, **TOL)


def test_chunk_evaluator_equals_jax():
    """``test_aux.py::test_chunk_evaluator``'s case, then random IOB tag
    sequences through ``count``."""
    for mod in (jmetrics, tmetrics):
        ce = mod.ChunkEvaluator()
        ce.count([0, 1, -1, 2], [0, 1, -1, 0], num_chunk_types=2)
        p, r, f1 = ce.eval()
        assert p == 0.5 and r == 0.5 and abs(f1 - 0.5) < 1e-9
    rng = np.random.RandomState(11)
    seqs = [(rng.randint(-1, 6, 20), rng.randint(-1, 6, 20)) for _ in range(6)]

    def feed(m):
        for inf, lab in seqs:
            m.count(inf, lab, num_chunk_types=3)
    a, b = _both(lambda mod: mod.ChunkEvaluator(), feed)
    np.testing.assert_allclose(b, a, **TOL)
    assert tmetrics.ChunkEvaluator.extract_chunks([0, 1, 3, 2, -1], 2) == \
        jmetrics.ChunkEvaluator.extract_chunks([0, 1, 3, 2, -1], 2)


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_equals_jax(ap_version):
    """``test_aux.py::test_detection_map``'s case, then random detections
    against random ground truth over 3 classes and 4 images."""
    gt = np.array([[1, 0, 0, 10, 10], [2, 20, 20, 30, 30]], "float32")
    dets = np.array([[1, 0.9, 0, 0, 10, 10], [2, 0.8, 21, 21, 31, 31],
                     [1, 0.7, 50, 50, 60, 60], [-1, 0.0, 0, 0, 0, 0]], "float32")
    rng = np.random.RandomState(13)
    images = []
    for _ in range(4):
        g = np.concatenate([rng.randint(0, 3, (5, 1)), rng.rand(5, 2) * 20,
                            rng.rand(5, 2) * 20 + 20], axis=1).astype("float32")
        d = np.concatenate([rng.randint(-1, 3, (8, 1)), rng.rand(8, 1),
                            g[rng.randint(0, 5, 8), 1:5] + rng.randn(8, 4)],
                           axis=1).astype("float32")
        images.append((d, g))

    def feed(m):
        m.update(dets, gt)
        for d, g in images:
            m.update(d, g)
    a, b = _both(lambda mod: mod.DetectionMAP(overlap_threshold=0.5, ap_version=ap_version),
                 feed)
    np.testing.assert_allclose(b, a, **TOL)
    m = tmetrics.DetectionMAP(overlap_threshold=0.5)
    m.update(dets, gt)
    assert 0.9 < m.eval() <= 1.0


def test_weighted_average_equals_jax():
    from paddle_tpu.average import WeightedAverage as J
    from paddle_tpu_torch.average import WeightedAverage as T
    rng = np.random.RandomState(17)
    vals = [(rng.rand(3), float(w)) for w in rng.randint(1, 5, 6)] + [(2.5, 2.0)]
    out = []
    for cls in (J, T):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            wa = cls()
        assert any("deprecated" in str(w.message) for w in caught)
        for v, w in vals:
            wa.add(v, w)
        out.append(wa.eval())
        wa.reset()
        with pytest.raises(ValueError):
            wa.eval()
        with pytest.raises(ValueError):
            wa.add("x", 1.0)
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_debugger_and_net_drawer_give_the_jax_text():
    """The same listing, dot and summary for the same program built by
    each DSL (``test_aux.py::test_debugger_outputs`` and
    ``::test_net_drawer_dot_export``)."""
    jm, js = _tiny(fluid)
    tm, ts = _tiny(pt)
    assert pt.debugger.draw_graph(tm) == fluid.debugger.draw_graph(jm)
    assert pt.debugger.program_summary(tm) == fluid.debugger.program_summary(jm)
    assert "params: 2" in pt.debugger.program_summary(tm)
    assert pt.debugger.pprint_program_codes(tm) == str(tm)
    dot = pt.net_drawer.program_to_dot(tm)
    assert dot == fluid.net_drawer.program_to_dot(jm)
    assert dot.startswith("digraph") and '"v_x"' in dot and "relu" in dot
    assert pt.net_drawer.draw_graph(ts, tm) == dot
    assert pt.net_drawer.program_to_dot(tm, graph_name="g", max_label=8) == \
        fluid.net_drawer.program_to_dot(jm, graph_name="g", max_label=8)


def test_debugger_writes_the_dot_file(tmp_path):
    tm, _ = _tiny(pt, optimize=False)
    path = tmp_path / "g.dot"
    assert pt.debugger.draw_graph(tm, str(path)) == path.read_text()


def test_install_check_on_the_cpu_and_no_card(capsys):
    """``run_check(CPUPlace())`` trains the tiny fc step and says so; with no
    place it wants the card, and without one it raises, as the executor
    does (no silent fall back to the CPU)."""
    pt.install_check.run_check(pt.CPUPlace())
    out = capsys.readouterr().out
    assert "works well on CPU" in out and "installed successfully" in out
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt.install_check.run_check()


def test_transpiler_facade():
    """``test_facades.py::test_transpiler_facade`` on the port: the rewrite
    raises naming the port's state (item 13), the memory functions are
    no-ops that warn, the dispatchers dispatch."""
    t = pt.DistributeTranspiler()
    assert t.config.mode == fluid.DistributeTranspiler().config.mode == "pserver"
    for call in (lambda: t.transpile(0), t.get_trainer_program,
                 lambda: t.get_pserver_program("a:1"), lambda: t.get_startup_program("a:1")):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            call()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert pt.memory_optimize(pt.Program()) is None
        assert pt.release_memory(pt.Program()) is None
    assert sum("no-op" in str(x.message) for x in w) == 2

    class V:
        def __init__(self, n):
            self.name = n
    vs = [V("x"), V("y"), V("z")]
    assert pt.transpiler.RoundRobin(["a", "b"]).dispatch(vs) == \
        fluid.transpiler.RoundRobin(["a", "b"]).dispatch(vs) == ["a", "b", "a"]
    assert pt.transpiler.HashName(["a", "b", "c"]).dispatch(vs) == \
        fluid.transpiler.HashName(["a", "b", "c"]).dispatch(vs)
