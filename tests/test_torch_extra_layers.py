"""The layers of ROADMAP item 8 (the rest of ``layers/extras.py``,
``layers/sequence.py`` and ``layers/nn.py``, the five 3-D / trilinear
layers over op types ported before, ``layers/distributions.py``) against
the JAX package on the CPU.

Each layer is built by both DSLs: the same op types, slots, attrs and
variable names in the main and startup programs; then the port runs the
main program from the JAX startup state (carried across by name,
``convert.py``) on the same seeded feeds, and every fetch matches the JAX
executor's within ``rtol 1e-5, atol 1e-6`` (integer fetches exactly). The
layers that draw (``nce``, ``sampling_id``, the batch-like fills,
``random_crop``) are held by their programs and the shapes of their
outputs; their draws are held by statistics in
``tests/test_torch_extra_ops.py``. Two SGD steps through ``data_norm``,
``center_loss`` and ``spectral_norm`` hold the state those ops write back
(``rtol 1e-5``). ``tests/test_distributions.py``'s own tests run on the
port's distributions, with the port's executor on the CPU.
"""
import importlib.util
import os

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.tools import extra_op_cases as xc
from tests.test_torch_graph_step import stand_in  # noqa: F401  (the fixture)

CPU = pt.CPUPlace()
A = dict(append_batch_size=False)


def d(pkg, name, shape, dtype="float32"):
    return pkg.data(name, list(shape), dtype, **A)


def _assign(pkg, value):
    return pkg.layers.assign(np.asarray(value))


def _lod(pkg):
    x = d(pkg, "x", [2, 5])
    return [pkg.layers.lod_reset(x), pkg.layers.lod_append(x, [1])]


LAYERS = {
    # vision / tensor rearranges
    "maxout": lambda p: [p.layers.maxout(d(p, "x", [2, 6, 3, 3]), groups=2)],
    "lrn": lambda p: [p.layers.lrn(d(p, "x", [2, 6, 3, 3]), n=3, alpha=0.1)],
    "pixel_shuffle": lambda p: [p.layers.pixel_shuffle(d(p, "x", [2, 8, 3, 3]), 2)],
    "shuffle_channel": lambda p: [p.layers.shuffle_channel(d(p, "x", [2, 6, 3, 3]), 3)],
    "temporal_shift": lambda p: [p.layers.temporal_shift(d(p, "x", [6, 8, 2, 2]), 3)],
    "unfold": lambda p: [p.layers.unfold(d(p, "x", [2, 3, 6, 6]), [3, 3], strides=2,
                                         paddings=1)],
    "affine_channel": lambda p: [p.layers.affine_channel(
        d(p, "x", [2, 3, 4, 4]), _assign(p, np.float32([0.5, 2.0, -1.0])),
        _assign(p, np.float32([0.1, 0.0, 0.3])), act="relu")],
    "bilinear_tensor_product": lambda p: [p.layers.bilinear_tensor_product(
        d(p, "x", [4, 3]), d(p, "y", [4, 2]), 5, act="tanh")],
    "add_position_encoding": lambda p: [p.layers.add_position_encoding(
        d(p, "x", [2, 5, 6]), alpha=0.5, beta=2.0)],
    "multiplex": lambda p: [p.layers.multiplex([d(p, "x", [4, 3]), d(p, "y", [4, 3])],
                                               d(p, "i", [4, 1], "int32"))],
    "crop_tensor": lambda p: [p.layers.crop_tensor(d(p, "x", [4, 5]), [2, 3], [1, 2])],
    "crop": lambda p: [p.layers.crop(d(p, "x", [4, 5]), [3, 3], [1, 1])],
    "pad_constant_like": lambda p: [p.layers.pad_constant_like(
        d(p, "x", [4, 6]), d(p, "y", [3, 4]), pad_value=2.0)],
    "row_conv": lambda p: [p.layers.row_conv(d(p, "x", [2, 5, 3]), 2, act="relu")],
    "tree_conv": lambda p: [p.layers.tree_conv(
        d(p, "x", [2, 5, 3]), _assign(p, np.array([[[1, 2], [1, 3], [2, 4], [2, 5]],
                                                   [[1, 2], [2, 3], [0, 0], [0, 0]]])),
        4, num_filters=2, max_depth=2)],
    "image_resize_short": lambda p: [p.layers.image_resize_short(d(p, "x", [1, 2, 6, 9]), 4)],
    "deformable_conv": lambda p: [p.layers.deformable_conv(
        d(p, "x", [2, 3, 5, 5]), d(p, "o", [2, 18, 5, 5]), d(p, "m", [2, 9, 5, 5]), 4, 3,
        padding=1)],
    "deformable_conv-v1": lambda p: [p.layers.deformable_conv(
        d(p, "x", [2, 3, 5, 5]), d(p, "o", [2, 18, 3, 3]), None, 4, 3, modulated=False)],
    "similarity_focus": lambda p: [p.layers.similarity_focus(d(p, "x", [2, 3, 4, 5]), 1,
                                                             [0, 2])],
    "affine_grid": lambda p: [p.layers.affine_grid(d(p, "x", [2, 2, 3]), [2, 1, 4, 5])],
    "grid_sampler": lambda p: [p.layers.grid_sampler(
        d(p, "x", [2, 3, 4, 5]), p.layers.scale(p.layers.tanh(d(p, "g", [2, 3, 3, 2])), 0.9))],
    # 3-D and trilinear, over op types ported before
    "conv3d": lambda p: [p.layers.conv3d(d(p, "x", [2, 3, 4, 5, 5]), 4, 3, padding=1,
                                         act="relu")],
    "conv3d_transpose": lambda p: [p.layers.conv3d_transpose(d(p, "x", [2, 3, 3, 4, 4]), 2,
                                                             filter_size=3, stride=2)],
    "pool3d": lambda p: [p.layers.pool3d(d(p, "x", [2, 3, 4, 6, 6]), 2, "avg", 2)],
    "adaptive_pool3d": lambda p: [p.layers.adaptive_pool3d(d(p, "x", [2, 3, 4, 6, 6]),
                                                           [2, 3, 3])],
    "resize_trilinear": lambda p: [p.layers.resize_trilinear(d(p, "x", [2, 3, 2, 3, 4]),
                                                             out_shape=[4, 5, 6])],
    # losses
    "selu": lambda p: [p.layers.selu(d(p, "x", [3, 4]))],
    "rank_loss": lambda p: [p.layers.rank_loss(
        p.layers.cast(d(p, "l", [5, 1], "int64"), "float32"), d(p, "x", [5, 1]),
        d(p, "y", [5, 1]))],
    "margin_rank_loss": lambda p: [p.layers.margin_rank_loss(
        _assign(p, np.float32([[1], [-1], [1], [-1], [1]])), d(p, "x", [5, 1]),
        d(p, "y", [5, 1]))],
    "bpr_loss": lambda p: [p.layers.bpr_loss(d(p, "x", [4, 5]), d(p, "l", [4, 1], "int64"))],
    "kldiv_loss": lambda p: [p.layers.kldiv_loss(
        d(p, "x", [3, 4]), p.layers.sigmoid(d(p, "y", [3, 4])), "batchmean")],
    "dice_loss": lambda p: [p.layers.dice_loss(p.layers.sigmoid(d(p, "x", [3, 4])),
                                               d(p, "l", [3, 4], "int64"))],
    "npair_loss": lambda p: [p.layers.npair_loss(d(p, "x", [4, 3]), d(p, "y", [4, 3]),
                                                 d(p, "l", [4], "int64"))],
    "sampled_softmax_with_cross_entropy": lambda p: [
        p.layers.sampled_softmax_with_cross_entropy(d(p, "x", [4, 6]),
                                                    d(p, "l", [4, 1], "int64"), 3)],
    "teacher_student_sigmoid_loss": lambda p: [p.layers.teacher_student_sigmoid_loss(
        d(p, "x", [6, 1]), _assign(p, np.float32([[-2], [-1], [0.3], [1.4], [0], [1]])))],
    "hsigmoid": lambda p: [p.layers.hsigmoid(d(p, "x", [4, 3]), d(p, "l", [4, 1], "int64"), 4)],
    "mean_iou": lambda p: list(p.layers.mean_iou(d(p, "i", [8], "int32"),
                                                 d(p, "l", [8], "int32"), 4)),
    # CTC, the decoder, the evaluator, chunk_eval
    "warpctc": lambda p: [p.layers.warpctc(
        d(p, "x", [3, 6, 5]), d(p, "l", [3, 3], "int64"), blank=4, norm_by_times=True,
        input_length=_assign(p, np.array([6, 5, 6])),
        label_length=_assign(p, np.array([3, 1, 2])))],
    "ctc_greedy_decoder": lambda p: list(p.layers.ctc_greedy_decoder(
        d(p, "x", [3, 7, 4]), 0, input_length=_assign(p, np.array([7, 4, 6])))),
    "edit_distance": lambda p: list(p.layers.edit_distance(
        d(p, "h", [3, 5], "int64"), d(p, "r", [3, 4], "int64"), normalized=False,
        input_length=_assign(p, np.array([5, 2, 0])),
        label_length=_assign(p, np.array([4, 4, 1])))),
    "chunk_eval": lambda p: list(p.layers.chunk_eval(
        d(p, "i", [3, 8], "int64"), d(p, "l", [3, 8], "int64"), "IOB", 2,
        seq_length=_assign(p, np.array([8, 5, 2])))),
    # beam, sizes, hashes, uniques
    "gather_tree": lambda p: [p.layers.gather_tree(d(p, "i", [4, 2, 3], "int64"),
                                                   d(p, "l", [4, 2, 3], "int64"))],
    "size": lambda p: [p.layers.size(d(p, "x", [3, 4]))],
    "hash": lambda p: [p.layers.hash(d(p, "i", [5, 1], "int64"), 1000, num_hash=2)],
    "unique": lambda p: list(p.layers.unique(d(p, "i", [8], "int64"))),
    "unique_with_counts": lambda p: list(p.layers.unique_with_counts(d(p, "i", [8], "int64"))),
    "lod_reset-lod_append": _lod,
    "continuous_value_model": lambda p: [
        p.layers.continuous_value_model(d(p, "x", [3, 5]), None, use_cvm=False),
        p.layers.continuous_value_model(d(p, "y", [3, 5]), None)],
    # recurrent
    "dynamic_lstmp": lambda p: list(p.layers.dynamic_lstmp(d(p, "x", [2, 5, 12]), 12, 2)),
    "lstm-init": lambda p: list(p.layers.lstm(
        d(p, "x", [2, 5, 3]), d(p, "h", [1, 2, 4]), d(p, "c", [1, 2, 4]), 5, 4, 1)),
    "im2sequence": lambda p: [p.layers.im2sequence(d(p, "x", [2, 3, 6, 8]), [3, 2], [1, 2])],
    # stateful
    "spectral_norm": lambda p: [p.layers.spectral_norm(d(p, "x", [4, 3, 2]), dim=1,
                                                       power_iters=2)],
    "data_norm": lambda p: [p.layers.data_norm(d(p, "x", [4, 3]), act="tanh")],
    "center_loss": lambda p: [p.layers.center_loss(d(p, "x", [6, 3]),
                                                   d(p, "l", [6, 1], "int64"), 3, 0.5)],
    # sequence
    "sequence_mask": lambda p: [p.layers.sequence_mask(d(p, "l", [3], "int64"), 4, "float32")],
    "sequence_softmax": lambda p: [p.layers.sequence_softmax(
        d(p, "x", [3, 6]), length=_assign(p, np.array([6, 2, 1])))],
    "sequence_concat": lambda p: [p.layers.sequence_concat([d(p, "x", [2, 3, 4]),
                                                            d(p, "y", [2, 3, 2])])],
    "sequence_expand": lambda p: [p.layers.sequence_expand(d(p, "x", [3, 4]), None,
                                                           ref_lengths=[2, 0, 3])],
    "sequence_expand_as": lambda p: [p.layers.sequence_expand_as(
        d(p, "x", [3, 4]), d(p, "y", [5, 4]), ref_lengths=[1, 3, 1])],
    "sequence_pad": lambda p: [p.layers.sequence_pad(
        d(p, "x", [3, 5, 2]), 1.5, length=_assign(p, np.array([5, 3, 0])))[0]],
    "sequence_slice": lambda p: [p.layers.sequence_slice(
        d(p, "x", [3, 6, 2]), _assign(p, np.array([[0], [2], [3]])), None, out_len=3)],
    "sequence_enumerate": lambda p: [p.layers.sequence_enumerate(
        d(p, "i", [3, 6], "int64"), 3, length=_assign(p, np.array([6, 4, 1])))],
    "sequence_erase": lambda p: list(p.layers.sequence_erase(
        d(p, "i", [3, 7], "int64"), [1, 3], length=_assign(p, np.array([7, 5, 2])))),
    "sequence_reshape": lambda p: [p.layers.sequence_reshape(d(p, "x", [2, 6, 4]), 8)],
    "sequence_scatter": lambda p: [p.layers.sequence_scatter(
        d(p, "x", [3, 5]), _assign(p, np.array([[0, 2, 2], [1, 1, 0], [4, 3, 2]])),
        d(p, "y", [3, 3]))],
}

#: drawn in the graph: held by program and output shapes
DRAWN = {
    "nce": (lambda p: [p.layers.nce(d(p, "x", [4, 3]), d(p, "l", [4, 1], "int64"), 10,
                                    num_neg_samples=3)], [(4, 1)]),
    "sampling_id": (lambda p: [p.layers.sampling_id(p.layers.softmax(d(p, "x", [4, 5])))],
                    [(4,)]),
    "uniform_random_batch_size_like": (lambda p: [p.layers.uniform_random_batch_size_like(
        d(p, "x", [4, 3]), [-1, 7], min=0.0, max=2.0)], [(4, 7)]),
    "gaussian_random_batch_size_like": (lambda p: [p.layers.gaussian_random_batch_size_like(
        d(p, "x", [4, 3]), [2, -1], input_dim_idx=0, output_dim_idx=1)], [(2, 4)]),
    "random_crop": (lambda p: [p.layers.random_crop(d(p, "x", [3, 8, 9]), [5, 4])],
                    [(3, 5, 4)]),
}


def _build(pkg, build):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        outs = build(pkg)
    return main, startup, outs


def _feed(main, seed=1):
    rng = np.random.RandomState(seed)
    feed = {}
    for n, v in sorted(main.global_block().vars.items()):
        if v.is_data:
            shape = tuple(v.shape)
            feed[n] = (rng.randn(*shape).astype("float32") if v.dtype == "float32"
                       else rng.randint(0, 3, shape).astype(v.dtype))
    return feed


def _int32(dt):
    return "int32" if dt == "int64" else dt


def _same_programs(jp, tp):
    for a, b in zip(jp, tp):
        jd, td = a.to_dict(), b.to_dict()
        assert [blk["ops"] for blk in td["blocks"]] == [blk["ops"] for blk in jd["blocks"]]
        assert ({v["name"]: (v["shape"], _int32(v["dtype"])) for v in td["blocks"][0]["vars"]}
                == {v["name"]: (v["shape"], _int32(v["dtype"])) for v in jd["blocks"][0]["vars"]})


def _jax_run(main, startup, outs, feed, steps=1):
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        state = {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
                 if v.persistable and scope.find_var(n) is not None}
        for _ in range(steps):
            got = [np.asarray(o) for o in exe.run(main, feed=feed, fetch_list=outs)]
        final = {n: np.asarray(scope.find_var(n)) for n in state}
    return state, got, final


def _port_run(main, outs, state, feed, steps=1):
    scope = pt.Scope()
    convert.load_state(scope, convert.state_from_numpy(state, device="cpu"))
    exe = pt.Executor(CPU)
    with pt.scope_guard(scope):
        for _ in range(steps):
            got = exe.run(main, feed=feed, fetch_list=outs)
    return [np.asarray(g) for g in got], {n: scope.find_var(n).numpy() for n in state}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_builds_and_runs_as_jax(name):
    jm, js, jo = _build(fluid, LAYERS[name])
    tm, ts, to = _build(pt, LAYERS[name])
    _same_programs((jm, js), (tm, ts))
    feed = _feed(tm)
    state, want, _ = _jax_run(jm, js, jo, feed)
    got, _ = _port_run(tm, to, state, feed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


def _bilstm(p):
    return list(p.layers.lstm(d(p, "x", [2, 5, 3]), None, None, 5, 4, 2, is_bidirec=True))


def test_3_29_bidirectional_lstm_raises_in_jax_and_runs_in_the_port(monkeypatch):
    """ROADMAP 3.29: the JAX ``lstm(is_bidirec=True)`` calls ``nn.concat``,
    which ``paddle_tpu.layers.nn`` does not define
    (``paddle_tpu/layers/extras.py:195``), and raises AttributeError. The
    port concatenates with ``tensor.concat``; it is held against the JAX
    layer with that one name supplied."""
    with pytest.raises(AttributeError, match="concat"):
        _build(fluid, _bilstm)
    monkeypatch.setattr(fluid.layers.nn, "concat", fluid.layers.tensor.concat, raising=False)
    jm, js, jo = _build(fluid, _bilstm)
    tm, ts, to = _build(pt, _bilstm)
    _same_programs((jm, js), (tm, ts))
    feed = _feed(tm)
    state, want, _ = _jax_run(jm, js, jo, feed)
    got, _ = _port_run(tm, to, state, feed)
    assert [g.shape for g in got] == [(2, 5, 8), (4, 2, 4), (4, 2, 4)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", sorted(DRAWN))
def test_drawing_layer_builds_the_jax_program(name):
    build, shapes = DRAWN[name]
    jm, js, _ = _build(fluid, build)
    tm, ts, to = _build(pt, build)
    _same_programs((jm, js), (tm, ts))
    got, _ = _port_run(tm, to, _startup_state(js, jm), _feed(tm))
    assert [g.shape for g in got] == shapes
    assert all(np.isfinite(g).all() for g in got)


def _startup_state(startup, main):
    exe, scope = fluid.Executor(), fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        return {n: np.asarray(scope.find_var(n)) for n, v in main.global_block().vars.items()
                if v.persistable and scope.find_var(n) is not None}


@pytest.mark.parametrize("layer", ["get_tensor_from_selected_rows", "merge_selected_rows"])
def test_selected_rows_layers_raise_in_both(layer):
    for pkg in (fluid, pt):
        with pytest.raises(NotImplementedError):
            getattr(pkg.layers, layer)(None)


def _stateful(p):
    main, startup, loss, _ = xc.build_state_program(p)
    return main, startup, loss


def test_two_sgd_steps_write_back_the_state_as_jax(monkeypatch):
    """data_norm's accumulators, center_loss's centers and spectral_norm's
    U and V leave each step as the JAX package's do (the program's noise
    draw, which differs between the packages, replaced by zeros in both)."""
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg
    for reg, pkg in ((jreg, fluid), (treg, pt)):
        monkeypatch.setattr(reg.get("uniform_random_batch_size_like"), "lower", _zero_noise(pkg))
    jm, js, jl = _stateful(fluid)
    tm, ts, tl = _stateful(pt)
    _same_programs((jm, js), (tm, ts))
    feed = xc.state_feed(4)
    state, want, jfinal = _jax_run(jm, js, [jl], feed, steps=2)
    got, tfinal = _port_run(tm, [tl], state, feed, steps=2)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    written = [n for n in jfinal if not np.array_equal(jfinal[n], state[n])]
    assert any("data_norm" in n for n in written) and any("center_loss" in n for n in written)
    assert sum("spectral_norm" in n for n in written) == 2, written
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=1e-5, atol=1e-6, err_msg=n)


def _zero_noise(pkg):
    def lower(ctx, ins):
        x = ins["Input"][0]
        if pkg is fluid:
            import jax.numpy as jnp
            return {"Out": [jnp.zeros(x.shape, "float32")]}
        import torch
        return {"Out": [torch.zeros(tuple(x.shape), device=x.device)]}
    return lower


def test_a_captured_step_writes_back_the_state_and_redraws(stand_in):
    """Three steps through the executor's step graph (the CPU stand-in of
    ``tests/test_torch_graph_step.py``: the capture runs nothing, each replay
    runs the captured step) against three eager steps, bit for bit: the
    state written back by data_norm, center_loss and spectral_norm, and the
    noise, drawn anew at each replay from the run counter."""
    main, startup, loss, noise = xc.build_state_program(pt)
    feed = xc.state_feed(4)
    init = _startup_state(*_stateful(fluid)[1::-1])
    runs = {}
    for graphs_on in (True, False):
        scope = pt.Scope()
        convert.load_state(scope, convert.state_from_numpy(init, device="cpu"))
        exe = pt.Executor(CPU)
        exe._use_graphs = graphs_on
        main._rng_run_counter = 0
        with pt.scope_guard(scope):
            outs = [exe.run(main, feed=feed, fetch_list=[loss, noise]) for _ in range(3)]
        runs[graphs_on] = (outs, {n: scope.find_var(n).numpy() for n in init})
    assert stand_in.captures == 1
    (g, gs), (e, es) = runs[True], runs[False]
    for a, b in zip(g, e):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(g[0][1], g[1][1]) and np.abs(g[2][1]).max() <= 0.01
    assert [n for n in init if not np.array_equal(gs[n], es[n])] == []
    assert [n for n in init if ("norm" in n or "center" in n) and np.array_equal(gs[n], init[n])
            ] == []


# ------------------------------------------------------------------ distributions

class _PortFluid:
    """The port under the JAX package's name, its executor on the CPU."""

    def __getattr__(self, name):
        if name == "Executor":
            return lambda *a, **k: pt.Executor(CPU)
        return getattr(pt, name)


def _distribution_tests():
    path = os.path.join(os.path.dirname(__file__), "test_distributions.py")
    spec = importlib.util.spec_from_file_location("_port_distribution_oracles", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_ORACLES = _distribution_tests()


@pytest.mark.parametrize("test", sorted(n for n in dir(_ORACLES) if n.startswith("test_")))
def test_distributions_meet_the_jax_oracles(test, monkeypatch):
    from paddle_tpu_torch.layers import distributions
    monkeypatch.setattr(_ORACLES, "fluid", _PortFluid())
    monkeypatch.setattr(_ORACLES, "D", distributions)
    getattr(_ORACLES, test)()


def test_the_port_exports_every_callable_of_the_jax_layers():
    """Every public callable of ``paddle_tpu.layers`` (the re-exported
    ``LayerHelper``, ``Variable``, ``default_main_program`` and
    ``convert_dtype`` among them), and the four distributions."""
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_") and callable(getattr(mod, n))}
    assert sorted(names(fluid.layers) - names(pt.layers)) == []
    from paddle_tpu.layers import distributions as jd
    from paddle_tpu_torch.layers import distributions as td
    assert jd.__all__ == td.__all__
