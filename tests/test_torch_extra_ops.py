"""The op types of ROADMAP item 8 (``ops/extra_ops.py``, ``ops/tail_ops.py``,
the rest of ``ops/sequence_ops.py``, ``warpctc``, ``ctc_align``, ``nce``,
``hsigmoid``, ``chunk_eval``) against the JAX package on the CPU, on the
same seeded numpy inputs.

Every case of ``paddle_tpu_torch/tools/extra_op_cases.py``: each output
slot of the forward and each input gradient of the generic ``<op>_grad``
(the same seeded cotangents), at the case's tolerance (float32 ``atol
1e-5, rtol 1e-5``; CTC ``atol 1e-4``; integer outputs and edit distances
exactly). The random ops draw from each package's own generator, so they
are held by statistics; ``nce`` runs through the JAX lowering with the
port's negatives. ``hash`` is held bit for bit. ``py_func`` runs through
both executors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.core import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.executor import capture_refusal
from paddle_tpu_torch.ops.extra_ops import counter_randint
from paddle_tpu_torch.tools import extra_op_cases as xc
from paddle_tpu_torch.tools.op_cases import numpy_outs

CPU = pt.CPUPlace()
HELD = sorted(n for n in xc.CASES if n not in xc.RANDOM)


def _jax(ins_np, attrs, op):
    return jreg.get(op).lower(jreg.LowerCtx(dict(attrs)),
                              {s: [jnp.asarray(a) for a in v] for s, v in ins_np.items()})


def _close(got, want, tol, what):
    got, want = numpy_outs({"x": [got]})["x"][0], numpy_outs({"x": [want]})["x"][0]
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if tol["atol"] == 0 and tol["rtol"] == 0:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _held_against_jax(c, name, jouts):
    touts = xc.forward(c, "cpu")
    assert sorted(touts) == sorted(jouts), name
    for slot in jouts:
        for i, want in enumerate(jouts[slot]):
            _close(touts[slot][i], want, c.tol, f"{name} {slot}")
    if not c.grad:
        return
    gins, gattrs = xc.grad_inputs(c, jouts)
    jg = _jax(gins, gattrs, c.op + "_grad")
    tg = xc.grad(c, "cpu", jouts)
    slots = xc.grad_slots(c)
    assert slots and sorted(tg) == sorted(s + "@GRAD" for s in slots), (name, sorted(tg))
    for s in slots:
        for i, want in enumerate(jg[s + "@GRAD"]):
            _close(tg[s + "@GRAD"][i], want, c.grad_tol, f"{name} {s}@GRAD")


@pytest.mark.parametrize("name", HELD)
def test_extra_op_matches_jax(name):
    """Forward, every output slot; then the generic grad against the JAX
    package's vjp with the same cotangents."""
    c = xc.CASES[name]
    _held_against_jax(c, name, _jax(c.ins, c.attrs, c.op))


@pytest.mark.parametrize("name", ["nce", "nce-no-bias"])
def test_nce_matches_jax_on_the_ports_negatives(name, monkeypatch):
    """The JAX lowering given the negatives the port drew (its ``randint``
    replaced for the call): cost and gradients as any other case."""
    c = xc.CASES[name]
    ctx = treg.LowerCtx(dict(c.attrs), "cpu")
    neg = counter_randint(ctx, (c.attrs["num_neg_samples"],), c.attrs["num_total_classes"])
    assert int(neg.min()) >= 0 and int(neg.max()) < c.attrs["num_total_classes"]
    monkeypatch.setattr(jax.random, "randint",
                        lambda *a, **k: jnp.asarray(neg.numpy().astype("int32")))
    _held_against_jax(c, name, _jax(c.ins, c.attrs, c.op))


def _draws(c, pkg, runs=1):
    """The op's output in ``runs`` runs with other seeds, numpy."""
    outs = []
    for k in range(runs):
        attrs = dict(c.attrs)
        if pkg == "jax":
            ctx = jreg.LowerCtx(attrs, base_key=jax.random.PRNGKey(k), salt=k)
            outs.append(np.asarray(jreg.get(c.op).lower(
                ctx, {s: [jnp.asarray(a) for a in v] for s, v in c.ins.items()})["Out"][0]))
        else:
            ctx = treg.LowerCtx(attrs, "cpu", seed=7, counter=k)
            outs.append(treg.get(c.op).lower(ctx, xc._tensors(c.ins, "cpu"))["Out"][0].numpy())
    return outs


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_random_ops_draw_their_distributions(pkg):
    """Both packages' draws: ``sampling_id``'s class frequencies over 4,000
    rows within 0.03 of [0.1, 0.2, 0.3, 0.4] (4 standard errors); 100,000
    uniforms in [-2, 3) with mean 0.5 +- 0.03 and variance 25/12 within 3%;
    100,000 normals with mean 0.5 +- 0.03 and std 2 within 2%;
    ``random_crop`` a window of X at some start, the starts spread over
    three runs (the port's counter advances) or three keys (JAX)."""
    ids = _draws(xc.CASES["sampling_id"], pkg)[0]
    freq = np.bincount(ids.astype(np.int64), minlength=4) / len(ids)
    assert np.abs(freq - [0.1, 0.2, 0.3, 0.4]).max() < 0.03, freq
    u = _draws(xc.CASES["uniform_random_batch_size_like"], pkg)[0]
    assert u.shape == (400, 250) and u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean() - 0.5) < 0.03 and abs(u.var() / (25 / 12) - 1) < 0.03
    g = _draws(xc.CASES["gaussian_random_batch_size_like"], pkg)[0]
    assert g.shape == (400, 250)
    assert abs(g.mean() - 0.5) < 0.03 and abs(g.std() / 2.0 - 1) < 0.02
    x = xc.CASES["random_crop"].ins["X"][0]
    starts = set()
    for out in _draws(xc.CASES["random_crop"], pkg, runs=3):
        assert out.shape == (3, 5, 4)
        hit = [(a, b) for a in range(4) for b in range(6)
               if np.array_equal(out, x[:, a:a + 5, b:b + 4])]
        assert len(hit) == 1, hit
        starts.add(hit[0])
    assert len(starts) > 1, starts


def test_port_draws_repeat_for_a_counter_and_change_with_it():
    """The counter-derived generator: the same (seed, counter) draws the same
    numbers, the next counter others."""
    c = xc.CASES["uniform_random_batch_size_like"]
    lower = treg.get(c.op).lower
    ins = xc._tensors(c.ins, "cpu")
    a, b, other = (lower(treg.LowerCtx(dict(c.attrs), "cpu", seed=3, counter=k), ins)["Out"][0]
                   for k in (1, 1, 2))
    assert np.array_equal(a.numpy(), b.numpy()) and not np.array_equal(a.numpy(), other.numpy())


def test_hash_is_the_jax_lowering_bit_for_bit_on_wide_ids():
    """Ids across the uint32 range (negative ids wrap as uint32 in both)."""
    x = np.array([[-5], [0], [2 ** 31 - 1], [4000000000 % 2 ** 31], [77]], "int64")
    attrs = {"num_hash": 4, "mod_by": 2 ** 31 - 1}
    want = np.asarray(_jax({"X": [x.astype("int32")]}, attrs, "hash")["Out"][0])
    got = treg.get("hash").lower(treg.LowerCtx(attrs, "cpu"),
                                 xc._tensors({"X": [x]}, "cpu"))["Out"][0].numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_every_item8_type_has_a_case_and_the_jax_flags():
    """The table covers each op type of the six JAX modules the slice ports
    (collective and pipeline ops are item 13's), with the JAX registry's
    gradient flags."""
    mods = ("extra_ops", "tail_ops", "sequence_ops", "ctc_crf_ops", "sampled_ops",
            "metrics_ops")
    jtypes = {t for t, d in jreg._REGISTRY.items()
              if d.lower.__module__.rsplit(".", 1)[-1] in mods}
    missing = sorted(jtypes - set(treg._REGISTRY))
    assert not missing, missing
    new = xc.EXTRA_TYPES
    assert not sorted(new - jtypes), sorted(new - jtypes)
    ported_before = {"sequence_pool", "sequence_reverse", "sequence_conv", "sequence_unpad",
                     "linear_chain_crf", "crf_decoding", "accuracy", "auc", "sync_batch_norm",
                     "multiclass_nms2", "generate_mask_labels", "space_to_depth", "fsp"}
    assert sorted(jtypes - new - ported_before) == []
    for op in new:
        t, j = treg.get(op), jreg.get(op)
        assert (t.grad is None) == (j.grad is None), op
        assert t.nondiff_inputs == j.nondiff_inputs, op
        assert t.nondiff_outputs == j.nondiff_outputs, op


def test_im2sequence_orders_features_as_conv_patches():
    """F.unfold's (c, kh, kw) order is lax.conv_general_dilated_patches':
    feature c*kh*kw + i*kw + j of step (y, x) is X[c, y + i, x + j]."""
    x = np.arange(2 * 3 * 4 * 5, dtype="float32").reshape(2, 3, 4, 5)
    attrs = {"kernels": [2, 3], "strides": [1, 1]}
    got = treg.get("im2sequence").lower(treg.LowerCtx(attrs, "cpu"),
                                        xc._tensors({"X": [x]}, "cpu"))["Out"][0].numpy()
    want = np.asarray(_jax({"X": [x]}, attrs, "im2sequence")["Out"][0])
    np.testing.assert_array_equal(got, want)
    ow = 3
    for c, i, j, y, xx in ((0, 0, 0, 0, 0), (2, 1, 2, 2, 2), (1, 0, 1, 1, 0)):
        assert got[1, y * ow + xx, c * 6 + i * 3 + j] == x[1, c, y + i, xx + j]


@pytest.mark.parametrize("op", ["sequence_expand", "sequence_expand_as"])
def test_sequence_expand_without_static_counts_raises_in_both(op):
    ins = {"X": [np.ones((2, 3), "float32")]}
    if op == "sequence_expand_as":
        ins["Y"] = [np.ones((4, 3), "float32")]
    with pytest.raises(NotImplementedError):
        _jax(ins, {}, op)
    with pytest.raises(NotImplementedError):
        treg.get(op).lower(treg.LowerCtx({}, "cpu"), xc._tensors(ins, "cpu"))


def _py_func_program(pkg, table):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [4], "float32")
        out = main.current_block().create_var("pyout", (-1, 4), "float32")
        y = pkg.layers.py_func(xc._py_func_double, x, out)
        z = pkg.layers.scale(y, 3.0)
    return main, startup, z


def test_py_func_runs_through_both_executors_and_refuses_capture():
    from paddle_tpu.layers import extras as jx
    from paddle_tpu_torch.layers import extras as tx
    feed = {"x": np.random.RandomState(0).randn(3, 4).astype("float32")}
    jm, js, jz = _py_func_program(fluid, jx._PYFUNC_TABLE)
    want = np.asarray(fluid.Executor().run(jm, feed=feed, fetch_list=[jz])[0])
    tm, ts, tz = _py_func_program(pt, tx._PYFUNC_TABLE)
    got = pt.Executor(CPU).run(tm, feed=feed, fetch_list=[tz])[0]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, (feed["x"] * 2 + 1) * 3, rtol=1e-6)
    why = capture_refusal(tm)
    assert why is not None and "py_func" in why
    c = xc.py_func_case(tx._PYFUNC_TABLE)
    out = xc.forward(c, "cpu")["Out"][0].numpy()
    np.testing.assert_allclose(out, c.ins["X"][0] * 2 + 1, rtol=1e-6)
