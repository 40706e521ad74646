"""The port's static verifier (``paddle_tpu_torch/analysis/``) against the
JAX package's (``paddle_tpu/analysis/``).

Every case of ``tests/test_analysis.py`` that needs no strategy is built
twice, once by each package's framework or DSL, and both verifiers must
return the same findings: the same ``(code, severity, block_idx, op_idx,
op_type, var)`` list, in order. The JAX default pipeline also runs its
``distributed`` pass; on these programs its part is empty (no PT04x), which
each case asserts. Each case also keeps the JAX test's own expectation.

Beyond the pins: the zoo programs (mnist, an RNN ``scan``, a while loop,
YOLOv3's loss, fit_a_line with its for_test clone and fetch prune), a JAX
program's JSON read by the port, full-width BERT-base pretraining (B128
S128, 853 ops; only programs are built, no weights), the CLI against the
JAX CLI on the same files, the item-13 refusals, and PT060 over the port's
attribution of a CPU run.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import analysis as janalysis
from paddle_tpu.analysis.__main__ import main as jcli
import paddle_tpu_torch as pt
from paddle_tpu_torch import analysis
from paddle_tpu_torch.analysis.__main__ import main as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (fluid, janalysis), "port": (pt, analysis)}


def key(d):
    return (d.code, d.severity, d.block_idx, d.op_idx, d.op_type, d.var)


def codes(diags):
    return {d.code for d in diags}


def errors(diags):
    return [d for d in diags if d.severity == "error"]


def both(build):
    """``build(pkg)`` -> (program, verify kwargs) in each package; returns
    (jax findings, port findings), asserted equal by key."""
    out = {}
    for name, (pkg, an) in PKGS.items():
        prog, kw = build(pkg)
        out[name] = an.verify(prog, **kw)
    jd, td = out["jax"], out["port"]
    assert not any(d.code.startswith("PT04") for d in jd), \
        "the JAX distributed pass found something on a strategy-free program"
    assert [key(d) for d in td] == [key(d) for d in jd]
    return jd, td


# ------------------------------------------------------------------- pins --

def _prog(pkg):
    return pkg.Program()


def _relu_of(var, data=None, shape=(4,), **kw):
    def build(pkg):
        p = _prog(pkg)
        b = p.global_block()
        if data is not None:
            b.create_var(data, shape, "float32", is_data=True)
        b.append_op("relu", inputs={"X": [var]}, outputs={"Out": ["y"]},
                    infer_shape=False)
        return p, kw
    return build


def _declared_never_produced(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("z", (4,), "float32")
    b.append_op("relu", inputs={"X": ["z"]}, outputs={"Out": ["y"]}, infer_shape=False)
    return p, {}


def _use_before_def(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("x", (4,), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["late"]}, outputs={"Out": ["y"]}, infer_shape=False)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["late"]}, infer_shape=False)
    return p, {}


def _self_read(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("y", (4,), "float32")
    b.append_op("relu", inputs={"X": ["y"]}, outputs={"Out": ["y"]}, infer_shape=False)
    return p, {"passes": ["wellformed"]}


def _shadowed(pkg):
    p = _prog(pkg)
    gb = p.global_block()
    gb.create_var("v", (4,), "float32", is_data=True)
    sub = p._create_block()
    sub.create_var("v", (2,), "float32")
    p._rollback()
    gb.append_op("relu", inputs={"X": ["v"]}, outputs={"Out": ["y"]},
                 attrs={"sub_block": sub.idx}, infer_shape=False)
    return p, {}


def _unregistered(pkg):
    p = _prog(pkg)
    p.global_block().append_op("definitely_not_registered", inputs={},
                               outputs={"Out": ["y"]}, infer_shape=False)
    return p, {}


def _bad_block_attr(pkg):
    p = _prog(pkg)
    p.global_block().append_op("relu", inputs={}, outputs={"Out": ["y"]},
                               attrs={"sub_block": 99}, infer_shape=False)
    return p, {}


def _cycle(pkg):
    p = _prog(pkg)
    sub = p._create_block()
    p._rollback()
    p.global_block().append_op("relu", inputs={}, outputs={"Out": ["y"]},
                               attrs={"sub_block": sub.idx}, infer_shape=False)
    sub.append_op("relu", inputs={}, outputs={"Out": ["z"]},
                  attrs={"sub_block": sub.idx}, infer_shape=False)
    return p, {}


def _orphan(pkg):
    p = _prog(pkg)
    p._create_block()
    p._rollback()
    return p, {}


def _two_relus(fetch, second_input="x", feeds=None):
    def build(pkg):
        p = _prog(pkg)
        b = p.global_block()
        b.create_var("x", (4,), "float32", is_data=True)
        b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
        b.append_op("relu", inputs={"X": [second_input]}, outputs={"Out": ["z"]})
        return p, {"fetch_names": fetch, "feed_names": feeds}
    return build


def _one_relu(shape=(4,), **kw):
    def build(pkg):
        p = _prog(pkg)
        b = p.global_block()
        b.create_var("x", shape, "float32", is_data=True)
        b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
        return p, kw
    return build


def _fills(read_between, inplace=False):
    def build(pkg):
        p = _prog(pkg)
        b = p.global_block()
        b.append_op("fill_constant", outputs={"Out": ["c"]},
                    attrs={"shape": [2], "dtype": "float32", "value": 1.0})
        if inplace:
            b.append_op("relu", inputs={"X": ["c"]}, outputs={"Out": ["c"]},
                        infer_shape=False)
            return p, {"fetch_names": ["c"]}
        if read_between:
            b.append_op("relu", inputs={"X": ["c"]}, outputs={"Out": ["y"]})
        b.append_op("fill_constant", outputs={"Out": ["c"]},
                    attrs={"shape": [2], "dtype": "float32", "value": 2.0})
        return p, {"fetch_names": ["c", "y"] if read_between else ["c"]}
    return build


def _unread_feed(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("x", (4,), "float32", is_data=True)
    b.create_var("unused", (4,), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    return p, {"feed_names": ["x", "unused"], "fetch_names": ["y"]}


def _declared_clash(shape, dtype):
    def build(pkg):
        p = _prog(pkg)
        b = p.global_block()
        b.create_var("x", (4,), "float32", is_data=True)
        b.create_var("y", shape, dtype)
        b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                    infer_shape=False)
        return p, {}
    return build


def _bad_reshape(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("x", (4,), "float32", is_data=True)
    b.append_op("reshape", inputs={"X": ["x"]}, outputs={"Out": ["y"]},
                attrs={"shape": [3]}, infer_shape=False)
    return p, {}


def _dynamic_seq(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("seq", (-1, -1, 8), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["seq"]}, outputs={"Out": ["y"]}, infer_shape=False)
    return p, {}


def _dropouts(mixed, seed=None):
    def build(pkg):
        p = _prog(pkg)
        p.random_seed = seed
        b = p.global_block()
        b.create_var("x", (4,), "float32", is_data=True)
        b.append_op("dropout", inputs={"X": ["x"]}, outputs={"Out": ["a"]},
                    attrs={"dropout_prob": 0.5, "is_test": False} if mixed
                    else {"dropout_prob": 0.5}, infer_shape=False)
        if mixed:
            b.append_op("dropout", inputs={"X": ["a"]}, outputs={"Out": ["b"]},
                        attrs={"dropout_prob": 0.5, "is_test": True}, infer_shape=False)
        return p, {}
    return build


def _subblock_shadow_dtype(pkg):
    p = _prog(pkg)
    gb = p.global_block()
    gb.create_var("x", (4,), "float32", is_data=True)
    gb.create_var("tmp", (4,), "int32")
    gb.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["tmp"]}, infer_shape=False)
    sub = p._create_block()
    sub.create_var("tmp", (4,), "float32")
    sub.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["tmp"]}, infer_shape=False)
    p._rollback()
    gb.append_op("relu", inputs={"X": ["tmp"]}, outputs={"Out": ["y"]},
                 attrs={"sub_block": sub.idx}, infer_shape=False)
    return p, {"passes": ["typecheck"]}


def _sorted_errors_first(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("x", (-1, 4), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x", "ghost"]}, outputs={"Out": ["y"]},
                infer_shape=False)
    return p, {}


def _buggy(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("x", (-1, -1, 4), "float32", is_data=True)
    b.append_op("relu", inputs={"X": ["x", "ghost"]}, outputs={"Out": ["y"]},
                infer_shape=False)
    b.append_op("definitely_not_registered", inputs={"X": ["y"]}, outputs={"Out": ["z"]},
                infer_shape=False)
    return p, {"fetch_names": ["z"]}


def _collective(pkg):
    p = _prog(pkg)
    b = p.global_block()
    b.create_var("x", (8, 4), "float32", is_data=True)
    b.append_op("c_allreduce_sum", inputs={"X": ["x"]}, outputs={"Out": ["boundary"]},
                infer_shape=False)
    b.append_op("relu", inputs={"X": ["x"]}, outputs={"Out": ["y"]})
    return p, {"fetch_names": ["y"]}


def _has(code, text="", **match):
    def check(diags):
        assert any(d.code == code and text in d.message
                   and all(getattr(d, k) == v for k, v in match.items())
                   for d in diags), (code, match, [key(d) for d in diags])
    return check


def _lacks(*cs):
    def check(diags):
        assert not codes(diags) & set(cs), [key(d) for d in diags]
    return check


def _dead_only_op1(diags):
    dead = [d for d in diags if d.code == "PT010"]
    assert len(dead) == 1 and dead[0].var is None and dead[0].op_idx == 1


def _self_read_check(diags):
    d = next(d for d in diags if d.var == "y")
    assert d.code == "PT002" and "same op" in d.message


def _sorted_check(diags):
    order = [analysis.Severity.ORDER[d.severity] for d in diags]
    assert order == sorted(order) and diags[0].severity == "error"


#: (id, build, the JAX test's own expectation on the port's findings)
PINS = [
    ("pt001_undefined", _relu_of("ghost"),
     _has("PT001", severity="error", var="ghost", op_type="relu")),
    ("pt001_declared", _declared_never_produced, _has("PT001", "declared")),
    ("pt002_use_before_def", _use_before_def, _has("PT002", var="late")),
    ("pt002_self_read", _self_read, _self_read_check),
    ("pt003_shadowed", _shadowed, _has("PT003", var="v")),
    ("pt004_unregistered", _unregistered, _has("PT004", severity="error")),
    ("pt005_bad_block_attr", _bad_block_attr, _has("PT005")),
    ("pt006_cycle", _cycle, _has("PT006")),
    ("pt007_orphan", _orphan, _has("PT007")),
    ("pt010_dead_op", _two_relus(["y"]), _dead_only_op1),
    ("pt010_no_intent", _two_relus(None), _lacks("PT010")),
    ("pt011_unused_output", _one_relu(), _has("PT011", var="y")),
    ("pt012_fetch_never_produced", _one_relu(fetch_names=["nope"]),
     _has("PT012", var="nope", severity="error")),
    ("pt012_fetch_feed_and_output", _one_relu(fetch_names=["y", "x"]), _lacks("PT012")),
    ("pt013_write_after_write", _fills(False), _has("PT013", var="c")),
    ("pt013_read_between", _fills(True), _lacks("PT013")),
    ("pt014_in_place", _fills(False, inplace=True), _has("PT014", var="c")),
    ("pt015_unread_feed", _unread_feed, _has("PT015", var="unused")),
    ("pt020_dtype_clash", _declared_clash((4,), "int32"), _has("PT020", severity="error")),
    ("pt021_shape_clash", _declared_clash((3,), "float32"), _has("PT021", var="y")),
    ("pt021_dynamic_wildcards", _one_relu((-1, 4)), _lacks("PT021")),
    ("pt022_inference_failure", _bad_reshape, _has("PT022", op_type="reshape")),
    ("pt030_dynamic_non_batch", _dynamic_seq, _has("PT030", var="seq")),
    ("pt031_dynamic_batch", _one_relu((-1, 4)), _has("PT031", var="x")),
    ("pt032_mixed_is_test", _dropouts(True), _has("PT032")),
    ("pt033_no_seed", _dropouts(False), _has("PT033")),
    ("pt033_seeded", _dropouts(False, seed=7), _lacks("PT033")),
    ("pt020_subblock_shadowing", _subblock_shadow_dtype, _has("PT020", block_idx=0)),
    ("empty_fetch_is_no_intent", _two_relus([], second_input="y"), _lacks("PT010")),
    ("clean_program", _one_relu((8, 4), feed_names=["x"], fetch_names=["y"]),
     lambda ds: ds == [] or pytest.fail(str([key(d) for d in ds]))),
    ("sorted_errors_first", _sorted_errors_first, _sorted_check),
    ("buggy_program", _buggy, lambda ds: {"PT001", "PT004", "PT030"} <= codes(ds)
     or pytest.fail(str(codes(ds)))),
]


@pytest.mark.parametrize("build,check", [p[1:] for p in PINS], ids=[p[0] for p in PINS])
def test_pins_equal_jax(build, check):
    _, td = both(build)
    check(td)


def test_collective_is_never_dead_and_unregistered():
    """A collective feeding no fetch is a synchronization point, not dead
    code (no PT010), as in the JAX package. The port has no collective op
    (ROADMAP item 13), so it adds one finding the JAX package has not: PT004
    on that op, which the port could not run."""
    jprog, kw = _collective(fluid)
    want = [key(d) for d in janalysis.verify(jprog, **kw)]
    tprog, _ = _collective(pt)
    got = [key(d) for d in analysis.verify(tprog, **kw)]
    extra = ("PT004", "error", 0, 0, "c_allreduce_sum", None)
    assert got == [extra] + want
    assert "PT010" not in {k[0] for k in got}


# -------------------------------------------------------------- the zoo ----

def _lstm_like(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [12, 16], "float32")
        h = pkg.layers.fc(x, 24, num_flatten_dims=2)
        h = pkg.layers.dynamic_gru(pkg.layers.fc(h, 3 * 8, num_flatten_dims=2), size=8)
        loss = pkg.layers.mean(h)
        pkg.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _zoo_rnn(pkg):
    main, _, loss = _lstm_like(pkg)
    return main, {"feed_names": ["x"], "fetch_names": [loss.name]}


def _zoo_mnist(pkg, startup=False):
    mnist = __import__(f"{pkg.__name__}.models.mnist", fromlist=["conv_net"])
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        img = pkg.data("img", [1, 28, 28], "float32")
        label = pkg.data("label", [1], "int64")
        loss, acc, _ = mnist.conv_net(img, label)
        pkg.optimizer.Adam(0.001).minimize(loss)
    if startup:
        return start, {}
    return main, {"feed_names": ["img", "label"], "fetch_names": [loss.name, acc.name]}


def _zoo_while(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        layers = pkg.layers
        x = pkg.data("x", [8], "float32")
        i = layers.fill_constant([1], "int32", 0)
        limit = layers.fill_constant([1], "int32", 5)
        acc = x * 0.0
        cond = layers.less_than(i, limit)
        w = layers.While(cond, max_iters=5)
        with w.block():
            layers.assign(acc + x, acc)
            i2 = layers.increment(i)
            layers.less_than(i2, limit, cond=cond)
    return main, {"feed_names": ["x"], "fetch_names": [acc.name]}


def _zoo_detection(pkg, startup=False):
    main, start = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, start):
        xm = pkg.data("xm", [8, 8, 8], "float32")
        gt_box = pkg.data("gt_box", [4, 4], "float32")
        gt_label = pkg.data("gt_label", [4], "int32")
        yl = pkg.layers.yolov3_loss(
            x=pkg.layers.conv2d(xm, 3 * (5 + 2), 1), gt_box=gt_box, gt_label=gt_label,
            anchors=[10, 13, 16, 30, 33, 23], anchor_mask=[0, 1, 2], class_num=2,
            ignore_thresh=0.5, downsample_ratio=4)
        loss = pkg.layers.mean(yl)
        pkg.optimizer.SGD(0.01).minimize(loss)
    if startup:
        return start, {}
    return main, {"feed_names": ["xm", "gt_box", "gt_label"], "fetch_names": [loss.name]}


def _fit_a_line(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.data("x", [13], "float32")
        y = pkg.data("y", [1], "float32")
        pred = pkg.layers.fc(x, 1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(pred, y))
        pkg.optimizer.SGD(0.01).minimize(loss)
    return main, startup, loss


def _fit(which):
    def build(pkg):
        main, startup, loss = _fit_a_line(pkg)
        if which == "main":
            return main, {"feed_names": ["x", "y"], "fetch_names": [loss.name]}
        if which == "startup":
            return startup, {"feed_names": ["x", "y"]}
        if which == "for_test":
            return main.clone(for_test=True), {"fetch_names": [loss.name]}
        return main._prune(["x", "y"], [loss.name]), {"fetch_names": [loss.name]}
    return build


ZOO = [("mnist", _zoo_mnist), ("mnist_startup", lambda pkg: _zoo_mnist(pkg, True)),
       ("rnn_scan", _zoo_rnn), ("while_loop", _zoo_while),
       ("detection", _zoo_detection),
       ("detection_startup", lambda pkg: _zoo_detection(pkg, True)),
       ("fit_a_line", _fit("main")), ("fit_a_line_startup", _fit("startup")),
       ("fit_a_line_for_test", _fit("for_test")), ("fit_a_line_pruned", _fit("prune"))]


@pytest.mark.parametrize("build", [z[1] for z in ZOO], ids=[z[0] for z in ZOO])
def test_zoo_programs_verify_clean_and_equal_jax(build):
    _, td = both(build)
    assert errors(td) == [], analysis.format_diagnostics(errors(td))


# ---------------------------------------------------- API and round trips --

def test_diagnostic_carries_creation_stack_and_verify_or_raise():
    p = pt.Program()
    p.global_block().append_op("relu", inputs={"X": ["ghost"]}, outputs={"Out": ["y"]},
                               infer_shape=False)
    d = next(d for d in analysis.verify(p) if d.code == "PT001")
    assert "test_torch_analysis" in d.stack
    with pytest.raises(analysis.VerificationError) as ei:
        analysis.verify_or_raise(p)
    assert "PT001" in str(ei.value) and any(d.code == "PT001" for d in ei.value.diagnostics)
    ok, _ = _one_relu()(pt)
    assert errors(analysis.verify_or_raise(ok, fetch_names=["y"])) == []


def test_pass_subset_unknown_pass_and_registry():
    p, _ = _unregistered(pt)
    only_wf = analysis.verify(p, passes=["wellformed"])
    assert "PT004" in codes(only_wf) and all(d.code.startswith("PT00") for d in only_wf)
    with pytest.raises(KeyError):
        analysis.verify(p, passes=["nonexistent_pass"])
    assert analysis.default_passes() == [n for n in janalysis.default_passes()
                                         if n != "distributed"]
    assert set(analysis.registered_passes()) == \
        set(janalysis.registered_passes()) - {"distributed", "shardplan"}
    assert analysis.CODES == janalysis.CODES
    assert analysis.codes_table() == janalysis.codes_table()
    assert pt.registry.is_registered("relu") and pt.registry.is_registered("relu_grad")
    assert not pt.registry.is_registered("definitely_not_registered")
    assert pt.analysis is analysis


def test_distributed_intent_raises_naming_item_13():
    p, _ = _one_relu()(pt)
    for kw in ({"strategy": object()}, {"auto_shard": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
            analysis.verify(p, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP item 13"):
        analysis.estimate_program_memory(p, strategy=object())
    for name in ("shardplan", "distributed", "strategy_from_dict"):
        with pytest.raises(ImportError, match="ROADMAP item 13"):
            exec(f"from paddle_tpu_torch.analysis import {name}", {})


@pytest.mark.parametrize("build", [_buggy, _zoo_rnn, _zoo_mnist, _zoo_while],
                         ids=["buggy", "rnn_scan", "mnist", "while_loop"])
def test_jax_program_json_read_by_the_port(build):
    """What the port carries across from the JAX package is a program: its
    ``to_json`` read by the port's ``Program.from_json`` gives the same
    findings, and so does the port's own round trip. One difference stays
    (ROADMAP 3.33): the JAX package runs with 64-bit integers off, so its
    DSL declares int32 where the port's (and the reference's) op gives int64
    (mnist's ``top_k`` Indices); on such a var the port reports PT020.
    Decided as a reference-side record: the JAX-built program runs through
    the port's executor with every fetch equal to the JAX run's, those
    indices included (``tests/test_torch_reference_programs.py``), so the
    declaration is the JAX package's and PT020 is a true finding about it."""
    jprog, kw = build(fluid)
    tprog, _ = build(pt)
    truncated = {n for n, v in jprog.global_block().vars.items()
                 if v.dtype == "int32" and n in tprog.global_block().vars
                 and tprog.global_block().vars[n].dtype == "int64"}
    want = [key(d) for d in janalysis.verify(jprog, **kw)]
    back = pt.Program.from_json(jprog.to_json())
    got = [key(d) for d in analysis.verify(back, **kw)]
    assert [k for k in got if not (k[0] == "PT020" and k[5] in truncated)] == want
    assert {k[5] for k in got if k[0] == "PT020"} == truncated
    assert truncated == ({"top_k_0.tmp_1"} if build is _zoo_mnist else set())
    again = pt.Program.from_dict(json.loads(json.dumps(tprog.to_dict())))
    assert [d.key() for d in analysis.verify(again, **kw)] == \
        [d.key() for d in analysis.verify(tprog, **kw)]


def test_bert_base_full_width_findings_and_estimate_equal_jax():
    """BERT-base pretraining at B128 S128 (20 masks a sequence, bf16, dropout
    0.1, Adam): the same 853 ops, the same 28 findings (26 PT014, 2 PT010 on
    the unfetched MLM top_k and accuracy) and a byte-equal estimate."""
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as tbert
    from paddle_tpu_torch.tools.train_profile import (BATCH, LR, MASKS_PER_SEQ, SEED, SEQ,
                                                      build_pretrain)
    jm, _, jt, _ = build_pretrain(jbert.BertConfig(dtype="bfloat16", dropout=0.1), BATCH,
                                  SEQ, MASKS_PER_SEQ, LR, SEED, pkg=fluid, model=jbert)
    tm, _, tt, _ = build_pretrain(tbert.BertConfig(dtype="bfloat16", dropout=0.1), BATCH,
                                  SEQ, MASKS_PER_SEQ, LR, SEED)
    assert len(tm.global_block().ops) == len(jm.global_block().ops) == 853
    jd = janalysis.verify(jm, fetch_names=[jt.name])
    td = analysis.verify(tm, fetch_names=[tt.name])
    assert [key(d) for d in td] == [key(d) for d in jd]
    assert len(td) == 28 and sorted(codes(td)) == ["PT010", "PT014"]
    assert sum(d.code == "PT014" for d in td) == 26
    assert {d.op_type for d in td if d.code == "PT010"} == {"top_k", "accuracy"}
    je = janalysis.estimate_program_memory(jm, fetch_names=[jt.name])
    te = analysis.estimate_program_memory(tm, fetch_names=[tt.name])
    assert (te.peak_bytes, te.arg_bytes, te.temp_bytes, te.peak_op_idx, te.peak_op_type) == \
        (je.peak_bytes, je.arg_bytes, je.temp_bytes, je.peak_op_idx, je.peak_op_type)
    assert te.top == je.top and te.summary() == je.summary()
    assert analysis.format_bytes(te.peak_bytes) == "15.72 GB"
    assert analysis.format_bytes(te.arg_bytes) == "1.15 GB"


def _transformer_base(pkg):
    from paddle_tpu_torch.tools.train_profile import NMT_SEQ, build_transformer
    model = __import__(f"{pkg.__name__}.models.transformer", fromlist=["x"])
    cfg = model.TransformerConfig(src_vocab=32000, trg_vocab=32000, hidden=512, n_layers=6,
                                  n_heads=8, ffn_hidden=2048, dropout=0.1)
    main, _, loss, *_ = build_transformer(cfg, 64, NMT_SEQ, pkg=pkg, model=model)
    return main, {"fetch_names": [loss.name]}


def _crnn_ctc(pkg):
    from paddle_tpu_torch.tools import ocr
    t = ocr.build_crnn_ctc(pkg, ocr.CRNN)
    return t.main, {"fetch_names": [t.loss.name]}


def _yolov3_608(pkg):
    yolov3 = __import__(f"{pkg.__name__}.models.yolov3", fromlist=["x"])
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = 0
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.data("img", [3, 608, 608], "float32")
        gt_box = pkg.data("gt_box", [50, 4], "float32")
        gt_label = pkg.data("gt_label", [50], "int32")
        loss = yolov3.yolov3(img, gt_box, gt_label, num_classes=80)
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, {"fetch_names": [loss.name]}


def _deepfm_4096(pkg):
    deepfm = __import__(f"{pkg.__name__}.models.deepfm", fromlist=["x"])
    main, startup = pkg.Program(), pkg.Program()
    with pkg.unique_name.guard(), pkg.program_guard(main, startup):
        ids = pkg.data("ids", [4096, 26], "int64", append_batch_size=False)
        dense = pkg.data("dense", [4096, 13], "float32", append_batch_size=False)
        label = pkg.data("label", [4096, 1], "int64", append_batch_size=False)
        loss, auc, _ = deepfm.deepfm(ids, dense, label, num_fields=26,
                                     vocab_size=1000000, embed_dim=16)
        pkg.optimizer.Adam(1e-3).minimize(loss)
    return main, {"fetch_names": [loss.name, auc.name]}


@pytest.mark.parametrize("build", [_transformer_base, _crnn_ctc, _yolov3_608, _deepfm_4096],
                         ids=["transformer_base", "crnn_ctc", "yolov3_608", "deepfm"])
def test_full_width_programs_verify_clean_and_equal_jax(build):
    """More of the port's programs at full width (no weights are made):
    transformer-base, CRNN-CTC, YOLOv3 at 608 x 608 with 80 classes, DeepFM
    at B 4096 over 1 M rows; zero errors, the JAX package's findings."""
    _, td = both(build)
    assert errors(td) == [], analysis.format_diagnostics(errors(td))


# ------------------------------------------------------------------- CLI ----

def test_cli_selftest():
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.analysis", "--selftest"],
                       cwd=REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "selftest: OK" in r.stdout


def _run_cli(fn, argv, capsys):
    rc = fn(argv)
    return rc, capsys.readouterr().out


def _strip_stack(doc):
    for f in doc["findings"]:
        f.pop("stack")
    return doc


@pytest.mark.parametrize("build,extra", [
    (_relu_of("ghost", data="x"), []),
    (_one_relu((8, 4)), ["--fetch", "y", "--feed", "x"]),
    (_one_relu((8, 4)), []),
    (_fills(False), ["--fetch", "c", "--fail-on", "warn"]),
    (_fills(False), ["--fetch", "c", "--fail-on", "never"]),
    (_one_relu((-1, 256)), ["--feed", "x", "--fetch", "y", "--batch", "4",
                            "--mem-budget", "1K"]),
    (_one_relu((-1, 256)), ["--feed", "x", "--fetch", "y", "--mem-budget", "1G"]),
    (_zoo_rnn, ["--fetch", "mean_0.tmp_0", "--feed", "x", "--passes", "dataflow,recompile"]),
], ids=["pt001", "clean", "info_only", "waw_fail_on_warn", "never", "budget_over",
        "budget_ok_assumed_batch", "rnn_pass_subset"])
def test_cli_json_text_and_exit_codes_equal_jax(tmp_path, capsys, build, extra):
    """The port's CLI on the JAX program's JSON file: the same exit code, the
    same JSON document (creation stacks aside) and the same text (with
    ``--no-stack``) as the JAX CLI."""
    jprog, _ = build(fluid)
    f = tmp_path / "prog.json"
    f.write_text(jprog.to_json())
    for fmt in (["--format", "json"], ["--no-stack"]):
        jrc, jout = _run_cli(jcli, [str(f)] + extra + fmt, capsys)
        trc, tout = _run_cli(cli, [str(f)] + extra + fmt, capsys)
        assert trc == jrc
        if fmt[0] == "--format":
            assert _strip_stack(json.loads(tout)) == _strip_stack(json.loads(jout))
        else:
            assert tout == jout


def test_cli_codes_bad_input_item_13_and_baseline(tmp_path, capsys):
    rc, out = _run_cli(cli, ["--codes"], capsys)
    assert rc == 0 and out == _run_cli(jcli, ["--codes"], capsys)[1]
    assert _run_cli(cli, [], capsys)[0] == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert _run_cli(cli, [str(bad)], capsys)[0] == 2
    p, _ = _buggy(pt)
    f = tmp_path / "prog.json"
    f.write_text(p.to_json())
    strat = tmp_path / "strat.json"
    strat.write_text(json.dumps({"mesh_shape": {"dp": 8}}))
    for argv in ([str(f), "--strategy", str(strat)], [str(f), "--auto-shard"]):
        rc, out = _run_cli(cli, argv, capsys)
        assert rc == 2 and "ROADMAP item 13" in out
    base = tmp_path / "accepted.keys"
    assert _run_cli(cli, [str(f), "--baseline", str(base), "--update-baseline"],
                    capsys)[0] == 0
    rc, out = _run_cli(cli, [str(f), "--baseline", str(base)], capsys)
    assert rc == 0 and "suppressed" in out
    # a baseline the JAX CLI wrote reads in the port's: the same bytes where
    # the messages are the same (PT004's names the port's ops directory)
    p, _ = _sorted_errors_first(pt)
    f.write_text(p.to_json())
    for fn, path in ((cli, base), (jcli, tmp_path / "jax.keys")):
        _run_cli(fn, [str(f), "--baseline", str(path), "--update-baseline"], capsys)
    assert (tmp_path / "jax.keys").read_bytes() == base.read_bytes()
    p.global_block().append_op("relu", inputs={"X": ["ghost2"]}, outputs={"Out": ["q"]},
                               infer_shape=False)
    f.write_text(p.to_json())
    rc, out = _run_cli(cli, [str(f), "--baseline", str(tmp_path / "jax.keys")], capsys)
    assert rc == 1 and "ghost2" in out and "'ghost' is" not in out
    base.write_text("{not json\n")
    rc, out = _run_cli(cli, [str(f), "--baseline", str(base)], capsys)
    assert rc == 2 and "baseline" in out


# ---------------------------------------------------------------- PT060 ----

def test_pt060_names_the_op_holding_the_copy_time(monkeypatch):
    """PT060 over the port's attribution of a CPU run. The program makes its
    copy kernels on purpose: a wide ``cast`` (``aten::_to_copy`` and
    ``aten::copy_`` on the CPU, the ``copy`` category) between two cheap
    ops; the finding names that op, which the attribution holds."""
    from paddle_tpu_torch.observability import attribution
    monkeypatch.setenv("PADDLE_TPU_OBS_ATTRIB", "1")
    main, startup = pt.Program(), pt.Program()
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [1024, 1024], "float32", append_batch_size=False)
        wide = pt.layers.cast(pt.layers.relu(x), "float64")
        out = pt.layers.reduce_sum(wide)
    assert analysis.verify(main, passes=["layout_churn"]) == []   # nothing attributed yet
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(main, feed={"x": np.ones((1024, 1024), "float32")}, fetch_list=[out])
    attrib = attribution.lookup_program(main)
    assert attrib is not None
    diags = analysis.verify(main, passes=["layout_churn"])
    assert diags, attrib.summary_lines()
    for d in diags:
        assert d.code == "PT060" and d.severity == "warn" and "device time" in d.message
        ir = attribution.ir_key(d.op_type, d.block_idx, d.op_idx)
        assert ir in attrib.per_ir
        assert main.global_block().ops[d.op_idx].type == d.op_type
    assert diags[0].op_type == "cast"
