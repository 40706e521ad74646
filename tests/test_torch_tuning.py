"""The port's autotuner (``paddle_tpu_torch/tuning/``) against the JAX
package's (``paddle_tpu/tuning/``): the shape buckets of every ported
choice point, ``decide()`` under each ``PADDLE_TPU_TUNE`` mode, the
decision cache's file, ``tune_program``'s walk of a tiny BERT and a tiny
ResNet built by each package's DSL, the executor's decision-state key and
``fuse_steps=0``'s in-loop search, and the CLI.

Buckets, keys' bucket parts, decisions and walks are compared exactly. The
candidates are each package's own routes (JAX: Pallas / XLA; the port: its
CUDA kernels / the PyTorch chains they replace), so they are compared by
kind, and every default is held to the port's route before the autotuner.
``fuse_steps=0`` is held bit for bit (``torch.equal``) to the fixed-K epoch
at the K it picked: both run the same lowerings on the same batches.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import tuning as jtuning
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import resnet as jres
from paddle_tpu.contrib import fuse_conv_bn_stats as jfuse
from paddle_tpu.tuning import cache as jcache
from paddle_tpu.tuning import measure as jmeasure
import paddle_tpu_torch as pt
from paddle_tpu_torch import tuning
from paddle_tpu_torch.contrib import fuse_conv_bn_stats as tfuse
from paddle_tpu_torch.core import executor as ex
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import resnet as tres
from paddle_tpu_torch.resilience import StepGuardian
from paddle_tpu_torch.tuning import cache as tcache
from paddle_tpu_torch.tuning import choices as tchoices
from paddle_tpu_torch.tuning import measure as tmeasure
from tests import test_torch_dataset as tds
from tests import test_torch_resnet as trn
from tests.test_torch_framework import build_encoder
from tests.test_torch_graph_step import stand_in  # noqa: F401  (the fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CONVBN = {"m": 896, "k": 64, "n": 128, "dtype": "float32"}
FLASH = {"b": 2, "h": 2, "s": 2048, "d": 64, "dtype": "bfloat16", "has_bias": True,
         "dropout": 0.1, "causal": False}
CONV = {"x_shape": (3, 3, 8, 8), "w_shape": (4, 3, 3, 3), "strides": (1, 1), "pads": [1, 1],
        "dils": (1, 1), "groups": 1, "fmt": "NCHW", "dtype": "float32"}
FUSE = {"feed": [["x", [32, 8], "float32"]], "fetches": 2}
PARAMS = {"conv2d_bn_fused.backend": [CONVBN, dict(CONVBN, m=1000, dtype="bfloat16")],
          "fused_attention.backend": [FLASH, dict(FLASH, b=3, s=128, has_bias=False)],
          "fused_attention.block_sizes": [FLASH, dict(FLASH, dtype="float32", causal=True)],
          "conv2d.layout": [CONV, dict(CONV, x_shape=(5, 8, 8, 3), fmt="NHWC")],
          "fuse_steps.k": [FUSE]}


@pytest.fixture()
def caches(tmp_path, monkeypatch):
    """Each package's global decision cache on a temp file of its own."""
    old_t, old_j = tcache.CACHE, jcache.CACHE
    t = tcache.reset_for_tests(str(tmp_path / "port.json"))
    j = jcache.reset_for_tests(str(tmp_path / "jax.json"))
    monkeypatch.delenv("PADDLE_TPU_TUNE", raising=False)
    yield t, j
    tcache.CACHE, jcache.CACHE = old_t, old_j


def _fake_timer(table, calls):
    """time_callable stand-in: the first fragment of ``table`` found in the
    candidate function's name gives its run_ms; every call is recorded."""
    def fake(fn, args, warmup=None, iters=None):
        name = getattr(fn, "__name__", "")
        ms = next((v for k, v in table.items() if k in name), 1.0)
        calls.append(name)
        return {"compile_ms": 1.0, "run_ms": ms, "runs_ms": [ms]}
    return fake


# -------------------------------------------------------------- choice points


@pytest.mark.parametrize("choice_id", sorted(PARAMS))
def test_buckets_equal_jax(choice_id):
    j, t = jtuning.get_choice(choice_id), tuning.get_choice(choice_id)
    for params in PARAMS[choice_id]:
        assert t.bucket(params) == j.bucket(params)
        # the key: choice id, bucket and dtype as the JAX key, then the card and versions
        assert t.key(params).split("|")[:3] == j.key(params).split("|")[:3]
        assert t.key(params).split("|")[3:] == [tchoices.device_kind(), tchoices.versions()]


def test_candidates_are_the_ports_routes_and_defaults_its_old_ones():
    g = tuning.get_choice
    assert g("conv2d_bn_fused.backend").candidates(CONVBN) == ["unfused", "kernel"]
    assert g("conv2d_bn_fused.backend").default(CONVBN) == "kernel"
    # the JAX gate (M % BM, N % 128) is not copied: the kernel takes any shape
    odd = dict(CONVBN, m=897, n=65)
    assert jtuning.get_choice("conv2d_bn_fused.backend").candidates(odd) == ["xla"]
    assert g("conv2d_bn_fused.backend").default(odd) == "kernel"
    assert g("fused_attention.backend").candidates(FLASH) == ["composed", "kernel"]
    assert g("fused_attention.backend").default(FLASH) == "kernel"
    # no S crossover: the kernels at S 128 too; a head width they lack: composed
    assert g("fused_attention.backend").default(dict(FLASH, s=128)) == "kernel"
    assert g("fused_attention.backend").candidates(dict(FLASH, d=48)) == ["composed"]
    bs = g("fused_attention.block_sizes")
    assert bs.candidates(FLASH) == [(128, 64), (64, 64)] and bs.default(FLASH) == (128, 64)
    assert bs.candidates(dict(FLASH, dtype="float32")) == [(128, 64)]
    assert bs.decode(bs.encode((64, 64))) == (64, 64)
    assert g("conv2d.layout").default(CONV) == "NCHW"
    assert g("conv2d.layout").candidates(CONV) == jtuning.get_choice("conv2d.layout").candidates(CONV)
    assert g("fuse_steps.k").candidates(FUSE) == jtuning.get_choice("fuse_steps.k").candidates(FUSE)
    assert g("fuse_steps.k").default(FUSE) == 1
    assert set(PARAMS) <= set(tuning.list_choices())
    # comm.compress is the data-parallel slice's (ROADMAP item 13 (a)), as the
    # JAX one; the auto-sharding planner's shardplan.plan is item 13 (c)'s
    comm = {"nbytes": 1 << 20, "dtype": "float32", "world": 2, "mode": "int8",
            "min_bytes": 65536}
    for p in (comm, dict(comm, nbytes=1024), dict(comm, world=1)):
        assert g("comm.compress").candidates(p) == \
            jtuning.get_choice("comm.compress").candidates(p)
        assert g("comm.compress").default(p) == jtuning.get_choice("comm.compress").default(p)
    assert "shardplan.plan" not in set(tuning.list_choices())


def test_on_the_card_only_hand_written_routes_are_candidates(caches, monkeypatch):
    """With a card, the backend choices offer the kernels alone, so a
    decision persisted for the plain chain (by a CPU search, or a stale
    file) answers the kernel; the tile and layout choices keep theirs."""
    t_cache, _ = caches
    monkeypatch.setattr(tchoices, "on_card", lambda: True)
    g = tuning.get_choice
    assert g("conv2d_bn_fused.backend").candidates(CONVBN) == ["kernel"]
    assert g("fused_attention.backend").candidates(FLASH) == ["kernel"]
    assert g("fused_attention.block_sizes").candidates(FLASH) == [(128, 64), (64, 64)]
    assert g("conv2d.layout").candidates(CONV) == ["NCHW", "NHWC"]
    for cid, params, plain in (("conv2d_bn_fused.backend", CONVBN, "unfused"),
                               ("fused_attention.backend", FLASH, "composed")):
        t_cache.put(g(cid).key(params), {"winner": plain, "measured": True, "timings": {}},
                    persist=False)
        assert tuning.decide(cid, params) == "kernel"


def test_pow2_bucket_equals_jax():
    for n in (0, 1, 2, 3, 24, 32, 33, 1000):
        assert tchoices.pow2_bucket(n) == jtuning.choices.pow2_bucket(n)


# -------------------------------------------------------------------- decide()


class _Stub:
    """A choice point registered in both packages: candidates a, b, c with
    fake timings by name, default b."""
    id = "test.stub"
    doc = "stub"

    def bucket(self, params):
        return {"n": tchoices.pow2_bucket(params["n"])}

    def candidates(self, params):
        return ["a", "b", "c"]

    def default(self, params):
        return "b"

    def bench(self, params, cand):
        fn = {"a": lambda: None, "b": lambda: None, "c": lambda: None}[cand]
        fn.__name__ = f"stub_{cand}"
        return fn, ()


@pytest.fixture()
def stub_choice():
    """``_Stub`` registered in both packages for one test, then removed."""
    for mod in (tchoices, jtuning.choices):
        mod.register_choice(type("Stub", (_Stub, mod.TunableChoice), {})())
    yield
    for mod in (tchoices, jtuning.choices):
        mod._CHOICES.pop("test.stub", None)


@pytest.mark.parametrize("mode", ["off", "cached", "search"])
def test_decide_under_each_mode_equals_jax(caches, monkeypatch, stub_choice, mode):
    t_cache, j_cache = caches
    table = {"stub_a": 3.0, "stub_b": 2.0, "stub_c": 1.0}
    tcalls, jcalls = [], []
    monkeypatch.setattr(tmeasure, "time_callable", _fake_timer(table, tcalls))
    monkeypatch.setattr(jmeasure, "time_callable", _fake_timer(table, jcalls))
    monkeypatch.setenv("PADDLE_TPU_TUNE", mode)
    got = [(tuning.decide("test.stub", {"n": n}), jtuning.decide("test.stub", {"n": n}))
           for n in (3, 4, 5)]
    want = {"off": "b", "cached": "b", "search": "c"}[mode]
    assert got == [(want, want)] * 3
    # a search measures each candidate once for the bucket {n: 4}; 3, 4 share it,
    # 5 is bucket 8
    n_calls = {"off": 0, "cached": 0, "search": 6}[mode]
    assert len(tcalls) == len(jcalls) == n_calls
    if mode == "search":
        key = tuning.get_choice("test.stub").key({"n": 4})
        rec, jrec = t_cache.get(key), j_cache.get(jtuning.get_choice("test.stub").key({"n": 4}))
        assert rec["winner"] == jrec["winner"] == "c" and rec["measured"] is jrec["measured"]
        assert rec["timings"] == jrec["timings"]
        # cached mode now answers the search's winner without measuring
        monkeypatch.setenv("PADDLE_TPU_TUNE", "cached")
        assert tuning.decide("test.stub", {"n": 3}) == "c" and len(tcalls) == 6
    else:
        assert not os.path.exists(t_cache.path)


def test_a_failing_candidate_raises_and_caches_nothing(caches, monkeypatch, stub_choice):
    """A candidate whose build or run raises stops the search: no other
    candidate wins in its place, nothing is cached, the journal says which
    failed, and the CLI exits 1."""
    t_cache, _ = caches
    from paddle_tpu_torch.observability import journal
    ch = tuning.get_choice("test.stub")
    real_bench = ch.bench

    def bench(params, cand):
        if cand == "b":
            raise RuntimeError("kernel did not build")
        return real_bench(params, cand)
    monkeypatch.setattr(ch, "bench", bench)
    monkeypatch.setattr(tmeasure, "time_callable", _fake_timer({"stub_a": 1.0}, []))
    with pytest.raises(tmeasure.CandidateFailed, match="'b' of test.stub.*did not build"):
        tuning.decide("test.stub", {"n": 3}, mode="search")
    assert t_cache.get(ch.key({"n": 3})) is None and not os.path.exists(t_cache.path)
    assert journal.recent(event="autotune")[-1]["failed"] == "b"

    def launch_fails(fn, args, warmup=None, iters=None):
        raise RuntimeError("kernel launch failed with CUDA error 700")
    monkeypatch.setattr(tmeasure, "time_callable", launch_fails)
    with pytest.raises(tmeasure.CandidateFailed, match="'a' of test.stub.*launch failed"):
        tuning.decide("test.stub", {"n": 3}, mode="search")
    from paddle_tpu_torch.tuning import __main__ as cli
    monkeypatch.setattr(tuning, "RESNET_CONV_BN_SHAPES", ((64, 8, 16),))
    assert cli.main(["--suite", "resnet", "--cache", t_cache.path]) == 1


def test_an_unfused_decision_changes_the_cpu_route_not_the_result(caches, monkeypatch):
    """On the CPU, conv2d_bn_fused's train-mode op takes the unfused chain
    when the decision says so: the same values as the kernel's plain
    version (f32 ``atol 1e-5``: the two sum the product in other orders)."""
    t_cache, _ = caches
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.ops import conv_bn
    rng = np.random.RandomState(0)
    ins = {"Input": [torch.tensor(rng.randn(2, 4, 4, 8).astype("float32"))],
           "Filter": [torch.tensor(rng.randn(16, 8, 1, 1).astype("float32"))],
           "Scale": [torch.ones(16)], "Bias": [torch.zeros(16)],
           "Mean": [torch.zeros(16)], "Variance": [torch.ones(16)]}
    used = []
    real = conv_bn.unfused_conv1x1_stats
    monkeypatch.setattr(conv_bn, "unfused_conv1x1_stats", lambda *a: used.append(1) or real(*a))
    op = registry.get("conv2d_bn_fused")
    outs = [op.lower(registry.LowerCtx({}), ins)]
    ch = tuning.get_choice("conv2d_bn_fused.backend")
    t_cache.put(ch.key({"m": 32, "k": 8, "n": 16, "dtype": "float32"}),
                {"winner": "unfused", "measured": True, "timings": {}}, persist=False)
    outs.append(op.lower(registry.LowerCtx({}), ins))
    assert used == [1]
    for name in outs[0]:
        np.testing.assert_allclose(outs[1][name][0].numpy(), outs[0][name][0].numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_a_stale_decision_answers_the_default(caches, monkeypatch):
    t_cache, _ = caches
    ch = tuning.get_choice("fused_attention.block_sizes")
    t_cache.put(ch.key(FLASH), {"winner": "256,2048", "measured": True, "timings": {}},
                persist=False)
    assert tuning.decide("fused_attention.block_sizes", FLASH) == (128, 64)


def test_no_search_inside_a_capture(caches, monkeypatch):
    """A search that would run while the stream captures a CUDA graph
    raises; a decision already made is a lookup and does not."""
    t_cache, _ = caches
    monkeypatch.setattr(tchoices, "_capturing", lambda: True)
    monkeypatch.setattr(tmeasure, "time_callable", _fake_timer({}, []))
    with pytest.raises(RuntimeError, match="capturing a CUDA graph"):
        tuning.decide("conv2d.layout", CONV, mode="search")
    ch = tuning.get_choice("conv2d.layout")
    t_cache.put(ch.key(CONV), {"winner": "NHWC", "measured": True, "timings": {}},
                persist=False)
    assert tuning.decide("conv2d.layout", CONV, mode="search") == "NHWC"


def test_time_callable_times_a_cpu_candidate():
    t = tmeasure.time_callable(lambda x: x + 1, (torch.ones(4),), warmup=2, iters=3)
    assert sorted(t) == ["compile_ms", "run_ms", "runs_ms"] and len(t["runs_ms"]) == 3
    assert t["run_ms"] == sorted(t["runs_ms"])[1] >= 0


# ------------------------------------------------------------- the cache file


def test_cache_files_equal_jax_and_write_atomically(tmp_path):
    """Both packages persist one decision to a file of their own: the same
    format version and layout, no temp file left behind, and a foreign
    format version ignored by both."""
    docs = {}
    for name, mod in (("port", tcache), ("jax", jcache)):
        d = tmp_path / name
        d.mkdir()
        c = mod.DecisionCache(str(d / "autotune.json"))
        c.put("k1", {"winner": "a", "timings": {}})
        c.put("k2", {"winner": "b", "timings": {}})
        assert [p.name for p in d.iterdir()] == ["autotune.json"]
        docs[name] = json.load(open(d / "autotune.json"))
        again = mod.DecisionCache(str(d / "autotune.json"))
        assert again.get("k2")["winner"] == "b"
    assert docs["port"]["format_version"] == docs["jax"]["format_version"] \
        == tcache.FORMAT_VERSION
    assert docs["port"]["decisions"] == docs["jax"]["decisions"]
    for name, mod in (("port", tcache), ("jax", jcache)):
        path = tmp_path / f"{name}_foreign.json"
        json.dump({"format_version": 999, "decisions": {"k": {"winner": "x"}}}, open(path, "w"))
        with pytest.warns(UserWarning, match="format version"):
            assert mod.DecisionCache(str(path)).get("k") is None


def test_the_default_file_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("PADDLE_TPU_TUNE_CACHE", raising=False)
    assert tcache.cache_path().endswith(os.path.join(".cache", "paddle_tpu_torch",
                                                     "autotune.json"))
    assert tcache.cache_path() != jcache.cache_path()


# --------------------------------------------------------------- tune_program


def _walk_keys(entries):
    return sorted((e["choice"], "|".join(e["key"].split("|")[1:3])) for e in entries)


def _tiny_resnet(pkg, res, fuse_fn):
    main, _, _, _, _ = trn._build(pkg, res, fuse_fn)
    return main


@pytest.mark.parametrize("model", ["bert-f32", "bert-bf16", "resnet"])
def test_tune_program_finds_the_choice_points_jax_finds(caches, monkeypatch, model):
    if model == "resnet":
        monkeypatch.setitem(jres._DEPTHS, 50, [1, 1, 1, 1])
        monkeypatch.setitem(tres._DEPTHS, 50, [1, 1, 1, 1])
        jm, tm = _tiny_resnet(fluid, jres, jfuse), _tiny_resnet(pt, tres, tfuse)
    else:
        dtype = model.split("-")[1]
        jm, tm = build_encoder(fluid, jbert, dtype)[0], build_encoder(pt, tbert, dtype)[0]
    j = jtuning.tune_program(jm, batch=4, mode="off")
    t = tuning.tune_program(tm, batch=4, mode="off")
    # the tile is a choice wherever the port's kernels take the call; JAX asks
    # for it only where its Pallas kernel is legal (S % 128, a TPU for dropout)
    tile = "fused_attention.block_sizes"
    assert _walk_keys([e for e in t if e["choice"] != tile]) == \
        _walk_keys([e for e in j if e["choice"] != tile]) and t
    assert set(_walk_keys([e for e in j if e["choice"] == tile])) <= set(_walk_keys(t))
    assert [k[1] for k in _walk_keys(e for e in t if e["choice"] == tile)] == \
        [k[1] for k in _walk_keys(e for e in t if e["choice"] == "fused_attention.backend")]
    kinds = {e["choice"] for e in t}
    assert kinds == ({"conv2d.layout", "conv2d_bn_fused.backend"} if model == "resnet"
                     else {"fused_attention.backend", "fused_attention.block_sizes"})
    assert all(e["source"] == "default" for e in t)


def test_tune_program_search_persists_what_a_run_finds(caches, monkeypatch):
    """A search over the tiny conv program persists the conv2d.layout
    decision under the key the lowering derives when the program runs."""
    t_cache, _ = caches
    calls = []
    monkeypatch.setattr(tmeasure, "time_callable",
                        _fake_timer({"fn": 1.0}, calls))
    main, startup, loss = _conv_program()
    entries = tuning.tune_program(main, batch=2, mode="search")
    assert [e["choice"] for e in entries] == ["conv2d.layout"] and len(calls) == 2
    monkeypatch.setenv("PADDLE_TPU_TUNE", "cached")
    monkeypatch.setattr(tmeasure, "time_callable", _boom)
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        exe.run(main, feed=_conv_feed(), fetch_list=[loss])
    assert json.load(open(t_cache.path))["decisions"]


# -------------------------------------------------- the lowerings and the executor


def _boom(*a, **k):
    raise AssertionError("measured outside search mode")


def _conv_program():
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 0
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        img = pt.data("img", [3, 8, 8], "float32")
        conv = pt.layers.conv2d(img, num_filters=4, filter_size=3, act="relu")
        loss = pt.layers.reduce_mean(conv)
    return main, startup, loss


def _conv_feed():
    return {"img": np.random.RandomState(0).rand(2, 3, 8, 8).astype("float32")}


@pytest.mark.parametrize("mode", [None, "off"])
def test_cached_and_off_modes_never_measure(caches, monkeypatch, mode):
    t_cache, _ = caches
    if mode is not None:
        monkeypatch.setenv("PADDLE_TPU_TUNE", mode)
    monkeypatch.setattr(tmeasure, "time_callable", _boom)
    main, startup, loss = _conv_program()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed=_conv_feed(), fetch_list=[loss])
    assert not os.path.exists(t_cache.path)


def test_a_layout_decision_changes_the_route_not_the_result(caches, monkeypatch):
    """conv2d under a forced NHWC decision (channels-last) against the
    declared NCHW: the same values (f32 ``atol 1e-6``: cuDNN / oneDNN may
    sum in another order)."""
    t_cache, _ = caches
    from paddle_tpu_torch.ops import nn_ops
    used = []
    real = nn_ops.conv_in_layout
    monkeypatch.setattr(nn_ops, "conv_in_layout",
                        lambda *a: used.append(a[-1]) or real(*a))
    main, startup, loss = _conv_program()
    exe = pt.Executor(pt.CPUPlace())
    outs = []
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        outs.append(exe.run(main, feed=_conv_feed(), fetch_list=[loss])[0])
        params = dict(CONV, x_shape=(2, 3, 8, 8), pads=[0, 0])
        ch = tuning.get_choice("conv2d.layout")
        t_cache.put(ch.key(params), {"winner": "NHWC", "measured": True, "timings": {}},
                    persist=False)
        outs.append(exe.run(main, feed=_conv_feed(), fetch_list=[loss])[0])
    assert used[0] == "NCHW" and used[-1] == "NHWC"
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-6, rtol=1e-6)


def test_a_search_in_the_warm_up_is_captured_once_and_a_new_decision_recaptures(
        caches, monkeypatch, stand_in):
    """On the stand-in graph: the warm-up run searches the conv layout, the
    entry moves to the new decision token, the next run captures it (one
    capture, one cache entry) and the later ones replay; a decision that
    changes afterwards gives a new key, so the step is captured again."""
    t_cache, _ = caches
    monkeypatch.setenv("PADDLE_TPU_TUNE", "search")
    calls = []
    monkeypatch.setattr(tmeasure, "time_callable", _fake_timer({"fn": 1.0}, calls))
    main, startup, loss = _conv_program()
    exe = pt.Executor(pt.CPUPlace())
    with pt.scope_guard(pt.Scope()):
        exe._use_graphs = False
        exe.run(startup)
        exe._use_graphs = True
        outs = [exe.run(main, feed=_conv_feed(), fetch_list=[loss])[0] for _ in range(4)]
        # the startup's eager run is an entry of its own, refused capture
        mains = lambda: [k for k in exe._cache if k[0] == id(main)]  # noqa: E731
        assert len(calls) == 2 and stand_in.captures == 1 and len(mains()) == 1
        key = mains()[0]
        assert key[-1] == tcache.state_token()
        t_cache.put("other", {"winner": "x"}, persist=False)   # the token moves
        exe.run(main, feed=_conv_feed(), fetch_list=[loss])
        exe.run(main, feed=_conv_feed(), fetch_list=[loss])
        assert stand_in.captures == 2 and len(mains()) == 2
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])


# ------------------------------------------------------------- fuse_steps = 0


@pytest.fixture(scope="module")
def twelve_batches(tmp_path_factory):
    return tds._write_parts(str(tmp_path_factory.mktemp("tune_parts")), rows=(128, 128, 128))


@pytest.fixture(scope="module")
def tiny_deepfm():
    tm, ts, tuv, tl, ta, _ = tds._build(pt, tds.tdeepfm)
    scope = pt.Scope()
    with pt.scope_guard(scope):
        pt.Executor(pt.CPUPlace()).run(ts)
    init = {n: scope.find_var(n).clone() for n in tds._persistables(tm)}
    return tm, tuv, tl, ta, init


def _epoch(tiny, parts, fuse_steps, guarded=False):
    tm, tuv, tl, ta, init = tiny
    scope = pt.Scope()
    for n, t in init.items():
        scope.set_var(n, t.clone())
    tm._rng_run_counter = 0
    with pt.scope_guard(scope):
        exe = pt.Executor(pt.CPUPlace())
        ds = tds._dataset(pt, "QueueDataset", tuv, parts)
        if guarded:
            StepGuardian(exe, tm).train_from_dataset(dataset=ds, fetch_list=[tl, ta],
                                                     fuse_steps=fuse_steps)
        else:
            exe.train_from_dataset(tm, ds, fetch_list=[tl, ta], fuse_steps=fuse_steps)
    assert tm._rng_run_counter == 12
    return {n: scope.find_var(n).clone() for n in init}


def test_fuse_steps_zero_searches_in_the_loop_and_equals_the_fixed_k_epoch(
        caches, monkeypatch, tiny_deepfm, twelve_batches):
    """``fuse_steps=0`` under search: after two single steps (the warm-up and
    the capture on the card), K 1 and 2 are timed on the epoch's own
    batches (3 calls each), K 4 runs out of batches, the winner persists,
    and the parameters equal the ``fuse_steps=K`` epoch's bit for bit; the
    guardian then reads the decision (it never searches) and gives the same
    parameters too."""
    t_cache, _ = caches
    monkeypatch.setenv("PADDLE_TPU_TUNE", "search")
    searched = _epoch(tiny_deepfm, twelve_batches, 0)
    recs = [r for r in json.load(open(t_cache.path))["decisions"].values()
            if r["choice"] == "fuse_steps.k"]
    assert len(recs) == 1 and recs[0]["measured"] is True
    assert sorted(recs[0]["timings"]) == ["1", "2"]
    assert all(len(t["runs_ms"]) == ex.Executor._FUSE_SEARCH_PROBES
               for t in recs[0]["timings"].values())
    k = int(recs[0]["winner"])
    fixed = _epoch(tiny_deepfm, twelve_batches, k)
    tds._assert_bit_equal(searched, fixed)
    monkeypatch.setattr(tmeasure, "time_callable", _boom)
    guarded = _epoch(tiny_deepfm, twelve_batches, 0, guarded=True)
    tds._assert_bit_equal(guarded, fixed)


def test_fuse_steps_zero_takes_a_cached_k(caches, monkeypatch, tiny_deepfm, twelve_batches):
    """A cached ``fuse_steps.k`` decision: the epoch runs at it, as the
    ``fuse_steps=K`` epoch (K 4 over 12 batches: 3 ``run_fused`` calls)."""
    t_cache, _ = caches
    tm, tuv, tl, ta, _ = tiny_deepfm
    first = next(iter(tds._dataset(pt, "QueueDataset", tuv, twelve_batches)._iter_batches()))
    params = ex.Executor(pt.CPUPlace())._fuse_params(first, ["a", "b"])
    jparams = fluid.Executor()._fuse_params(first, ["a", "b"])
    assert params == jparams
    tuning.record_decision("fuse_steps.k", params, 4, timings={})
    fused = []
    real = ex.Executor.run_fused
    monkeypatch.setattr(ex.Executor, "run_fused",
                        lambda self, *a, **k: fused.append(1) or real(self, *a, **k))
    got = _epoch(tiny_deepfm, twelve_batches, 0)
    assert len(fused) == 3
    tds._assert_bit_equal(got, _epoch(tiny_deepfm, twelve_batches, 4))


# --------------------------------------------------------------------- the CLI


def test_selftest_cli():
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tuning", "--selftest"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "selftest ok" in r.stdout


def test_cli_reports_the_cache(tmp_path):
    path = tmp_path / "c.json"
    c = tcache.DecisionCache(str(path))
    c.put("conv2d.layout|{}|float32|cpu|v", {"choice": "conv2d.layout", "winner": "NHWC",
                                              "measured": True, "timings": {}})
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.tuning", "--cache", str(path),
                        "--format", "json"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    doc = json.loads(r.stdout)
    assert [d["winner"] for d in doc["decisions"]] == ["NHWC"]
