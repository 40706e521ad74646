"""The port's warm store (``paddle_tpu_torch/warmstore/``), on the JAX
package's cases of ``tests/test_warmstore.py``.

On the card a store entry holds what a restart can reuse of a step: its
kernel libraries (tier A, the ``nvcc`` output) and its record (tier B: the
kernels it launched and its capture's parts). A hit cannot skip the
verifier gate, which runs before the store is consulted, nor the step's
warm-up and its CUDA-graph capture, which every process makes again: it
saves the kernels' ``nvcc`` time. On the CPU there is no kernel and no
capture, so an entry is a record with no kernels, and these cases hold the
store's discipline: keys, checksums, quarantine, the probe's gate on tier
A, the fault site, gc, the CLI, and that a disarmed process never imports
the package. ``core/cuda_build.py``'s use of tier A is driven with a fake
``nvcc`` that writes a copy of the C library's ``libm``.
"""
import ctypes.util
import functools
import json
import os
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as pt
from paddle_tpu import warmstore as jws
from paddle_tpu_torch import warmstore as ws
from paddle_tpu_torch.core import cuda_build
from paddle_tpu_torch.observability.metrics import REGISTRY
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.warmstore import keys, probe
from paddle_tpu_torch.warmstore.store import TIER_A, TIER_B, WarmStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _pristine_warmstore(monkeypatch):
    """Every case starts disarmed with a cold probe; nothing leaks (the
    store singleton and the warn-once flag are process-wide)."""
    monkeypatch.delenv("PADDLE_TPU_WARMSTORE", raising=False)
    monkeypatch.delenv("PADDLE_TPU_WARMSTORE_PROBE", raising=False)
    faults.clear()
    ws.reset_for_tests()
    yield
    faults.clear()
    ws.reset_for_tests()


def _sum_counter(name, **match):
    fam = REGISTRY.get(name)
    if fam is None:
        return 0.0
    return sum(child.value for lbl, child in fam.items()
               if all(dict(lbl).get(k) == v for k, v in match.items()))


def _eval_program(dim=6, seed=11):
    """Optimizer-free: the same feed gives the same fetch every run."""
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [dim], "float32")
        loss = pt.layers.mean(pt.layers.fc(x, dim, act="tanh"))
    return main, startup, loss


def _feed(dim=6):
    return {"x": np.random.RandomState(3).randn(4, dim).astype("float32")}


def _record(n=1):
    return {"kernels": [{"name": "flash_attn_fwd", "library": f"libflash_attn_fwd-{n:012d}.so",
                         "digest": f"{n:012d}"}],
            "capture": {"graph_pool_bytes": 1024, "argument_bytes": 256}}


# ---------------------------------------------------------------- smoke --

def test_cli_selftest():
    """``python -m paddle_tpu_torch.warmstore --selftest`` (both forced
    verdicts, a library's tier-A round trip, quarantine, gc) prints PASS.
    Hermetic, on the CPU: it holds the store, not what a hit skips (the
    capture and the verifier are never skipped)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("PADDLE_TPU_WARMSTORE", None)
    env.pop("PADDLE_TPU_WARMSTORE_PROBE", None)
    p = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.warmstore", "--selftest"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "warmstore selftest: PASS" in p.stdout


def test_zero_overhead_when_disarmed(tmp_path):
    """Unset ``PADDLE_TPU_WARMSTORE``: a train, a save and a Predictor run
    leave ``paddle_tpu_torch.warmstore`` out of ``sys.modules`` (no open, no
    thread, no probe).
    On the card a hit skips neither the verifier nor the capture."""
    script = tmp_path / "disarmed.py"
    script.write_text(
        "import os, sys\n"
        "assert 'PADDLE_TPU_WARMSTORE' not in os.environ\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as pt\n"
        "main, startup = pt.Program(), pt.Program()\n"
        "with pt.program_guard(main, startup):\n"
        "    x = pt.data('x', [4], 'float32')\n"
        "    y = pt.layers.fc(x, 2)\n"
        "    loss = pt.layers.mean(y)\n"
        "    pt.optimizer.SGD(learning_rate=0.1).minimize(loss)\n"
        "exe = pt.Executor(pt.CPUPlace())\n"
        "feed = {'x': np.ones((2, 4), 'float32')}\n"
        "with pt.scope_guard(pt.Scope()):\n"
        "    exe.run(startup)\n"
        "    exe.run(main, feed=feed, fetch_list=[loss])\n"
        "    exe.run(main, feed=feed, fetch_list=[loss])\n"
        "    d = os.path.join(r'%s', 'model')\n"
        "    pt.io.save_inference_model(d, ['x'], [y], exe, main)\n"
        "pred = pt.inference.Predictor(d, device='cpu')\n"
        "pred.run({'x': np.ones((2, 4), 'float32')})\n"
        "assert not any(m.startswith('paddle_tpu_torch.warmstore')\n"
        "               for m in sys.modules), 'imported!'\n"
        "print('DISARMED-OK')\n" % tmp_path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("PADDLE_TPU_WARMSTORE", None)
    p = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "DISARMED-OK" in p.stdout


# ------------------------------------------------------------ round trip --

def test_fresh_executor_hits_tier_b_byte_identical(tmp_path, monkeypatch):
    """Executor A runs and offers; executor B (a cold cache, one process)
    hits the stored record: one tier-B hit, no miss, the fetch bit for bit.
    The hit does not skip the verifier: B's miss still verifies once.
    On the card a hit skips neither the verifier nor the capture."""
    monkeypatch.setenv("PADDLE_TPU_WARMSTORE", str(tmp_path / "store"))
    main, startup, loss = _eval_program()
    feed = _feed()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe_a = pt.Executor(pt.CPUPlace())
        exe_a.run(startup)
        ref, = exe_a.run(main, feed=feed, fetch_list=[loss])
    assert ws.flush(30.0)

    calls = []
    real = pt.analysis.verify
    monkeypatch.setattr(pt.analysis, "verify", lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "warn")
    hits, misses = _sum_counter("warmstore_hits_total"), _sum_counter("warmstore_misses_total")
    with pt.scope_guard(scope):
        out, = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[loss])
    assert np.array_equal(out, ref)
    assert _sum_counter("warmstore_hits_total") == hits + 1
    assert _sum_counter("warmstore_hits_total", tier="b") >= 1
    assert _sum_counter("warmstore_misses_total") == misses
    assert calls == [1], "a hit must not skip the verifier gate"
    rec = ws.active_store().consult(keys.build_key(
        "train_step", main, feed_sig=(("x", (4, 6), "torch.float32"),),
        fetch_names=[loss.name], seed=11, flags=(True, True, True, False), strategy=(),
        world_dependent=False, device="cpu"))
    assert rec is not None and rec.value == {"kernels": [], "capture": {}}


def test_serving_cold_start_hits_store(tmp_path, monkeypatch):
    """A second Predictor over the same saved model hits the first one's
    record (one hit, no miss) and answers the same bytes. On the card the
    hit has the step's kernels ready before its warm-up; the warm-up and the
    capture still run.
    On the card a hit skips neither the verifier nor the capture."""
    monkeypatch.setenv("PADDLE_TPU_WARMSTORE", str(tmp_path / "store"))
    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = 11
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [6], "float32")
        y = pt.layers.fc(x, 3, act="tanh")
    d = str(tmp_path / "model")
    with pt.scope_guard(pt.Scope()):
        exe = pt.Executor(pt.CPUPlace())
        exe.run(startup)
        pt.io.save_inference_model(d, ["x"], [y], exe, main)
    feed = _feed()
    out1, = pt.inference.Predictor(d, device="cpu").run(feed)
    assert ws.flush(30.0)
    hits, misses = _sum_counter("warmstore_hits_total"), _sum_counter("warmstore_misses_total")
    out2, = pt.inference.Predictor(d, device="cpu").run(feed)
    assert np.array_equal(out1, out2)
    assert _sum_counter("warmstore_hits_total") == hits + 1
    assert _sum_counter("warmstore_misses_total") == misses
    kinds = sorted(r["kind"] for r in ws.active_store().ls())
    assert "predict" in kinds


# -------------------------------------------------------- probe self-off --

def test_probe_self_disable_never_touches_tier_a(tmp_path, monkeypatch):
    """A failing verdict turns tier A off: a fresh library is not stored, a
    stored one is never read (a spy on the one read counts 0), the steps'
    records still hit tier B, the warning fires once and no probe spawns.
    The kernels are then compiled by ``nvcc`` from the sources (not held
    here: no ``nvcc`` on the CPU).
    On the card a hit skips neither the verifier nor the capture."""
    store = WarmStore(str(tmp_path / "store"))
    lib = tmp_path / "libflash_attn_fwd-000000000001.so"
    lib.write_bytes(b"\x7fELF-stand-in" * 64)
    monkeypatch.setenv(probe.ENV_FORCE, "pass")
    store.offer_library(lib.name, lib)
    assert store.flush(30.0)
    monkeypatch.setenv(probe.ENV_FORCE, "fail")
    probe.reset_for_tests()
    reads = []
    monkeypatch.setattr(store, "_load_tier_a", lambda path: reads.append(path) or b"")
    key = {"format": 1, "kind": "spy", "n": 1}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        store.offer_library("libdropout-000000000002.so", lib)
        store.offer(key, _record())
        assert store.flush(30.0)
        assert not store.restore_library(lib.name, tmp_path / "out.so")
        assert not store.restore_library(lib.name, tmp_path / "out.so")
        hit = store.consult(key)
    store.close()
    assert hit is not None and hit.tier == "b" and hit.kernels == ["flash_attn_fwd"]
    assert reads == [], "tier A was read under a failing verdict"
    assert not (tmp_path / "out.so").exists()
    assert not os.path.isdir(store.library_entry("libdropout-000000000002.so")), \
        "a failing verdict must drop a library offer"
    assert probe.SPAWNS == 0, "a forced verdict must not spawn a probe"
    assert sum("tier A" in str(w.message) for w in caught) == 1


def test_unprobed_build_stores_but_does_not_cache_a_verdict(tmp_path):
    """With no verdict and no library to probe, the answer is a provisional
    pass, not cached in memory or on disk; the denylist is empty.
    On the card a hit skips neither the verifier nor the capture."""
    assert probe.DENYLIST == ()
    v = probe.verdict(cache_dir=str(tmp_path / "probe"))
    assert v.tier_a and v.source == "unprobed"
    assert not (tmp_path / "probe").exists() and probe.SPAWNS == 0
    assert probe.kernel_of("/x/libflash_attn_fwd-0123456789ab.so") == "flash_attn_fwd"
    assert probe.kernel_of("libmulti_tensor_update-ab.so") == "multi_tensor_update"
    assert set(probe.CHECKS) == set(cuda_build.SOURCES)


# ------------------------------------------------------------ quarantine --

def test_corrupt_payload_quarantined_and_missed(tmp_path):
    """A flipped byte of a record fails its crc32: the entry is renamed
    ``.corrupt``, the lookup misses (the step runs fresh) and ``verify``
    names it; the slot is free for a clean re-offer.
    On the card a hit skips neither the verifier nor the capture."""
    root = str(tmp_path / "store")
    store = WarmStore(root)
    key = {"format": 1, "kind": "victim", "n": 1}
    store.offer(key, _record())
    assert store.flush(30.0)
    digest = keys.digest(key)
    payload = os.path.join(root, "entries", digest, TIER_B)
    with open(payload, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    q = _sum_counter("warmstore_quarantined_total")
    assert store.consult(key) is None
    assert _sum_counter("warmstore_quarantined_total") == q + 1
    assert os.path.isdir(os.path.join(root, "entries", digest + ".corrupt"))
    assert not os.path.isdir(os.path.join(root, "entries", digest))
    assert any("quarantined" in p for p in store.verify())
    store.offer(key, _record())
    assert store.flush(30.0)
    assert store.consult(key) is not None
    store.close()


def test_truncated_meta_quarantined(tmp_path):
    """Half a meta.json (a torn write): quarantine and miss, never an
    exception into the step.
    On the card a hit skips neither the verifier nor the capture."""
    root = str(tmp_path / "store")
    store = WarmStore(root)
    key = {"format": 1, "kind": "victim", "n": 2}
    store.offer(key, _record())
    assert store.flush(30.0)
    meta = os.path.join(root, "entries", keys.digest(key), "meta.json")
    raw = open(meta, "rb").read()
    with open(meta, "wb") as f:
        f.write(raw[:len(raw) // 2])
    assert store.consult(key) is None
    assert os.path.isdir(os.path.join(root, "entries", keys.digest(key) + ".corrupt"))
    store.close()


# ---------------------------------------------------------------- keying --

def test_world_change_misses_local_key_survives(monkeypatch):
    """8 -> 6 devices: a world-scoped key changes digest, a local one (every
    step the port runs today) survives; another program misses either way.
    On the card a hit skips neither the verifier nor the capture."""
    main, _, _ = _eval_program(seed=23)
    kw = dict(feed_sig=(("x", (4, 6), "torch.float32"),), fetch_names=["m"], seed=0,
              flags=None, strategy=(), device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    k8 = keys.build_key("train_step", main, world_dependent=True, **kw)
    l8 = keys.build_key("train_step", main, world_dependent=False, **kw)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 6)
    k6 = keys.build_key("train_step", main, world_dependent=True, **kw)
    l6 = keys.build_key("train_step", main, world_dependent=False, **kw)
    assert keys.digest(k8) != keys.digest(k6)
    assert keys.digest(l8) == keys.digest(l6)
    assert k8["topology"] == {"scope": "world", "processes": 1, "devices": 8}
    assert l8["topology"] == {"scope": "local"}
    other, _, _ = _eval_program(dim=7, seed=23)
    assert keys.digest(keys.build_key("train_step", other, world_dependent=False, **kw)) \
        != keys.digest(l8)
    assert l8["device_kind"] == "cpu" and {"torch", "cuda", "nvcc", "driver"} <= set(l8)


def test_key_digests_equal_the_jax_packages():
    """The same key dict gives the JAX package's canonical JSON and digest,
    and the same program content digest discipline (memoized per version).
    On the card a hit skips neither the verifier nor the capture."""
    from paddle_tpu.warmstore import keys as jkeys
    for key in ({"format": 1, "kind": "train_step", "seed": 3, "fetch": ["a", "b"]},
                {"kind": "predict", "topology": {"scope": "local"}, "tuning": ["cached", ""],
                 "feed_sig": repr((("x", (4, 6), "float32"),))},
                {}):
        assert keys.canonical(key) == jkeys.canonical(key)
        assert keys.digest(key) == jkeys.digest(key) == jws.digest(key)
    main, _, _ = _eval_program()
    d = keys.program_digest(main)
    assert main._warmstore_digest == (main._version, d) and keys.program_digest(main) == d


# ----------------------------------------------------------------- chaos --

def test_chaos_corrupt_at_warmstore_write_falls_through(tmp_path, monkeypatch):
    """``corrupt@warmstore_write`` flips a bit of every committed entry; the
    next executor's consult catches it by crc32, quarantines, and runs the
    step fresh, bit for bit.
    On the card a hit skips neither the verifier nor the capture."""
    monkeypatch.setenv("PADDLE_TPU_WARMSTORE", str(tmp_path / "store"))
    faults.install("corrupt@warmstore_write:times=0")
    main, startup, loss = _eval_program(seed=31)
    feed = _feed()
    scope = pt.Scope()
    with pt.scope_guard(scope):
        exe_a = pt.Executor(pt.CPUPlace())
        exe_a.run(startup)
        ref, = exe_a.run(main, feed=feed, fetch_list=[loss])
    assert ws.flush(30.0)
    faults.clear()
    q = _sum_counter("warmstore_quarantined_total")
    misses = _sum_counter("warmstore_misses_total", reason="corrupt")
    with pt.scope_guard(scope):
        out, = pt.Executor(pt.CPUPlace()).run(main, feed=feed, fetch_list=[loss])
    assert np.array_equal(out, ref)
    assert _sum_counter("warmstore_quarantined_total") == q + 1
    assert _sum_counter("warmstore_misses_total", reason="corrupt") == misses + 1


# ------------------------------------------------------------------- gc --

def test_gc_and_ls_bound_the_store(tmp_path):
    """``gc`` evicts oldest first down to the cap; ``ls`` totals agree with
    the disk; ``verify`` is clean; the CLI's ``verify`` exits 0, then 1
    once an entry is damaged.
    On the card a hit skips neither the verifier nor the capture."""
    root = str(tmp_path / "store")
    store = WarmStore(root)
    for i in range(3):
        store.offer({"format": 1, "kind": "gc", "n": i}, _record(i))
    assert store.flush(30.0)
    rows = store.ls()
    assert len(rows) == 3 and all(r["tiers"] == ["b"] for r in rows)
    removed = store.gc(max_bytes=max(r["bytes"] for r in rows))
    assert len(removed) == 2 and len(store.ls()) == 1
    assert store.verify() == []
    store.close()
    from paddle_tpu_torch.warmstore.__main__ import main as cli
    assert cli(["--root", root, "verify"]) == 0
    entry = os.path.join(root, "entries", store.ls()[0]["digest"])
    with open(os.path.join(entry, TIER_B), "ab") as f:
        f.write(b"x")
    assert cli(["--root", root, "verify"]) == 1
    assert cli(["--root", root, "ls"]) == 0


# ------------------------------------------- cuda_build's use of tier A --

class _FakeNvcc:
    """Stands in for ``nvcc`` in ``cuda_build.build``: writes a copy of libm
    (a library ``dlopen`` takes) to its ``-o`` path."""
    runs = 0

    def __init__(self, cmd, **kw):
        type(self).runs += 1
        self.out = cmd[cmd.index("-o") + 1]
        self.returncode = 0

    def communicate(self):
        shutil.copyfile(_libm(), self.out)
        return "fake nvcc", None


@functools.lru_cache(maxsize=None)
def _libm():
    name = ctypes.util.find_library("m")
    for d in ("/lib/x86_64-linux-gnu", "/usr/lib/x86_64-linux-gnu", "/lib64", "/usr/lib64",
              "/lib/aarch64-linux-gnu", "/usr/lib/aarch64-linux-gnu"):
        if name and os.path.exists(os.path.join(d, name)):
            return os.path.join(d, name)
    pytest.skip("no libm file to stand in for a kernel library")


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    _libm()
    monkeypatch.setenv("PADDLE_TPU_WARMSTORE", str(tmp_path / "store"))
    monkeypatch.setenv(probe.ENV_FORCE, "pass")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(cuda_build, "stats", dict(cuda_build.stats, nvcc=0, restored=0))
    monkeypatch.setattr(cuda_build, "_loaded", {})
    _FakeNvcc.runs = 0
    return tmp_path


def test_a_fresh_build_is_offered_and_a_second_checkout_restores_it(fake_build):
    """A first build runs ``nvcc`` and offers its library; with an empty
    build directory (a fresh checkout) the next build restores it from tier
    A byte-identical, and runs no ``nvcc``.
    On the card a hit skips neither the verifier nor the capture."""
    path = cuda_build.build(["dropout"])["dropout"]
    assert _FakeNvcc.runs == 1 and cuda_build.stats["nvcc"] == 1
    assert ws.flush(30.0)
    stored = os.path.join(ws.active_store().library_entry(path.name), TIER_A)
    assert open(stored, "rb").read() == path.read_bytes()
    shutil.rmtree(cuda_build.BUILD_DIR)
    hits = _sum_counter("warmstore_hits_total", tier="a")
    again = cuda_build.build(["dropout"])["dropout"]
    assert again == path and again.read_bytes() == open(_libm(), "rb").read()
    assert _FakeNvcc.runs == 1 and cuda_build.stats["restored"] == 1
    assert _sum_counter("warmstore_hits_total", tier="a") == hits + 1


def test_a_stored_library_that_fails_its_checksum_or_dlopen_is_rebuilt(fake_build):
    """A stored library with a flipped byte is quarantined by its checksum,
    and one with a right checksum that ``dlopen`` refuses is quarantined at
    the load; each time the kernel is compiled by ``nvcc`` from the sources
    and loads: never the plain version.
    On the card a hit skips neither the verifier nor the capture."""
    store = ws.active_store()
    name = cuda_build.library_path("int8_matmul").name
    store.offer_library(name, _libm())
    assert ws.flush(30.0)
    entry = store.library_entry(name)
    with open(os.path.join(entry, TIER_A), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 1]))
    cuda_build.build(["int8_matmul"])
    assert _FakeNvcc.runs == 1 and os.path.isdir(entry + ".corrupt")
    assert ws.flush(30.0) and os.path.isdir(entry)        # the fresh build, offered
    # a right checksum over bytes no dlopen takes
    shutil.rmtree(entry)
    junk = fake_build / "junk.so"
    junk.write_bytes(b"not an ELF file" * 100)
    store.offer_library(name, junk)
    assert ws.flush(30.0)
    shutil.rmtree(cuda_build.BUILD_DIR)
    lib = cuda_build.load("int8_matmul")
    assert lib is not None and _FakeNvcc.runs == 2
    assert os.path.isdir(entry + ".corrupt")
    assert any(e.get("stage") == "dlopen" for e in pt.observability.journal.recent(
        event="warmstore_restore_error"))


def test_prefetch_makes_the_stored_steps_kernels_ready(fake_build, monkeypatch):
    """The pool's one startup scan: on a card, the kernels of every stored
    step of this build are made ready together before the first request
    (here restored from tier A: no ``nvcc``).
    On the card a hit skips neither the verifier nor the capture."""
    here = dict(keys.versions(), device_kind="card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(keys, "device_kind", lambda device=None: "card")
    store = ws.active_store()
    name = cuda_build.library_path("flash_attn_fwd").name
    store.offer_library(name, _libm())
    store.offer(dict(here, kind="predict", n=1), {"kernels": [
        {"name": "flash_attn_fwd", "library": name, "digest": name[-15:-3]}], "capture": {}})
    assert ws.flush(30.0)
    assert ws.prefetch() == 2
    assert (cuda_build.BUILD_DIR / name).exists() and _FakeNvcc.runs == 0
    assert json.loads(json.dumps(store.records()))[0]["record"]["kernels"][0]["library"] == name
