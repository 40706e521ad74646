"""The port's serving tier (``paddle_tpu_torch/serving/``) against the JAX
package's (``paddle_tpu/serving/``).

The batcher, the tenant queue and the circuit breaker are pure host logic:
the same scripted requests go through both packages' classes under a
``FakeClock`` (no sleeps, no threads), and the batches, their order and
padding, the shed reasons, the reaped deadlines and the breaker's state
transitions must be identical. A ``PredictorPool`` on the CPU then serves
a tiny MLP saved by the JAX package: each batched output within
``CPU_SOLO_ULPS`` (4) ULPs at its row's scale of the port's solo
``Predictor.run`` (``serving/__main__.ulps_apart``; the byte-equal ones
are counted) and within f32 ``atol 1e-6`` of the JAX ``Predictor`` (the
frameworks sum the fc products in other orders). Byte-equality to the solo
run is the card's guarantee (``chip_smoke.py`` phase 21), not the CPU's:
the CPU's matrix product picks its kernel by the row count (on an AVX-512
host torch 2.13 sums the same row of a 2- and a 4-row product in other
orders), and a pooled request runs in a bucket of other rows than alone. Pools in these tests hold an 8-wide MLP, every wait has a
timeout and every pool is closed in a ``finally``.
"""
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import paddle_tpu as fluid  # noqa: F401  (registers the JAX op library)
from paddle_tpu.inference import Predictor as JaxPredictor
from paddle_tpu.serving import batcher as jbatcher
from paddle_tpu.serving import breaker as jbreaker
from paddle_tpu.serving import pool as jpool
from paddle_tpu.serving.__main__ import _build_mlp as jax_build_mlp
from paddle_tpu_torch.inference import Predictor
from paddle_tpu_torch.observability import journal
from paddle_tpu_torch.observability.slo import SLOConfigError
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import batcher as tbatcher
from paddle_tpu_torch.serving import breaker as tbreaker
from paddle_tpu_torch.serving import pool as tpool
from paddle_tpu_torch.serving.__main__ import CPU_SOLO_ULPS, _build_mlp, ulps_apart
from paddle_tpu_torch.serving import PredictorPool, RequestTimeout, ServingError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jbatcher, jbreaker, jpool), "port": (tbatcher, tbreaker, tpool)}
JOIN_S = 60


def _req(b, rows, width=4, tenant="default", deadline=None, t=0.0):
    return b.Request({"x": np.full((rows, width), rows, "float32")}, tenant=tenant,
                     t_submit=t, deadline=deadline)


def _batch_trace(batch):
    return None if batch is None else (
        [(r.tenant, r.rows) for r in batch.requests], batch.rows, batch.padded_rows,
        {k: v.shape for k, v in batch.feed().items()})


# ------------------------------------------------------------ batcher / queue


def _batcher_script(pkg):
    b, _, p = PKGS[pkg]
    clock = b.FakeClock()
    out = []
    q = b.SimpleQueue(clock=clock)
    for rows in (1, 3, 2, 1, 5, 2):
        q.push(_req(b, rows))
    q.push(_req(b, 1, width=8))            # another signature
    q.push(_req(b, 20))                    # oversize: served whole
    bat = b.DynamicBatcher(max_batch=8, max_wait_ms=3.0, clock=clock)
    for _ in range(6):
        out.append(_batch_trace(bat.form(q, timeout=0.01)))
        out.append(round(clock.now(), 6))
    # a lone request waits max_wait_ms on the fake clock, then serves alone
    q.push(_req(b, 1))
    out.append(_batch_trace(bat.form(q, timeout=0.01)))
    out.append(round(clock.now(), 6))
    # a non-row-wise fetch fails the batch typed
    r = _req(b, 2)
    b.Batch([r]).scatter([np.float32(0.5)])
    out.append(type(r._error).__name__)
    return out


def test_batcher_forms_the_same_batches_as_jax():
    assert _batcher_script("port") == _batcher_script("jax")


def _queue_script(pkg):
    b, _, p = PKGS[pkg]
    clock = b.FakeClock()
    expired = []
    tq = p.TenantQueue(max_queue=12, quotas={"q": 1}, weights={"a": 1.0, "b": 1.0, "c": 2.0},
                       clock=clock, max_head_bypass=2,
                       on_expire=lambda r: expired.append((r.tenant, r.rows)))
    out = []
    out.append([tq.try_push(_req(b, 1, tenant="q")) for _ in range(2)])   # quota
    for i in range(3):
        for t in ("a", "b", "c"):
            out.append(tq.try_push(_req(b, 1 + i % 2, tenant=t)))
    out.append(tq.try_push(_req(b, 1, tenant="d")))                     # the 11th
    out.append(tq.try_push(_req(b, 1, tenant="d", deadline=0.5)))
    out.append(tq.try_push(_req(b, 1, tenant="e")))                     # queue_full
    clock.advance(1.0)
    order = []
    while True:
        r = tq.pop_first(timeout=0.0)
        if r is None:
            break
        order.append((r.tenant, r.rows))
    out.append(order)
    out.append(expired)
    # the bypass bound: an oversize head goes solo after max_head_bypass fills
    tq2 = p.TenantQueue(max_queue=8, clock=clock, max_head_bypass=2)
    tq2.try_push(_req(b, 1, tenant="a_small"))
    tq2.try_push(_req(b, 6, tenant="b_big"))
    first = tq2.pop_first(timeout=0.0)
    out.append((first.tenant, [tq2.pop_compatible(first.sig, 2) is None for _ in range(2)],
                tq2._tenants["b_big"][0].solo))
    tq.close()
    out.append(tq.try_push(_req(b, 1)))
    return out


def test_tenant_queue_sheds_orders_and_reaps_as_jax():
    got, want = _queue_script("port"), _queue_script("jax")
    assert got == want
    assert got[0] == [None, "tenant_quota"] and got[-1] == "closed"


def _breaker_script(pkg):
    b, br, _ = PKGS[pkg]
    clock = b.FakeClock()
    log = []
    cb = br.CircuitBreaker(threshold=2, backoff_s=1.0, backoff_max_s=3.0, clock=clock,
                           on_transition=lambda k, o, n, e: log.append((k, o, n, e.failures,
                                                                        e.backoff)))
    key = ("t", "sig")
    steps = []
    for action, dt in (("fail", 0), ("allow", 0), ("fail", 0), ("allow", 0.5),
                       ("allow", 0.6), ("allow", 0), ("fail", 0), ("allow", 1.5),
                       ("allow", 0.6), ("ok", 0), ("allow", 0)):
        clock.advance(dt)
        if action == "fail":
            cb.record_failure(key)
        elif action == "ok":
            cb.record_success(key)
        else:
            ok, state, retry = cb.allow(key)
            steps.append((ok, state, round(retry, 6)))
    return steps, log, cb.state(key), br.sig_id((("x", (4,), "float32"),))


def test_breaker_transitions_equal_jax():
    got, want = _breaker_script("port"), _breaker_script("jax")
    assert got == want
    assert [n for _, _, n, _, _ in got[1]] == ["open", "half_open", "open", "half_open",
                                               "closed"]


# ---------------------------------------------------------------------- pools


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Two tiny 8->16->4 MLPs saved by the JAX package (seeds 11 and 29)."""
    da = str(tmp_path_factory.mktemp("mlp_a"))
    db = str(tmp_path_factory.mktemp("mlp_b"))
    jax_build_mlp(da, seed=11)
    jax_build_mlp(db, seed=29)
    return da, db


def _feeds(rows=(1, 2, 3, 1, 2, 5, 1, 4), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, 8).astype("float32") for n in rows]


def test_a_pool_serves_as_solo_and_matches_jax(models):
    da, _ = models
    feeds = _feeds()
    solo = Predictor(da, device="cpu")
    refs = [solo.run({"x": f})[0] for f in feeds]
    jrefs = [np.asarray(JaxPredictor(da).run({"x": f})[0]) for f in feeds]
    pool = PredictorPool(da, size=2, max_batch=8, max_wait_ms=20.0, max_queue=32,
                         weights={"t0": 1.0, "t1": 2.0}, device="cpu")
    results = [None] * len(feeds)
    try:
        assert pool.warmup({"x": feeds[0]}) == 2 * 4       # 2 predictors x buckets 1-8

        def client(i):
            results[i] = pool.run({"x": feeds[i]}, tenant=f"t{i % 2}", timeout=JOIN_S)[0]

        ts = [threading.Thread(target=client, args=(i,)) for i in range(len(feeds))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=JOIN_S)
    finally:
        pool.close(drain_timeout=JOIN_S)
    equal = 0
    for f, got, ref, jref in zip(feeds, results, refs, jrefs):
        assert got is not None and got.shape == ref.shape
        assert ulps_apart(got, ref) <= CPU_SOLO_ULPS
        equal += got.tobytes() == ref.tobytes()
        np.testing.assert_allclose(got, jref, atol=1e-6, rtol=0)
    print(f"{equal} of {len(feeds)} pool outputs byte-equal to solo")
    assert pool.in_flight == 0 and pool.queue_depth() == 0 and pool._pending == 0
    # warmup built every bucket: traffic built no executable
    assert all(len(p._compiled) == 4 for p in pool._predictors)


def test_deadlines_resolve_typed_on_a_fake_clock(models):
    da, _ = models
    clock = tbatcher.FakeClock()
    pool = PredictorPool(da, size=1, max_batch=4, max_wait_ms=0.0, clock=clock,
                         start_workers=False, device="cpu")
    try:
        late = pool.submit({"x": _feeds((1,))[0]}, tenant="a", deadline_ms=5.0)
        ok = pool.submit({"x": _feeds((2,))[0]}, tenant="b", deadline_ms=50.0)
        clock.advance(0.010)
        served = pool._serve_once(0, pool._predictors[0])
        assert served is not None and [r.tenant for r in served.requests] == ["b"]
        with pytest.raises(RequestTimeout) as e:
            late.result(timeout=0)
        assert e.value.tenant == "a" and e.value.deadline_ms == pytest.approx(5.0)
        assert ok.result(timeout=0)[0].shape == (2, 4)
        assert pool._pending == 0
    finally:
        pool.close(drain_timeout=5.0)


def test_a_swap_copies_into_the_executables_without_building_any(models):
    """swap() under load: no new executable and no cache miss; every output
    is one of the two models' solo outputs, within ``CPU_SOLO_ULPS`` (a
    2-row request batched with another runs as a 4-row product, which the
    CPU sums in another order, see the module's docstring); after the swap,
    the new model's. The two models' outputs lie far more than that apart,
    so each output names its model."""
    da, db = models
    feed = {"x": _feeds((2,))[0]}
    ref_a = Predictor(da, device="cpu").run(feed)[0]
    ref_b = Predictor(db, device="cpu").run(feed)[0]
    assert ref_a.tobytes() != ref_b.tobytes()
    pool = PredictorPool(da, size=2, max_batch=4, max_wait_ms=1.0, device="cpu")
    try:
        pool.warmup(feed)
        before = [(len(p._compiled), dict(p._cache_counts)["miss"]) for p in pool._predictors]
        futures = [pool.submit(feed) for _ in range(20)]
        assert pool.swap(db, timeout=JOIN_S) == 2
        futures += [pool.submit(feed) for _ in range(20)]
        outs = [f.result(timeout=JOIN_S)[0] for f in futures]
    finally:
        pool.close(drain_timeout=JOIN_S)
    assert ulps_apart(ref_a, ref_b) > 1000 * CPU_SOLO_ULPS
    assert all(min(ulps_apart(o, ref_a), ulps_apart(o, ref_b)) <= CPU_SOLO_ULPS for o in outs)
    assert all(ulps_apart(o, ref_b) <= CPU_SOLO_ULPS for o in outs[20:])
    print(f"swap: farthest {max(min(ulps_apart(o, ref_a), ulps_apart(o, ref_b)) for o in outs)}"
          f" ULPs from a solo output")
    after = [(len(p._compiled), dict(p._cache_counts)["miss"]) for p in pool._predictors]
    assert after == before and pool.model_version == 2
    assert all(p.model_version == 2 for p in pool._predictors)


def test_a_swap_of_the_wrong_shapes_is_rejected_typed(models):
    da, _ = models
    pool = PredictorPool(da, size=1, device="cpu")
    try:
        state = {n: np.zeros((3, 3), "float32") for n in pool._predictors[0]._state}
        with pytest.raises(ServingError, match="swap rejected"):
            pool.swap(state=state)
        assert pool.model_version == 1
    finally:
        pool.close(drain_timeout=5.0)


def test_a_serving_fault_gives_typed_errors_to_its_tenant_only(models):
    da, _ = models
    feed = {"x": _feeds((1,))[0]}
    faults.clear()
    faults.install("exc@serve_dispatch:var=evil:times=0")
    journal.clear()
    pool = PredictorPool(da, size=1, max_batch=4, max_wait_ms=0.0, breaker_threshold=2,
                         breaker_backoff_s=30.0, device="cpu")
    try:
        typed, fast = 0, 0
        for _ in range(4):
            try:
                pool.run(feed, tenant="evil", timeout=JOIN_S)
            except tbreaker.BreakerOpen:
                fast += 1
            except ServingError:
                typed += 1
        good = [pool.run(feed, tenant="good", timeout=JOIN_S)[0] for _ in range(3)]
    finally:
        pool.close(drain_timeout=JOIN_S)
        faults.clear()
    assert typed == 2 and fast == 2
    assert all(g.shape == (1, 4) for g in good)
    opened = [e for e in journal.recent(event="serve_breaker") if e["to"] == "open"]
    assert [e["tenant"] for e in opened] == ["evil"]


def test_nan_at_serve_fetch_fails_the_batch_typed(models):
    da, _ = models
    faults.clear()
    faults.install("nan@serve_fetch:var=nansy:times=1")
    pool = PredictorPool(da, size=1, max_batch=4, max_wait_ms=0.0, check_outputs=True,
                         device="cpu")
    try:
        with pytest.raises(ServingError, match="nonfinite"):
            pool.run({"x": _feeds((1,))[0]}, tenant="nansy", timeout=JOIN_S)
        assert pool.run({"x": _feeds((1,))[0]}, tenant="nansy", timeout=JOIN_S)[0].shape \
            == (1, 4)
    finally:
        pool.close(drain_timeout=JOIN_S)
        faults.clear()


def test_unported_hooks_raise_naming_their_items(models, monkeypatch, tmp_path):
    da, _ = models
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        PredictorPool(da, size=1, sparse_tables={"t": object()}, device="cpu")
    # the SLO engine is ported: a rules file that cannot be read raises
    # before any worker starts
    monkeypatch.setenv("PADDLE_TPU_OBS_SLO", "no_such_rules.json")
    with pytest.raises(SLOConfigError, match="no_such_rules.json"):
        PredictorPool(da, size=1, device="cpu")
    monkeypatch.delenv("PADDLE_TPU_OBS_SLO")
    pool = PredictorPool(da, size=1, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
            pool.apply_delta({"table": "t"})
        # the warm store is ported (item 12 (b)): armed, warmup makes its one
        # startup scan and warms every bucket
        monkeypatch.setenv("PADDLE_TPU_WARMSTORE", str(tmp_path / "ws"))
        assert pool.warmup({"x": _feeds((1,))[0]}) == 6     # buckets 1-32, one predictor
    finally:
        pool.close(drain_timeout=5.0)
        from paddle_tpu_torch import warmstore
        warmstore.reset_for_tests()


def test_serving_dtype_bucket_equals_jax_and_benches_the_predictors_executable(models):
    da, _ = models
    sig = tbatcher.row_signature({"x": np.zeros((3, 8), "float32")})
    params = {"rows": 3, "sig": sig, "sig_parts": sig, "configured": "float32"}
    t, j = tpool.ServingDtype(), jpool.ServingDtype()
    assert t.bucket(params) == j.bucket(params)
    assert t.candidates(params) == j.candidates(params) and t.default(params) == "float32"
    pred = Predictor(da, device="cpu")
    fn, args = t.bench(dict(params, predictor=pred), "bfloat16")
    out = fn(*args)
    assert out[0].shape == (4, 4) and pred._cache_counts["miss"] == 1
    fn(*args)
    assert pred._cache_counts == {"hit": 1, "miss": 1}


def test_selftest_cli():
    r = subprocess.run([sys.executable, "-m", "paddle_tpu_torch.serving", "--selftest"],
                       cwd=ROOT, capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    assert "serving selftest: OK" in r.stdout


def test_the_port_builds_the_same_mlp_program_as_jax(tmp_path):
    """The selftest's MLP, saved by the port's DSL, loads in the JAX
    Predictor and answers as the port's does (f32 ``atol 1e-6``)."""
    _build_mlp(str(tmp_path))
    x = {"x": _feeds((3,))[0]}
    np.testing.assert_allclose(Predictor(str(tmp_path), device="cpu").run(x)[0],
                               np.asarray(JaxPredictor(str(tmp_path)).run(x)[0]),
                               atol=1e-6, rtol=0)
