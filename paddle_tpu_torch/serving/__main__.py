"""Serving-tier CLI (the port's copy of ``python -m paddle_tpu.serving``).

    python -m paddle_tpu_torch.serving --selftest          # on the CPU
    python -m paddle_tpu_torch.serving --chaos [--device cpu]

The selftest is two-stage: (1) hermetic fake-clock batcher/queue drills --
no threads, no sleeps -- covering coalescing, pow2 padding, deadline,
signature isolation, admission control, quota shed and weighted fair
dequeue; (2) a tiny-MLP ``PredictorPool`` round-trip on the CPU proving
batched outputs within ``CPU_SOLO_ULPS`` of solo ``Predictor.run``
(byte-equal ones counted) and that the serving metrics carry the signal. ``--chaos`` drives
real pools under injected serving faults (on the card unless ``--device
cpu``).

Exit codes: 0 ok, 1 failure.
"""
from __future__ import annotations

import argparse


def _selftest_batcher() -> None:
    """Stage 1: hermetic fake-clock drills."""
    import numpy as np

    from .batcher import (Batch, DynamicBatcher, FakeClock, Request,
                          ServingError, SimpleQueue)
    from .pool import TenantQueue

    clock = FakeClock()

    # ragged coalescing + pow2 padding, FIFO order preserved
    q = SimpleQueue(clock=clock)
    reqs = [Request({"x": np.zeros((n, 4), "float32")}, t_submit=clock.now())
            for n in (1, 3, 2, 1)]
    for r in reqs:
        q.push(r)
    b = DynamicBatcher(max_batch=8, max_wait_ms=5.0, clock=clock).form(
        q, timeout=0.01)
    assert [r.rows for r in b.requests] == [1, 3, 2, 1], b.requests
    assert b.rows == 7 and b.padded_rows == 8, (b.rows, b.padded_rows)
    feed = b.feed()
    assert feed["x"].shape == (8, 4)

    # max_batch row cap: the 5th request stays queued
    q = SimpleQueue(clock=clock)
    for _ in range(5):
        q.push(Request({"x": np.zeros((2, 4), "float32")}))
    b = DynamicBatcher(max_batch=8, max_wait_ms=0.0, clock=clock).form(q)
    assert b.rows == 8 and q.depth() == 1, (b.rows, q.depth())

    # deadline: a lone request waits max_wait_ms on the fake clock, then
    # serves alone (the wait was recorded, nothing slept for real)
    clock = FakeClock()
    q = SimpleQueue(clock=clock)
    q.push(Request({"x": np.zeros((1, 4), "float32")}))
    t0 = clock.now()
    b = DynamicBatcher(max_batch=8, max_wait_ms=3.0, clock=clock).form(q)
    assert b.rows == 1 and clock.now() - t0 >= 3e-3 and clock.waits
    assert b.padded_rows == 1

    # signature isolation: different trailing shapes never mix
    q = SimpleQueue(clock=clock)
    q.push(Request({"x": np.zeros((1, 4), "float32")}))
    q.push(Request({"x": np.zeros((1, 8), "float32")}))
    b = DynamicBatcher(max_batch=8, max_wait_ms=0.0, clock=clock).form(q)
    assert b.rows == 1 and q.depth() == 1

    # oversize request serves whole, padded to its own pow2 bucket
    q = SimpleQueue(clock=clock)
    q.push(Request({"x": np.zeros((20, 4), "float32")}))
    b = DynamicBatcher(max_batch=8, max_wait_ms=0.0, clock=clock).form(q)
    assert b.rows == 20 and b.padded_rows == 32

    # non-row-wise output fails the batch with a typed ServingError
    r = Request({"x": np.zeros((2, 4), "float32")})
    bb = Batch([r])
    bb.scatter([np.float32(0.5)])   # a batch-reduced scalar fetch
    try:
        r.result(timeout=0)
        raise AssertionError("scalar fetch must fail the batch")
    except ServingError:
        pass

    # admission control: global bound + tenant quota, typed reasons
    tq = TenantQueue(max_queue=3, quotas={"a": 1}, clock=FakeClock())
    mk = lambda t: Request({"x": np.zeros((1, 2), "float32")}, tenant=t)
    assert tq.try_push(mk("a")) is None
    assert tq.try_push(mk("a")) == "tenant_quota"
    assert tq.try_push(mk("b")) is None
    assert tq.try_push(mk("b")) is None
    assert tq.try_push(mk("b")) == "queue_full"

    # weighted fair dequeue: weight 3:1 -> ~3x the rows under contention
    tq = TenantQueue(max_queue=64, weights={"a": 3.0, "b": 1.0},
                     clock=FakeClock())
    for _ in range(8):
        tq.try_push(mk("a"))
        tq.try_push(mk("b"))
    order = [tq.pop_first(timeout=0.01).tenant for _ in range(8)]
    assert order.count("a") == 6 and order.count("b") == 2, order


def _build_mlp(d: str, seed: int = 11, device="cpu") -> None:
    """Save a tiny 8->16->4 MLP inference model into ``d``."""
    import paddle_tpu_torch as pt

    main, startup = pt.Program(), pt.Program()
    main.random_seed = startup.random_seed = seed
    with pt.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.data("x", [8], "float32")
        y = pt.layers.fc(pt.layers.fc(x, 16, act="relu"), 4)
    exe = pt.Executor(device)
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        pt.io.save_inference_model(d, ["x"], [y], exe, main)


#: how far (``ulps_apart``) a batched row may lie from the solo run of the
#: same request on the CPU. A 1-row request runs its fc layers as a
#: matrix-vector product (MKL's gemv), a batch as a matrix product (gemm),
#: which sum each 8- or 16-term dot product in other orders: on the tiny
#: MLP a 1-row request moves by up to 3 ULPs at its row's scale in the port
#: and 2.5 in the JAX package (XLA CPU) on the same feeds. Requests of 2 or
#: more rows come back byte-equal on both.
CPU_SOLO_ULPS = 4


def ulps_apart(a, b, dtype: str = "float32") -> float:
    """Largest difference between ``a`` and ``b`` in units in the last place
    of each row's scale: per leading row, max|a - b| over the spacing of
    ``dtype`` at the row's largest magnitude. Reassociating a sum moves a
    result by a few roundings of its terms, whose size the row's scale
    bounds, not the result's own (a near-zero output of a cancelling sum
    has a tiny spacing of its own). bf16 outputs come back as float32
    (``Predictor.run``) and are measured in bf16's spacing."""
    import numpy as np
    a = np.asarray(a, np.float32).reshape(len(a), -1)
    b = np.asarray(b, np.float32).reshape(len(b), -1)
    if a.size == 0:
        return 0.0
    scale = np.maximum(np.abs(a).max(axis=1), np.abs(b).max(axis=1))
    ulp = np.spacing(scale.astype(np.float32)) * (65536.0 if dtype == "bfloat16" else 1.0)
    ulp = np.where(ulp > 0, ulp, np.float32(np.finfo(np.float32).tiny))
    return float((np.abs(a - b).max(axis=1) / ulp).max())


def _selftest_pool() -> None:
    """Stage 2: tiny-MLP pool round-trip on the CPU, within
    ``CPU_SOLO_ULPS`` of solo serving (the count of byte-equal outputs and
    the farthest distance are printed)."""
    import tempfile
    import threading

    import numpy as np

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.observability.export import to_dict
    from .pool import PredictorPool

    with tempfile.TemporaryDirectory() as d:
        _build_mlp(d)

        rng = np.random.RandomState(0)
        feeds = [rng.randn(n, 8).astype("float32") for n in (1, 2, 3, 1, 2)]
        solo = Predictor(d, device="cpu")
        refs = [solo.run({"x": f})[0] for f in feeds]

        pool = PredictorPool(d, size=2, max_batch=8, max_wait_ms=10.0,
                             max_queue=32, device="cpu")
        try:
            results = [None] * len(feeds)

            def client(i):
                results[i] = pool.run({"x": feeds[i]},
                                      tenant=f"t{i % 2}", timeout=120)[0]

            ts = [threading.Thread(target=client, args=(i,))
                  for i in range(len(feeds))]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            equal, worst = 0, 0.0
            for got, ref in zip(results, refs):
                assert got is not None, "a client got no answer"
                worst = max(worst, ulps_apart(got, ref))
                equal += got.tobytes() == ref.tobytes()
            assert worst <= CPU_SOLO_ULPS, \
                f"a batched output lies {worst} ULPs from solo Predictor.run"
            print(f"serving selftest: {equal} of {len(refs)} outputs byte-equal "
                  f"to solo, the farthest {worst} ULPs at its row's scale")
        finally:
            pool.close()
        # after close(drain=True) the workers are joined, so the in-flight
        # count is settled
        assert pool.in_flight == 0
        assert pool.queue_depth() == 0

        snap = to_dict()
        names = {f["name"] for f in snap.get("families", [])}
        for must in ("serving_batch_rows", "serving_request_seconds",
                     "serving_requests_total"):
            assert must in names, f"{must} missing from registry"


def selftest() -> int:
    _selftest_batcher()
    _selftest_pool()
    print("serving selftest: OK")
    return 0


# ------------------------------------------------------------------- chaos --

def chaos(secs: float = 2.0, qps: float = 400.0, device=None) -> int:
    """The serving chaos leg: drive a real PredictorPool (on ``device``, the
    card by default) under injected exc/hang/nan faults at open-loop load
    and assert the reliability invariants:

    A. poisoned-tenant load: ``exc@serve_dispatch`` pinned to the poison
       tenant + a transient ``hang@serve_dispatch`` on the clean one + one
       ``exc@serve_hang`` worker-thread death -- every affected request
       fails TYPED, the poison (tenant, signature) breaker opens and
       fast-fails, the crashed worker respawns, and the clean tenant's
       availability stays >= 99%;
    B. mid-load hot swap: ``pool.swap(model_dir)`` under clean traffic --
       zero shed, every output byte-equal to one of the two models solo,
       everything submitted after the swap completes on the new weights;
    C. deadline + wedged drain: ``hang@serve_hang`` wedges the only
       worker; deadline'd requests resolve typed RequestTimeout anyway
       (caller-side expiry) and ``close(drain_timeout=...)`` completes,
       failing the rest typed (``serve_drain_timeout`` journaled).

    Drain-to-zero holds at every phase boundary: zero stranded futures.
    """
    import json
    import tempfile
    import time

    import numpy as np

    from paddle_tpu_torch.inference import Predictor
    from paddle_tpu_torch.observability import journal as _journal
    from paddle_tpu_torch.resilience import faults
    from .batcher import RequestShed, RequestTimeout, ServingError
    from .breaker import BreakerOpen
    from .pool import PredictorPool

    def line(**kw):
        print(json.dumps(kw), flush=True)

    def harvest(futures):
        """result() every future; returns {future: outcome} with outcome
        "ok" or the typed error instance. Untyped errors are fatal."""
        out = {}
        for f in futures:
            try:
                f.result(timeout=30)
                out[f] = "ok"
            except ServingError as e:
                out[f] = e
            except TimeoutError:
                raise AssertionError(
                    "stranded future: request neither served nor failed "
                    "typed within 30s")
        return out

    rng = np.random.RandomState(0)
    clean_feed = {"x": rng.randn(1, 8).astype("float32")}
    poison_feed = {"x": rng.randn(1, 9).astype("float32")}   # poisoned shape

    with tempfile.TemporaryDirectory() as da, \
            tempfile.TemporaryDirectory() as db:
        _build_mlp(da, seed=11, device=device)
        _build_mlp(db, seed=29, device=device)
        ref_a = Predictor(da, device=device).run(clean_feed)[0]
        ref_b = Predictor(db, device=device).run(clean_feed)[0]
        assert ref_a.tobytes() != ref_b.tobytes(), "models must differ"

        # ---- phase A: poisoned tenant + worker death under load --------
        faults.clear()
        _journal.clear()
        faults.install("exc@serve_dispatch:var=poison:times=0;"
                       "hang@serve_dispatch:var=clean:times=2:seconds=0.02;"
                       "exc@serve_hang:times=1")
        pool = PredictorPool(da, size=2, max_batch=8, max_wait_ms=2.0,
                             max_queue=1024, default_deadline_ms=1000.0,
                             breaker_threshold=3, breaker_backoff_s=0.5,
                             check_outputs=True, device=device)
        try:
            pool.warmup(clean_feed)
            n = max(20, int(qps * secs))
            futures, breaker_fastfail, shed = [], 0, 0
            owner = []
            t0 = time.monotonic()
            for i in range(n):
                target = t0 + i / qps
                d = target - time.monotonic()
                if d > 0:
                    time.sleep(d)
                tenant = "poison" if i % 3 == 2 else "clean"
                try:
                    f = pool.submit(poison_feed if tenant == "poison"
                                    else clean_feed, tenant=tenant)
                    futures.append(f)
                    owner.append(tenant)
                except BreakerOpen:
                    breaker_fastfail += 1
                except RequestShed:
                    shed += 1
            outcomes = harvest(futures)
            pool.close(drain=True, drain_timeout=10.0)
            assert pool._pending == 0, \
                f"drain-to-zero violated: {pool._pending} pending"
            clean_ok = sum(1 for f, o in zip(futures, outcomes.values())
                           if f.tenant == "clean" and o == "ok")
            clean_n = sum(1 for t in owner if t == "clean")
            availability = clean_ok / max(1, clean_n)
            opened = [e for e in _journal.recent(event="serve_breaker")
                      if e.get("to") == "open"
                      and e.get("tenant") == "poison"]
            crashes = _journal.recent(event="serve_worker_crash")
            timeouts = sum(1 for o in outcomes.values()
                           if isinstance(o, RequestTimeout))
            line(phase="poisoned_tenant", submitted=n,
                 accepted=len(futures), breaker_fastfail=breaker_fastfail,
                 shed=shed, clean_availability=round(availability, 4),
                 poison_breaker_opens=len(opened),
                 worker_crashes=len(crashes), timeouts=timeouts)
            assert availability >= 0.99, \
                f"clean availability {availability:.1%} < 99% under " \
                f"poisoned-tenant chaos"
            assert opened, "poison breaker never opened"
            assert breaker_fastfail > 0, "no breaker fast-fails observed"
            assert crashes, "injected worker death not journaled"
        finally:
            faults.clear()

        # ---- phase B: hot swap mid-load --------------------------------
        _journal.clear()
        pool = PredictorPool(da, size=2, max_batch=8, max_wait_ms=2.0,
                             max_queue=1024, device=device)
        try:
            pool.warmup(clean_feed)
            futures, t_submit = [], []
            swap_done_at = [None]
            n = max(40, int(qps * secs))
            t0 = time.monotonic()
            swapped = False
            for i in range(n):
                target = t0 + i / qps
                d = target - time.monotonic()
                if d > 0:
                    time.sleep(d)
                if not swapped and i >= n // 2:
                    pool.swap(db)                     # mid-load, blocking
                    swap_done_at[0] = time.monotonic()
                    swapped = True
                futures.append(pool.submit(clean_feed, tenant="clean"))
                t_submit.append(time.monotonic())
            outcomes = harvest(futures)
            pool.close(drain=True, drain_timeout=10.0)
            assert all(o == "ok" for o in outcomes.values()), \
                "hot swap shed or failed requests"
            n_old = n_new = 0
            for f, ts in zip(futures, t_submit):
                got = f._result[0].tobytes()
                if got == ref_a.tobytes():
                    n_old += 1
                    assert ts <= swap_done_at[0], \
                        "request submitted after swap served OLD weights"
                elif got == ref_b.tobytes():
                    n_new += 1
                else:
                    raise AssertionError(
                        "output byte-equal to neither model: the swap "
                        "tore a batch")
            swaps = [e for e in _journal.recent(event="serve_swap")
                     if e.get("outcome") == "ok"]
            line(phase="hot_swap", requests=n, served_old=n_old,
                 served_new=n_new, shed=0,
                 model_version=pool.model_version,
                 swap_ms=swaps[0].get("swap_ms") if swaps else None)
            assert n_new > 0 and swaps and pool.model_version == 2
        finally:
            faults.clear()

        # ---- phase C: wedged worker -- deadlines + drain timeout -------
        _journal.clear()
        faults.install("hang@serve_hang:times=1:seconds=30")
        pool = PredictorPool(da, size=1, max_batch=8, max_wait_ms=2.0,
                             max_queue=64, device=device)
        try:
            time.sleep(0.1)          # let the worker wedge on the hang
            t0 = time.monotonic()
            deadlined = [pool.submit(clean_feed, tenant="clean",
                                     deadline_ms=80.0) for _ in range(3)]
            outcomes = harvest(deadlined)
            overshoot = max(max(0.0, f.t_done - f.deadline)
                            for f in deadlined)
            assert all(isinstance(o, RequestTimeout)
                       for o in outcomes.values()), \
                "wedged-worker requests must time out typed"
            stuck = [pool.submit(clean_feed, tenant="clean")
                     for _ in range(2)]
            t_close = time.monotonic()
            pool.close(drain=True, drain_timeout=0.4)
            close_s = time.monotonic() - t_close
            for f in stuck:
                try:
                    f.result(timeout=0)
                    raise AssertionError("stuck request served by a "
                                         "wedged worker?")
                except RequestShed as e:
                    assert e.reason == "closed"
            drains = _journal.recent(event="serve_drain_timeout")
            line(phase="wedged_drain", timeouts=len(deadlined),
                 max_deadline_overshoot_ms=round(overshoot * 1e3, 1),
                 close_seconds=round(close_s, 3),
                 drain_timeout_journaled=bool(drains))
            assert drains, "serve_drain_timeout not journaled"
            assert close_s < 5.0, "close() wedged behind a stuck worker"
            assert overshoot < 0.25, \
                f"deadline overshoot {overshoot * 1e3:.0f}ms too large"
        finally:
            faults.clear()

        # ---- nan poisoning: typed failure via check_outputs ------------
        _journal.clear()
        faults.install("nan@serve_fetch:var=nansy:times=0")
        pool = PredictorPool(da, size=1, max_batch=8, max_wait_ms=0.0,
                             max_queue=64, breaker_threshold=2,
                             breaker_backoff_s=5.0, check_outputs=True,
                             device=device)
        try:
            nan_typed = 0
            fastfail = 0
            for _ in range(6):
                try:
                    pool.run(clean_feed, tenant="nansy", timeout=30)
                except BreakerOpen:
                    fastfail += 1
                except ServingError as e:
                    assert "nonfinite" in str(e), e
                    nan_typed += 1
            pool.close(drain=True, drain_timeout=5.0)
            line(phase="nan_poison", typed_failures=nan_typed,
                 breaker_fastfail=fastfail)
            assert nan_typed >= 2 and fastfail >= 1
        finally:
            faults.clear()

    print("serving chaos: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving",
        description="serving tier: continuous batching + multi-tenant "
                    "Predictor pool")
    ap.add_argument("--selftest", action="store_true",
                    help="hermetic fake-clock batcher drills + tiny-MLP "
                         "pool round-trip")
    ap.add_argument("--chaos", action="store_true",
                    help="drive a real pool under injected exc/hang/nan "
                         "serving faults at load and assert the "
                         "deadline/breaker/swap/drain invariants")
    ap.add_argument("--secs", type=float, default=2.0,
                    help="chaos: seconds of open-loop load per phase")
    ap.add_argument("--qps", type=float, default=400.0,
                    help="chaos: offered load per phase")
    ap.add_argument("--device", default=None,
                    help="chaos: the pools' device (default: the card; 'cpu')")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if args.chaos:
        return chaos(secs=args.secs, qps=args.qps, device=args.device)
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
