"""Multi-tenant Predictor pool: admission control, weighted fair dequeue,
graceful drain -- the scheduling half of the serving tier (the port's copy
of ``paddle_tpu/serving/pool.py``).

``PredictorPool`` owns N :class:`~paddle_tpu_torch.inference.Predictor`
instances and N worker threads. Clients ``submit()`` (future) or ``run()``
(blocking); workers pull bucketed batches formed by
:class:`~paddle_tpu_torch.serving.batcher.DynamicBatcher` from a
:class:`TenantQueue` and serve them. On the card each worker's Predictor
replays one CUDA graph per (row bucket, signature, dtype); ``warmup``
captures them all before traffic, and a signature first seen under traffic
is captured by its worker in ``thread_local`` mode beside the other
workers' replays.

Admission control is explicit-shed, never unbounded memory: a full global
queue (``max_queue`` requests) or an exhausted per-tenant quota rejects the
submit with a typed :class:`~paddle_tpu_torch.serving.batcher.RequestShed` the
caller sees immediately. Dequeue across tenants is weighted-fair (stride
scheduling on served rows / weight), so one chatty tenant cannot starve
the rest; within a tenant order stays FIFO (only head-of-line requests
join a batch).

Serving dtype: ``dtype="auto"`` consults the ``serving.dtype``
``TunableChoice`` per (row-bucket, signature) -- under
``PADDLE_TPU_TUNE=search`` it times the Predictor's own executable for each
candidate dtype at the bucket (on the card, replays of its captured
graph); cached decisions are a dict lookup -- and passes the winner to
``Predictor.run(dtype=...)``. ``None``/``"float32"``/``"bfloat16"`` pin the
path.

Reliability (see the :class:`PredictorPool` docstring): per-request
deadlines (typed ``RequestTimeout``, evicted before batch assembly),
worker-crash containment + respawn, a per-(tenant, signature) circuit
breaker (``breaker.py``), checksum-verified hot model swap (copied into
the pinned tensors the graphs read: no capture), and a wedge-proof
``close(drain_timeout=...)`` -- all chaos-provable through the
``serve_dispatch``/``serve_fetch``/``serve_hang`` fault sites.

``PADDLE_TPU_OBS_SLO=rules.json`` arms the SLO engine
(``observability/slo.py``) at construction, as the JAX pool does: its
rules read the serving histograms and counters below.

Not ported (each raises when asked for, naming its ROADMAP item): the
warm store (``PADDLE_TPU_WARMSTORE``), sparse tables and ``apply_delta``
(the online path).

Observability (on the ``/metrics`` endpoint of ``observability/server.py``,
armed by ``PADDLE_TPU_OBS_PORT``): ``serving_queue_depth`` / ``serving_in_flight``
gauges, ``serving_batch_rows`` / ``serving_time_in_queue_seconds`` /
``serving_request_seconds{tenant}`` (the latency-SLO) histograms,
``serving_requests_total{tenant,outcome}`` + ``serving_shed_total
{tenant,reason}`` counters + ``serving_timeout_total`` /
``serving_worker_crash_total`` / ``serving_swap_total`` and the
``serving_breaker_state`` / ``serving_model_version`` gauges, and
``serve_batch`` / ``serve_shed`` / ``serve_drain`` / ``serve_timeout`` /
``serve_breaker`` / ``serve_swap`` / ``serve_worker_crash`` /
``serve_drain_timeout`` journal events.
"""
from __future__ import annotations

import collections
import os
import threading
from typing import Dict, List, Optional

import numpy as np

from ..observability import blackbox as _blackbox
from ..observability import journal as _journal
from ..observability import server as _server
from ..observability.metrics import REGISTRY as _OBS
from ..resilience import faults as _faults
from ..tuning import choices as _choices
from .batcher import (Batch, Clock, DynamicBatcher, MonotonicClock, Request,
                      RequestShed, RequestTimeout, ServingError)
from .breaker import STATE_VALUES, BreakerOpen, CircuitBreaker, sig_id

__all__ = ["TenantQueue", "PredictorPool", "ServingDtype",
           "BATCH_ROWS_BUCKETS"]

#: serving_batch_rows histogram buckets: pow2 row buckets up to 512
BATCH_ROWS_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)

#: respawn storm: this many worker crashes inside the window means the
#: pool is thrashing, not recovering -- black-box it once
STORM_CRASHES = 3
STORM_WINDOW_S = 30.0


# --------------------------------------------------------------- fair queue --

class TenantQueue:
    """Bounded multi-tenant request queue with weighted fair dequeue.

    - global bound: at most ``max_queue`` queued requests, else shed
      ``queue_full``;
    - per-tenant quota: at most ``quotas[tenant]`` queued requests per
      tenant (``default_quota`` otherwise, None = unbounded up to the
      global cap), else shed ``tenant_quota``;
    - fairness: stride scheduling -- each tenant accrues virtual time
      ``rows / weight`` as its rows are served and the lowest virtual time
      goes next, so a weight-3 tenant gets ~3x the rows of a weight-1
      tenant under contention. A tenant waking from idle resumes at the
      current minimum active virtual time (no stored-up burst);
    - deadlines: a queued request whose ``deadline`` has passed is reaped
      on the next queue operation (and every wait is clamped to the
      earliest queued deadline, so expiry is noticed within one tick) --
      it is handed to ``on_expire`` instead of ever reaching a batch;
    - starvation bound: a head-of-line request bypassed ``max_head_bypass``
      times by sig-compatible fill attempts it was oversize for is marked
      ``solo``; solo heads jump the fair order and the batcher dispatches
      them alone (conservative: a single batch formation can count several
      bypasses, so the cap is an upper bound on bypassing batches).
    """

    def __init__(self, max_queue: int = 128,
                 quotas: Optional[Dict[str, int]] = None,
                 weights: Optional[Dict[str, float]] = None,
                 default_quota: Optional[int] = None,
                 clock: Optional[Clock] = None,
                 max_head_bypass: int = 8,
                 on_expire=None):
        if int(max_queue) < 1:
            raise ValueError("max_queue must be >= 1")
        if int(max_head_bypass) < 1:
            raise ValueError("max_head_bypass must be >= 1")
        self.max_queue = int(max_queue)
        self.quotas = dict(quotas or {})
        self.weights = dict(weights or {})
        self.default_quota = default_quota
        self.max_head_bypass = int(max_head_bypass)
        #: called (outside any batch) with each deadline-expired request;
        #: the pool resolves it with a typed RequestTimeout
        self.on_expire = on_expire
        self._clock = clock or MonotonicClock()
        self._cond = threading.Condition()
        self._tenants: Dict[str, List[Request]] = {}
        self._vt: Dict[str, float] = {}
        self._depth = 0
        self._closed = False
        #: earliest deadline among queued requests (inf = none): reap and
        #: wait-clamping both key off this, so the deadline-free hot path
        #: costs one float compare per operation
        self._next_deadline = float("inf")

    def _weight(self, tenant: str) -> float:
        w = float(self.weights.get(tenant, 1.0))
        return w if w > 0 else 1.0

    def depth(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return self._depth
        return len(self._tenants.get(tenant, ()))

    def try_push(self, req: Request) -> Optional[str]:
        """Admit ``req`` or return the shed reason (caller raises)."""
        with self._cond:
            if self._closed:
                return "closed"
            if self._depth >= self.max_queue:
                return "queue_full"
            quota = self.quotas.get(req.tenant, self.default_quota)
            dq = self._tenants.get(req.tenant)
            if quota is not None and dq is not None and len(dq) >= int(quota):
                return "tenant_quota"
            if quota is not None and dq is None and int(quota) <= 0:
                return "tenant_quota"
            if dq is None:
                dq = self._tenants[req.tenant] = []
            if not dq:
                # waking from idle: resume at the active minimum so idle
                # time is not banked into a starvation-inducing burst
                active = [self._vt[t] for t, q in self._tenants.items()
                          if q and t != req.tenant]
                floor = min(active) if active else 0.0
                self._vt[req.tenant] = max(
                    self._vt.get(req.tenant, 0.0), floor)
            dq.append(req)
            self._depth += 1
            if req.deadline is not None and \
                    req.deadline < self._next_deadline:
                self._next_deadline = req.deadline
            self._cond.notify_all()
            return None

    def _reap_locked(self) -> Optional[List[Request]]:
        """Evict every queued request whose deadline has passed (caller
        holds the lock) and return them -- they are never handed to a
        batch, so dead requests never occupy batch rows. The caller hands
        them to ``on_expire`` AFTER releasing the lock (``_flush_expired``)
        so a burst of expiries never serializes submits and other workers
        behind per-request metrics/journal work."""
        now = self._clock.now()
        if now < self._next_deadline:
            return None
        expired: List[Request] = []
        nxt = float("inf")
        for t, dq in self._tenants.items():
            keep = []
            for r in dq:
                if r.done() or (r.deadline is not None
                                and now >= r.deadline):
                    # expired here, or already resolved externally
                    # (caller-side deadline wait): drop it from the queue
                    expired.append(r)
                else:
                    keep.append(r)
                    if r.deadline is not None and r.deadline < nxt:
                        nxt = r.deadline
            if len(keep) != len(dq):
                self._tenants[t] = keep
        self._depth -= len(expired)
        self._next_deadline = nxt
        return expired or None

    def _flush_expired(self, expired: Optional[List[Request]]) -> None:
        if expired and self.on_expire is not None:
            for r in expired:
                self.on_expire(r)

    def _wait_clamp(self, timeout: float) -> float:
        """Clamp a cond-wait so the earliest queued deadline is noticed
        when it passes, not a full idle poll later."""
        if self._next_deadline == float("inf"):
            return timeout
        until = self._next_deadline - self._clock.now()
        return max(1e-4, min(timeout, until))

    def _fair_order(self) -> List[str]:
        """Non-empty tenants, lowest virtual time first (name tiebreak).
        Tenants whose head hit the bypass cap jump the order -- their next
        dispatch is overdue by construction."""
        return sorted((t for t, q in self._tenants.items() if q),
                      key=lambda t: (not self._tenants[t][0].solo,
                                     self._vt.get(t, 0.0), t))

    def _account(self, req: Request) -> None:
        self._vt[req.tenant] = (self._vt.get(req.tenant, 0.0)
                                + req.rows / self._weight(req.tenant))
        self._depth -= 1

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain_pending(self) -> List[Request]:
        """Remove and return everything queued (non-graceful close path)."""
        with self._cond:
            out = [r for t in sorted(self._tenants) for r in self._tenants[t]]
            self._tenants.clear()
            self._depth = 0
            self._next_deadline = float("inf")
            return out

    # -- batcher protocol --------------------------------------------------
    def pop_first(self, timeout: float) -> Optional[Request]:
        deadline = self._clock.now() + timeout
        while True:
            req = None
            settled = False
            with self._cond:
                expired = self._reap_locked()
                order = self._fair_order()
                if order:
                    req = self._tenants[order[0]].pop(0)
                    self._account(req)
                    settled = True
                elif self._closed:
                    settled = True
                else:
                    remaining = deadline - self._clock.now()
                    if remaining <= 0:
                        settled = True
                    else:
                        self._clock.wait(self._cond,
                                         self._wait_clamp(remaining))
            self._flush_expired(expired)
            if settled:
                return req

    def pop_compatible(self, sig, max_rows: int) -> Optional[Request]:
        """Fair-order scan of head-of-line requests only (per-tenant FIFO
        is never reordered to fill a batch). A sig-compatible head too big
        for the remaining space counts a bypass; at ``max_head_bypass`` it
        goes solo (see class docstring)."""
        found = None
        with self._cond:
            expired = self._reap_locked()
            for t in self._fair_order():
                head = self._tenants[t][0]
                if head.sig == sig and head.rows <= max_rows:
                    self._tenants[t].pop(0)
                    self._account(head)
                    found = head
                    break
                if head.sig == sig and head.rows > max_rows \
                        and not head.solo:
                    head.bypassed += 1
                    if head.bypassed >= self.max_head_bypass:
                        head.solo = True
        self._flush_expired(expired)
        return found

    def wait_for_more(self, timeout: float) -> None:
        # called only after pop_compatible found nothing usable: wait for a
        # push (an unconditional cond-wait -- returning early just because
        # incompatible heads are queued would busy-spin the batcher)
        with self._cond:
            if not self._closed:
                self._clock.wait(self._cond, self._wait_clamp(timeout))


# ------------------------------------------------------- serving.dtype knob --

class ServingDtype(_choices.TunableChoice):
    id = "serving.dtype"
    doc = ("numeric path the serving tier runs a shape bucket in: "
           "'float32' (native) or 'bfloat16' (half-precision pinned state "
           "+ cast feeds, the AnalysisConfig.enable_bfloat16 path). "
           "Measured per (row-bucket, feed-signature) by timing the "
           "Predictor's own executable; default = the pool's configured "
           "dtype.")

    def bucket(self, params: dict):
        return {"rows": _choices.pow2_bucket(int(params["rows"])),
                "sig": str(params["sig"])}

    def candidates(self, params: dict) -> List[str]:
        return ["float32", "bfloat16"]

    def default(self, params: dict) -> str:
        return params.get("configured") or "float32"

    def bench(self, params: dict, candidate):
        """The predictor's executable for ``candidate`` at the bucket, fed
        zeros of the signature: its first call builds it (on the card, the
        warm-up and the capture of its graph: ``compile_ms``), every later
        call is a replay."""
        pred = params.get("predictor")
        if pred is None:
            return None   # offline tuning without a loaded model
        rows = _choices.pow2_bucket(int(params["rows"]))
        feed = {name: np.zeros((rows,) + tuple(trail), dtype)
                for name, trail, dtype in params["sig_parts"]}
        feeds = pred._feed_tensors(feed, candidate)

        def fn(feeds):
            exe, _ = pred._executable(feeds, candidate)
            with exe.lock:
                return exe(feeds)

        return fn, (feeds,)


if "serving.dtype" not in _choices.list_choices():
    _choices.register_choice(ServingDtype())


# -------------------------------------------------------------------- pool --

class PredictorPool:
    """N Predictors + N workers serving batched multi-tenant traffic.

    Reliability contract: every accepted request resolves with a result or
    a TYPED error -- never a hang, never a stranded future:

    - **deadlines**: ``submit(feed, deadline_ms=...)`` (or the pool-wide
      ``default_deadline_ms``); an expired request is evicted before batch
      assembly and resolved :class:`RequestTimeout`, and a caller blocked
      in ``result()`` self-expires even if every worker is wedged;
    - **worker-crash recovery**: a predictor exception fails only that
      batch (typed :class:`ServingError`); an unexpected worker-thread
      death journals ``serve_worker_crash`` and respawns the worker;
    - **circuit breaking**: ``breaker_threshold`` consecutive batch
      failures on one (tenant, signature) open its breaker -- submits
      fast-fail :class:`~paddle_tpu_torch.serving.breaker.BreakerOpen` until a
      half-open probe succeeds (state on ``serving_breaker_state``,
      transitions journaled ``serve_breaker``);
    - **hot swap**: :meth:`swap` stages new weights, verifies them
      (checksum manifests, ``io.verify_checkpoint``), and rotates each
      predictor atomically between batches -- in-flight batches finish on
      the old weights; the new ones are copied into the tensors the
      captured graphs read, so nothing is captured again;
    - **chaos**: ``serve_dispatch``/``serve_fetch``/``serve_hang`` fault
      sites (``resilience/faults.py``) drive all of the above under
      ``python -m paddle_tpu_torch.serving --chaos``; with nothing armed the
      hot-path cost is one module-attribute truthiness check.
    """

    def __init__(self, model_dir: Optional[str] = None, *,
                 size: int = 1,
                 predictors: Optional[List[object]] = None,
                 max_batch: int = 32, max_wait_ms: float = 2.0,
                 max_queue: int = 128,
                 quotas: Optional[Dict[str, int]] = None,
                 weights: Optional[Dict[str, float]] = None,
                 default_quota: Optional[int] = None,
                 dtype: Optional[str] = None,
                 model_filename=None, params_filename=None,
                 clock: Optional[Clock] = None,
                 idle_poll_s: float = 0.05,
                 default_deadline_ms: Optional[float] = None,
                 max_head_bypass: int = 8,
                 breaker_threshold: int = 5,
                 breaker_backoff_s: float = 1.0,
                 breaker_backoff_max_s: float = 30.0,
                 check_outputs: bool = False,
                 start_workers: bool = True,
                 sparse_tables: Optional[Dict[str, object]] = None,
                 device=None):
        if dtype not in (None, "auto", "float32", "bfloat16"):
            raise ValueError(
                f"pool dtype {dtype!r} invalid; use None, 'auto', "
                f"'float32' or 'bfloat16'")
        if sparse_tables:
            raise NotImplementedError(
                "PredictorPool(sparse_tables=...): sparse tables and the online delta "
                "push are not ported (ROADMAP item 10, its online part)")
        # one env read when PADDLE_TPU_OBS_SLO is unset; a bad rules file
        # raises SLOConfigError here, before any worker starts
        from ..observability import slo as _slo
        _slo.maybe_arm()
        if predictors is None:
            if model_dir is None:
                raise ValueError("PredictorPool needs model_dir or "
                                 "predictors=[...]")
            if int(size) < 1:
                raise ValueError("size must be >= 1")
            from ..inference import Predictor
            session_dtype = dtype if dtype in ("float32", "bfloat16") else None
            predictors = [Predictor(model_dir, model_filename,
                                    params_filename, dtype=session_dtype,
                                    device=device)
                          for _ in range(int(size))]
        self._dtype = dtype
        self._predictors = list(predictors)
        self._clock = clock or MonotonicClock()
        self._idle_poll_s = float(idle_poll_s)
        self._default_deadline_ms = (None if default_deadline_ms is None
                                     else float(default_deadline_ms))
        #: nonfinite-output check per batch (off by default: row-wise
        #: models do not manufacture NaN; the chaos harness turns it on so
        #: nan@serve_fetch poison fails typed and trips the breaker)
        self._check_outputs = bool(check_outputs)
        self._queue = TenantQueue(max_queue=max_queue, quotas=quotas,
                                  weights=weights,
                                  default_quota=default_quota,
                                  clock=self._clock,
                                  max_head_bypass=max_head_bypass,
                                  on_expire=self._expire)
        self._batcher = DynamicBatcher(max_batch=max_batch,
                                       max_wait_ms=max_wait_ms,
                                       clock=self._clock)
        self._breaker = CircuitBreaker(threshold=breaker_threshold,
                                       backoff_s=breaker_backoff_s,
                                       backoff_max_s=breaker_backoff_max_s,
                                       clock=self._clock,
                                       on_transition=self._breaker_event)
        self._lock = threading.Lock()
        self._in_flight = 0
        # accepted-but-unresolved requests: the drain condition. Queue depth
        # + in-flight has a pop->mark window a drain poll could thread
        # through; this counter moves atomically at submit and resolve.
        self._pending = 0
        self._draining = False
        self._stopped = False
        #: monotone batch sequence (the `step` serving faults match on)
        self._batch_seq = 0
        #: per-worker batch currently executing (drain-timeout fail path)
        self._current: Dict[int, Batch] = {}
        # hot swap staging: workers apply `_staged_state` between batches
        # when their generation lags `_swap_gen`
        self._swap_cond = threading.Condition()
        self._swap_gen = 0
        self._staged_state: Optional[Dict[str, object]] = None
        self._swap_applied: Dict[int, int] = {}
        self._model_version = max(
            [int(getattr(p, "model_version", 1))
             for p in self._predictors] or [1])
        self._staged_version = self._model_version
        # the serving tier IS a long-lived server: arm the live /metrics
        # endpoint if the operator exported PADDLE_TPU_OBS_PORT (one env
        # read when unset)
        _server.maybe_start()
        self._g_depth = _OBS.gauge(
            "serving_queue_depth", "queued serving requests")
        self._g_inflight = _OBS.gauge(
            "serving_in_flight", "serving requests dequeued, not yet done")
        self._g_version = _OBS.gauge(
            "serving_model_version", "weight generation being served")
        self._g_version.set(self._model_version)
        # model freshness: now - last successful swap finalize (the load
        # at construction counts as generation zero's "swap").  The gauge
        # is recomputed on demand -- each /metrics scrape runs the
        # registered refresher -- so an idle pool still ages visibly.
        self._last_swap_t = self._clock.now()
        self._g_staleness = _OBS.gauge(
            "model_staleness_seconds",
            "seconds since the served weights were last refreshed")
        self._g_staleness.set(0.0)
        _server.register_refresher(self._export_staleness)
        #: worker-crash timestamps for respawn-storm detection
        self._crash_times: "collections.deque" = collections.deque(maxlen=32)
        self._storm_reported = False
        self._h_rows = _OBS.histogram(
            "serving_batch_rows", "real rows per served batch",
            buckets=BATCH_ROWS_BUCKETS)
        self._h_queue_s = _OBS.histogram(
            "serving_time_in_queue_seconds",
            "submit -> batch-formation wait per request")
        # per-tenant metric handles, resolved once: the registry's
        # family+label lookup is cheap but not free, and the worker loop
        # touches these per REQUEST at thousands of QPS
        self._tenant_metrics: Dict[str, tuple] = {}
        self._workers: List[threading.Thread] = []
        if start_workers:
            self._workers = [
                threading.Thread(target=self._worker, args=(i, p),
                                 name=f"serving-worker-{i}", daemon=True)
                for i, p in enumerate(self._predictors)]
            for t in self._workers:
                t.start()

    # -- client API --------------------------------------------------------
    def submit(self, feed, tenant: str = "default",
               deadline_ms: Optional[float] = None) -> Request:
        """Enqueue one request; returns a future (``.result(timeout)``).
        Raises :class:`RequestShed` immediately when admission fails
        (including :class:`BreakerOpen` for a tripped (tenant, signature)).
        ``deadline_ms`` bounds submit->response; past it the request is
        evicted from the queue and resolved :class:`RequestTimeout`
        (``None`` = the pool's ``default_deadline_ms``)."""
        now = self._clock.now()
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        deadline = None if deadline_ms is None else now + deadline_ms / 1e3
        req = Request(feed, tenant=tenant, t_submit=now, deadline=deadline)
        req._clock = self._clock
        req._expire_cb = self._expire
        if self._draining or self._stopped:
            self._shed(tenant, "closed")
        allowed, state, retry_in = self._breaker.allow((tenant, req.sig))
        if not allowed:
            self._shed(tenant, "breaker_open",
                       exc=BreakerOpen(tenant, sig_id(req.sig), retry_in))
        reason = self._queue.try_push(req)
        if reason is not None:
            self._shed(tenant, reason)
        with self._lock:
            self._pending += 1
        if self._stopped and not req.done():
            # close() raced this submit between the _draining check and the
            # push: the workers are gone, so resolve the request typed
            # instead of stranding it
            with self._lock:
                self._pending -= 1
            req.set_exception(RequestShed("closed", tenant))
            self._shed(tenant, "closed")
        self._g_depth.set(self._queue.depth())
        self._metrics_for(tenant)[1].inc()
        return req

    def _metrics_for(self, tenant: str) -> tuple:
        """(slo histogram, accepted, ok, error, timeout) handles for one
        tenant."""
        m = self._tenant_metrics.get(tenant)
        if m is None:
            req_total = lambda outcome: _OBS.counter(
                "serving_requests_total",
                "serving requests by tenant and outcome",
                tenant=tenant, outcome=outcome)
            m = (_OBS.histogram(
                    "serving_request_seconds",
                    "end-to-end serving latency (submit -> response)",
                    tenant=tenant),
                 req_total("accepted"), req_total("ok"),
                 req_total("error"), req_total("timeout"))
            self._tenant_metrics[tenant] = m
        return m

    def run(self, feed, tenant: str = "default",
            timeout: Optional[float] = 60.0,
            deadline_ms: Optional[float] = None) -> List[np.ndarray]:
        """Blocking submit: outputs ordered as the model's fetch_names,
        byte-equal to a solo ``Predictor.run`` of the same feed."""
        return self.submit(feed, tenant=tenant,
                           deadline_ms=deadline_ms).result(timeout)

    def _shed(self, tenant: str, reason: str,
              exc: Optional[RequestShed] = None):
        _OBS.counter("serving_requests_total",
                     "serving requests by tenant and outcome",
                     tenant=tenant, outcome="shed").inc()
        _OBS.counter("serving_shed_total",
                     "shed serving requests by tenant and reason",
                     tenant=tenant, reason=reason).inc()
        _journal.emit({"event": "serve_shed", "tenant": tenant,
                       "reason": reason})
        raise exc if exc is not None else RequestShed(reason, tenant)

    def _expire(self, req: Request) -> None:
        """Resolve one deadline-expired request typed (idempotent: queue
        reap, batch-assembly pruning and the caller-side result() wait all
        funnel here; only the winner accounts it)."""
        waited_ms = max(0.0, (self._clock.now() - req.t_submit) * 1e3)
        budget_ms = max(0.0, (req.deadline - req.t_submit) * 1e3) \
            if req.deadline is not None else 0.0
        if not req.set_exception(
                RequestTimeout(req.tenant, waited_ms, budget_ms)):
            return            # already resolved elsewhere; nothing to account
        with self._lock:
            self._pending -= 1
        m = self._metrics_for(req.tenant)
        m[0].observe(waited_ms / 1e3)
        m[4].inc()
        _OBS.counter("serving_timeout_total",
                     "deadline-expired serving requests by tenant",
                     tenant=req.tenant).inc()
        _journal.emit({"event": "serve_timeout", "tenant": req.tenant,
                       "waited_ms": round(waited_ms, 3),
                       "deadline_ms": round(budget_ms, 3)})

    def _breaker_event(self, key, old: str, new: str, entry) -> None:
        """CircuitBreaker transition callback: journal + gauge mirror."""
        tenant, sig = key
        sid = sig_id(sig)
        _OBS.gauge("serving_breaker_state",
                   "circuit state per tenant/signature "
                   "(0=closed 1=half_open 2=open)",
                   tenant=tenant, sig=sid).set(STATE_VALUES[new])
        _OBS.counter("serving_breaker_transitions_total",
                     "breaker transitions by new state",
                     to=new).inc()
        _journal.emit({"event": "serve_breaker", "tenant": tenant,
                       "sig": sid, "from": old, "to": new,
                       "failures": entry.failures,
                       "backoff_s": round(entry.backoff, 3)})

    # -- worker ------------------------------------------------------------
    def _decide_dtype(self, batch: Batch, pred) -> Optional[str]:
        if self._dtype != "auto":
            return None if self._dtype is None else self._dtype
        params = {"rows": batch.padded_rows, "sig": batch.sig,
                  "sig_parts": batch.sig, "predictor": pred,
                  "configured": "float32"}
        return _choices.decide("serving.dtype", params)

    def _worker(self, idx: int, pred) -> None:
        """Worker thread body: the serve loop plus crash containment -- an
        escape from the loop (anything the per-batch handler did not
        contain) journals ``serve_worker_crash`` and respawns the worker,
        so an unexpected exception can never silently shrink the pool."""
        try:
            self._worker_loop(idx, pred)
        except BaseException as e:
            if self._stopped:
                return
            _OBS.counter("serving_worker_crash_total",
                         "serving worker threads that died and were "
                         "respawned").inc()
            _journal.emit({"event": "serve_worker_crash", "worker": idx,
                           "error": f"{type(e).__name__}: {e}"[:200]})
            now = self._clock.now()
            self._crash_times.append(now)
            storm = [t for t in self._crash_times
                     if t >= now - STORM_WINDOW_S]
            if len(storm) >= STORM_CRASHES and not self._storm_reported:
                # crashing faster than respawning helps: journal once and
                # black-box the evidence (workers keep respawning -- the
                # containment contract stands, but someone must look)
                self._storm_reported = True
                _journal.emit({"event": "serve_respawn_storm",
                               "crashes": len(storm),
                               "window_s": STORM_WINDOW_S})
                _blackbox.maybe_write(
                    "respawn_storm", error=e,
                    extra={"worker": idx, "crashes": len(storm),
                           "window_s": STORM_WINDOW_S})
            with self._lock:
                if self._stopped:
                    return
                t = threading.Thread(target=self._worker, args=(idx, pred),
                                     name=f"serving-worker-{idx}",
                                     daemon=True)
                if idx < len(self._workers):
                    self._workers[idx] = t
            t.start()

    def _worker_loop(self, idx: int, pred) -> None:
        while True:
            if self._serve_once(idx, pred) is None and self._stopped \
                    and self._queue.depth() == 0:
                return

    def _serve_once(self, idx: int, pred):
        """One scheduler turn: apply a pending weight swap, form a batch,
        prune expired requests, serve. Returns the served batch (None on
        an idle tick). Separated from the thread loop so hermetic tests
        can drive it synchronously under FakeClock."""
        if _faults._active:
            # serve_hang: the worker-loop site OUTSIDE any batch -- a hang
            # here wedges this worker (nothing else), an exc kills the
            # thread and exercises the respawn path
            _faults.fire("serve_hang", step=self._batch_seq)
        self._apply_swap(idx, pred)
        batch = self._batcher.form(self._queue, timeout=self._idle_poll_s)
        self._g_depth.set(self._queue.depth())
        if batch is None:
            return None
        batch = self._prune_expired(batch)
        if batch is None:
            return None
        self._serve_batch(idx, pred, batch)
        return batch

    def _prune_expired(self, batch: Batch) -> Optional[Batch]:
        """Deadline eviction at batch assembly: requests that expired
        after being dequeued (mid-wait, during coalescing) resolve typed
        and never occupy batch rows. Returns the pruned batch (None when
        nothing is left to serve)."""
        now = self._clock.now()
        expired = [r for r in batch.requests
                   if (r.deadline is not None and now >= r.deadline)
                   or r.done()]
        if not expired:
            return batch
        for r in expired:
            self._expire(r)
        live = [r for r in batch.requests if r not in expired]
        return Batch(live) if live else None

    def _apply_swap(self, idx: int, pred) -> None:
        """Between-batches weight rotation: when a swap is staged, replace
        this worker's predictor state and acknowledge (the last rotation
        finalizes the pool's model_version). In-flight batches are
        untouched -- this runs strictly between form() calls."""
        with self._swap_cond:
            gen = self._swap_gen
            if self._swap_applied.get(idx, 0) >= gen:
                return
            state = self._staged_state
            version = self._staged_version
        pred.swap_state(state, model_version=version)
        with self._swap_cond:
            self._swap_applied[idx] = gen
            done = all(self._swap_applied.get(i, 0) >= gen
                       for i in range(len(self._predictors)))
            self._swap_cond.notify_all()
        if done:
            self._finish_swap(version)

    def _serve_batch(self, idx: int, pred, batch: Batch) -> None:
        import time
        with self._lock:
            self._in_flight += len(batch.requests)
            self._batch_seq += 1
            seq = self._batch_seq
            self._current[idx] = batch
        self._g_inflight.set(self._in_flight)
        tenants: Dict[str, int] = {}
        for r in batch.requests:
            tenants[r.tenant] = tenants.get(r.tenant, 0) + r.rows
        tags = tuple(sorted(tenants))
        version = int(getattr(pred, "model_version", self._model_version))
        t_form = self._clock.now()
        t0 = time.perf_counter()
        error = None
        resolved = 0
        try:
            dt = self._decide_dtype(batch, pred)
            if _faults._active:
                _faults.fire("serve_dispatch", step=seq, tags=tags)
            outs = pred.run(batch.feed(), dtype=dt)
            if _faults._active:
                _faults.fire("serve_fetch", step=seq, tags=tags)
                outs = _faults.corrupt_serving(outs, step=seq, tags=tags)
            if self._check_outputs:
                self._check_finite(outs)
            resolved = batch.scatter(outs)
        except BaseException as e:   # a failed batch fails its requests
            error = e if isinstance(e, ServingError) else \
                ServingError(f"batch execution failed: "
                             f"{type(e).__name__}: {e}")
            resolved = batch.fail(error)
            dt = None
        finally:
            # _pending moves only by futures THIS batch resolved: a
            # request a racing deadline (or drain timeout) already
            # resolved was accounted by that winner
            with self._lock:
                self._in_flight -= len(batch.requests)
                self._pending -= resolved
                self._current.pop(idx, None)
            self._g_inflight.set(self._in_flight)
        if error is None and batch.failed_exc is not None:
            error = batch.failed_exc   # scatter's internal typed rejection
        # batch outcome -> breaker, per (tenant, signature) present. Blame
        # is batch-granular: a healthy tenant co-batched with a poisoned
        # same-sig one takes collateral failures, but recovers after one
        # backoff -- once the poisoned key is open its requests stop
        # entering batches, so the healthy key's probe succeeds (see
        # breaker.py docstring)
        for t in tenants:
            key = (t, batch.sig)
            if error is None:
                self._breaker.record_success(key)
            else:
                self._breaker.record_failure(key)
        exec_ms = (time.perf_counter() - t0) * 1e3
        ok = 0
        t_done = self._clock.now()
        for r in batch.requests:
            # account only requests THIS batch resolved: one resolved by a
            # racing deadline (or drain-timeout shed) was already counted
            # by that winner -- outcomes must partition accepted requests
            mine = (r._error is None) if error is None \
                else (r._error is error)
            if not mine:
                continue
            self._h_queue_s.observe(max(0.0, t_form - r.t_submit))
            m = self._metrics_for(r.tenant)
            # the latency-SLO histogram: submit -> response, per tenant
            m[0].observe(max(0.0, t_done - r.t_submit))
            if r._error is None:
                ok += 1
                m[2].inc()
            else:
                m[3].inc()
        self._h_rows.observe(batch.rows)
        _OBS.counter("serving_batches_total", "served batches").inc()
        _journal.emit({
            "event": "serve_batch", "requests": len(batch.requests),
            "rows": batch.rows, "padded_rows": batch.padded_rows,
            "exec_ms": round(exec_ms, 3), "dtype": dt or "native",
            "ok": ok, "tenants": tenants, "model_version": version,
            "error": None if error is None else str(error)[:120]})

    @staticmethod
    def _check_finite(outs) -> None:
        for i, o in enumerate(outs):
            arr = np.asarray(o)
            dt = str(arr.dtype)
            if ("float" in dt or "bfloat" in dt) and \
                    not np.all(np.isfinite(np.asarray(arr, np.float32))):
                raise ServingError(
                    f"fetch #{i} contains nonfinite values "
                    f"(check_outputs=True)")

    def warmup(self, feed, buckets: Optional[List[int]] = None) -> int:
        """Build the executable for every pow2 row bucket (up to
        ``max_batch``, or ``buckets``) on every predictor, in the dtype the
        pool would serve that bucket in -- on the card, the capture of each
        bucket's CUDA graph -- so no served request captures one. Returns
        the number of (predictor, bucket) pairs warmed."""
        if os.environ.get("PADDLE_TPU_WARMSTORE"):
            raise NotImplementedError(
                "PADDLE_TPU_WARMSTORE is set, but the warm store (warmstore/) is not "
                "ported (ROADMAP item 12)")
        probe = Request(feed)
        if buckets is None:
            cap = _choices.pow2_bucket(self._batcher.max_batch)
            buckets = [1 << i for i in range(cap.bit_length())]
        sizes = sorted({_choices.pow2_bucket(int(b)) for b in buckets})
        warmed = 0
        for b in sizes:
            f = {k: np.repeat(v[:1], b, axis=0)
                 for k, v in probe.feed.items()}
            batch = Batch([Request(f)])
            for pred in self._predictors:
                pred.run(f, dtype=self._decide_dtype(batch, pred))
                warmed += 1
        return warmed

    # -- hot swap ----------------------------------------------------------
    @property
    def model_version(self) -> int:
        """Weight generation currently served by the whole pool (bumped
        when a swap has rotated every predictor)."""
        return self._model_version

    def model_staleness_seconds(self) -> float:
        """Seconds since the served weights were last refreshed (the
        construction-time load counts as the first refresh)."""
        return max(0.0, self._clock.now() - self._last_swap_t)

    def _export_staleness(self) -> None:
        self._g_staleness.set(round(self.model_staleness_seconds(), 3))

    def swap(self, model_dir: Optional[str] = None, *,
             state: Optional[Dict[str, object]] = None,
             verify: bool = True, wait: bool = True,
             timeout: float = 60.0) -> int:
        """Hot model swap: stage new weights, verify, rotate atomically.

        ``model_dir`` names a ``save_inference_model`` directory whose
        chunk manifests are first checked against the checksum machinery
        (``io.verify_checkpoint``, crc level) -- a torn or bit-flipped push
        is rejected typed BEFORE anything is staged; ``state`` passes a
        name->array dict directly. The staged weights are validated against
        the live predictors (identical names/shapes/dtypes, so the graphs
        stay valid), then each worker
        rotates its predictor strictly BETWEEN batches: in-flight batches
        finish on the old weights, the next batch serves the new, and
        journal events + ``/metrics`` carry the bumped ``model_version``.
        No request is shed by a swap.  Returns the new model version
        (with ``wait=True``, after every predictor has rotated)."""
        import time
        if (model_dir is None) == (state is None):
            raise ValueError("swap() needs exactly one of model_dir= or "
                             "state=")
        t0 = time.perf_counter()
        if model_dir is not None:
            state = self._load_swap_state(model_dir, verify=verify)
        # validate against one live predictor before staging: a shape or
        # dtype mismatch is typed rejection, not a wedged worker later (a
        # "sparse:<table>" key raises NotImplementedError: not ported)
        try:
            self._predictors[0].swap_state(state, validate_only=True)
        except ValueError as e:
            _OBS.counter("serving_swap_total", "hot swaps by outcome",
                         outcome="rejected").inc()
            _journal.emit({"event": "serve_swap", "outcome": "rejected",
                           "error": str(e)[:200]})
            raise ServingError(f"swap rejected: {e}")
        with self._swap_cond:
            self._staged_state = state
            self._swap_gen += 1
            gen = self._swap_gen
            target = self._model_version + 1
            self._staged_version = target
            self._swap_t0 = t0
        if not self._workers:
            # hermetic pools (start_workers=False): rotation happens when
            # the test drives _serve_once; nothing to wait for here
            wait = False
        if wait:
            deadline = time.monotonic() + timeout
            with self._swap_cond:
                while any(self._swap_applied.get(i, 0) < gen
                          for i in range(len(self._predictors))):
                    if self._stopped:
                        raise ServingError("swap interrupted: pool closed")
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        behind = sum(
                            1 for i in range(len(self._predictors))
                            if self._swap_applied.get(i, 0) < gen)
                        raise ServingError(
                            f"swap incomplete after {timeout}s: {behind} "
                            f"predictor(s) not rotated")
                    self._swap_cond.wait(min(remaining, 0.05))
            self._finish_swap(target, t0)
        return target

    def _finish_swap(self, target: int, t0: Optional[float] = None) -> None:
        import time
        with self._swap_cond:
            if self._model_version >= target:
                return
            self._model_version = target
            if t0 is None:
                t0 = getattr(self, "_swap_t0", None)
        self._g_version.set(target)
        self._last_swap_t = self._clock.now()
        self._g_staleness.set(0.0)
        _OBS.counter("serving_swap_total", "hot swaps by outcome",
                     outcome="ok").inc()
        ev = {"event": "serve_swap", "outcome": "ok",
              "model_version": target}
        if t0 is not None:
            ev["swap_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        _journal.emit(ev)

    # -- online partial hot push -------------------------------------------
    def apply_delta(self, delta: dict) -> int:
        """The JAX pool's partial hot push of a sparse-table delta: not
        ported (ROADMAP item 10, its online part)."""
        raise NotImplementedError(
            "PredictorPool.apply_delta: sparse tables and the online delta push are "
            "not ported (ROADMAP item 10, its online part)")

    def _load_swap_state(self, model_dir: str,
                         verify: bool = True) -> Dict[str, object]:
        """Load + checksum-verify a pushed model directory into a host
        state dict matching the pool's pinned parameter set."""
        from .. import io as _io
        from ..core.executor import Scope, scope_guard
        if verify:
            report = _io.verify_checkpoint(model_dir, level="crc")
            if not report["ok"]:
                bad = [c for c in report["chunks"]
                       if c.get("status") not in ("ok", "unverified")]
                _OBS.counter("serving_swap_total", "hot swaps by outcome",
                             outcome="rejected").inc()
                _journal.emit({"event": "serve_swap", "outcome": "rejected",
                               "error": f"checksum verification failed: "
                                        f"{bad[:3]}"})
                raise ServingError(
                    f"swap rejected: {model_dir!r} failed checksum "
                    f"verification ({len(bad)} bad chunk(s): "
                    f"{[c.get('status') for c in bad[:5]]})")
        scope = Scope()
        with scope_guard(scope):
            _io.load_inference_model(model_dir, None)
        needed = self._predictors[0]._state
        state = {}
        for n in needed:
            v = scope.find_var(n)
            if v is None:
                raise ServingError(
                    f"swap rejected: {model_dir!r} has no parameter {n!r} "
                    f"(the staged model must match the serving program)")
            state[n] = v
        return state

    # -- lifecycle ---------------------------------------------------------
    @property
    def in_flight(self) -> int:
        return self._in_flight

    def queue_depth(self) -> int:
        return self._queue.depth()

    def close(self, drain: bool = True,
              timeout: Optional[float] = 60.0,
              drain_timeout: Optional[float] = None) -> None:
        """Stop accepting work and shut the workers down.

        ``drain=True`` (graceful): every already-accepted request is served
        before workers exit -- zero in-flight, zero queued afterwards.
        ``drain=False``: queued requests fail with a typed
        ``RequestShed("closed")``; the batch currently executing still
        completes.

        A wedged worker can no longer wedge the close: after
        ``drain_timeout`` seconds (default: ``timeout``) of incomplete
        drain, every remaining request -- queued or held by a stuck
        worker -- fails typed ``RequestShed("closed")``, the timeout is
        journaled ``serve_drain_timeout``, and close() completes (the
        stuck daemon thread is abandoned).
        """
        import time
        self._draining = True
        if not drain:
            dropped = self._queue.drain_pending()
            n_resolved = sum(
                1 for r in dropped
                if r.set_exception(RequestShed(
                    "closed", r.tenant, "pool closed without drain")))
            with self._lock:
                self._pending -= n_resolved
        effective = drain_timeout if drain_timeout is not None else timeout
        deadline = (time.monotonic() + effective) if effective else None
        timed_out = False
        while self._pending > 0 and not self._stopped:
            if deadline is not None and time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.002)
        if timed_out:
            self._fail_remaining(effective)
        self._stopped = True
        self._queue.close()
        for t in self._workers:
            # a respawned worker may be published before its start() ran:
            # ident is None until then, and join() would raise -- the
            # thread sees _stopped and exits on its own
            if t.ident is not None:
                t.join(timeout=0.5 if timed_out else 5)
        self._g_depth.set(0)
        self._g_inflight.set(0)
        _server.unregister_refresher(self._export_staleness)
        _journal.emit({"event": "serve_drain", "drained": bool(drain),
                       "timed_out": timed_out})

    def _fail_remaining(self, waited_s) -> None:
        """Drain-timeout escape hatch: resolve every remaining accepted
        request typed so close() can complete under a wedged worker."""
        dropped = self._queue.drain_pending()
        with self._lock:
            held = [b for b in self._current.values()]
        n_queued = n_inflight = 0
        for r in dropped:
            if r.set_exception(RequestShed(
                    "closed", r.tenant,
                    f"drain timed out after {waited_s}s")):
                n_queued += 1
        for b in held:
            for r in b.requests:
                if r.set_exception(RequestShed(
                        "closed", r.tenant,
                        f"drain timed out after {waited_s}s; worker "
                        f"wedged")):
                    n_inflight += 1
        with self._lock:
            self._pending -= n_queued
            # in-flight futures resolved here were accounted; if the
            # wedged worker ever finishes, its scatter resolves 0 futures
            # and decrements _pending by 0 -- no double counting
            self._pending -= n_inflight
        _OBS.counter("serving_drain_timeout_total",
                     "closes that hit the drain timeout").inc()
        _journal.emit({"event": "serve_drain_timeout",
                       "failed_queued": n_queued,
                       "failed_in_flight": n_inflight,
                       "waited_s": waited_s})
        _blackbox.maybe_write(
            "serve_drain_timeout",
            extra={"failed_queued": n_queued,
                   "failed_in_flight": n_inflight, "waited_s": waited_s})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
