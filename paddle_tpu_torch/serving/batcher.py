"""Dynamic request batcher: coalesce concurrent requests into bucketed
batches whose per-request outputs equal serving each solo (the port's copy
of ``paddle_tpu/serving/batcher.py``).

The ``Predictor`` serves one caller at a time; at production concurrency
the win is amortizing one graph replay over many requests. This module is
the shape-discipline half of the serving tier (``pool.py`` is the
scheduling half):

- requests carry host numpy feeds with a leading batch dim (``rows``);
  only requests with the same *per-row signature* (trailing shape + dtype
  per feed) coalesce;
- a formed batch concatenates rows in request order and pads to a
  **power-of-two row bucket** by repeating the last real row, so the
  Predictor's per-signature executable cache (one CUDA graph a signature on
  the card) stays small and warm no matter how ragged the arrivals;
- outputs de-slice back per request. Row-wise models (every serving model
  here: each output row depends only on its input row) make the de-sliced
  bytes identical to a solo ``Predictor.run`` whenever the backend
  computes a row the same way at both batch sizes. Precisely: de-slicing
  itself is positionally exact (bytes are copied straight out of the batch
  output); the known boundary is a backend SPECIALIZING one batch size
  (cuBLAS picks its GEMM algorithm by M, so a 1-row and an 8-row bucket can
  sum a product in other orders), where a de-sliced row can differ from
  the solo run by ~1 ULP of reassociation -- never more, and never across
  requests. A fetch without a leading row dim (e.g. a batch-reduced
  scalar) cannot de-slice and fails the batch with a typed
  :class:`ServingError`.

Batch formation (``DynamicBatcher.form``) dequeues a first request, then
fills up to ``max_batch`` rows from compatible head-of-line requests,
waiting at most ``max_wait_ms`` past the first dequeue -- the classic
latency/throughput knob pair. All waiting goes through an injectable
:class:`Clock` so the selftest drives the deadline logic hermetically
(:class:`FakeClock`), no sleeps, no real threads required.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..tuning.choices import pow2_bucket
from ..utils.clock import Clock, FakeClock, MonotonicClock

__all__ = [
    "ServingError", "RequestShed", "RequestTimeout", "Clock",
    "MonotonicClock", "FakeClock", "Request", "Batch", "DynamicBatcher",
    "SimpleQueue", "row_signature",
]


class ServingError(RuntimeError):
    """Base class for serving-tier failures surfaced to a request."""


class RequestShed(ServingError):
    """Admission control rejected the request (typed, never a hang).

    ``reason`` is one of ``"queue_full"`` (global bound), ``"tenant_quota"``
    (per-tenant bound), ``"closed"`` (pool draining or closed),
    ``"breaker_open"`` (the (tenant, signature) circuit breaker is open --
    see :class:`~paddle_tpu_torch.serving.breaker.BreakerOpen`).
    """

    def __init__(self, reason: str, tenant: str, detail: str = ""):
        self.reason = reason
        self.tenant = tenant
        super().__init__(
            f"request shed ({reason}) for tenant {tenant!r}"
            + (f": {detail}" if detail else ""))


class RequestTimeout(ServingError):
    """The request's deadline expired before it was served (typed, never a
    hang). Expired requests are evicted before batch assembly, so a dead
    request never occupies batch rows."""

    def __init__(self, tenant: str, waited_ms: float, deadline_ms: float):
        self.tenant = tenant
        self.waited_ms = float(waited_ms)
        self.deadline_ms = float(deadline_ms)
        super().__init__(
            f"request deadline expired for tenant {tenant!r}: waited "
            f"{waited_ms:.1f}ms of a {deadline_ms:.1f}ms budget")


# clocks: the Clock/MonotonicClock/FakeClock seam of utils/clock.py (shared
# with the streaming data plane), kept in this namespace for the serving API.


# ---------------------------------------------------------------- requests --

def row_signature(feed: Dict[str, np.ndarray]) -> Tuple:
    """Per-row batching signature: sorted (name, trailing shape, dtype).
    Two requests coalesce iff their signatures match -- the leading (row)
    dim is free, everything else must agree for concatenation to be legal.
    """
    return tuple(sorted((k, tuple(v.shape[1:]), str(v.dtype))
                        for k, v in feed.items()))


class Request:
    """One in-flight serving request: a future the batcher fulfills.

    ``feed`` values are converted to numpy on construction; every feed must
    carry the same leading (row) dimension.  ``deadline`` is an absolute
    timestamp on the owning pool's clock (None = no deadline); an expired
    request is evicted before batch assembly and resolved with a typed
    :class:`RequestTimeout`.
    """

    def __init__(self, feed: Dict[str, object], tenant: str = "default",
                 t_submit: float = 0.0,
                 deadline: Optional[float] = None):
        self.tenant = str(tenant)
        self.feed: Dict[str, np.ndarray] = {
            k: np.asarray(v) for k, v in dict(feed).items()}
        if not self.feed:
            raise ServingError("empty feed")
        rows = None
        for k, v in self.feed.items():
            if v.ndim == 0:
                raise ServingError(
                    f"feed {k!r} is a scalar; batched serving needs a "
                    f"leading row dimension on every feed")
            if rows is None:
                rows = int(v.shape[0])
            elif int(v.shape[0]) != rows:
                raise ServingError(
                    f"feed {k!r} has {int(v.shape[0])} rows but the "
                    f"request's first feed has {rows}; all feeds of one "
                    f"request must share the leading dimension")
        self.rows: int = int(rows)
        self.sig = row_signature(self.feed)
        self.t_submit = float(t_submit)
        self.deadline = None if deadline is None else float(deadline)
        #: times a sig-compatible batch bypassed this head-of-line request
        #: because it was oversize for the remaining batch space; at the
        #: queue's ``max_head_bypass`` the request is marked ``solo`` and
        #: the batcher dispatches it alone (starvation bound)
        self.bypassed: int = 0
        self.solo: bool = False
        #: pool seams (set by PredictorPool.submit): the pool's clock and
        #: its typed-expiry callback, so ``result()`` can resolve a
        #: deadline even when every worker is wedged
        self._clock: Optional[Clock] = None
        self._expire_cb = None
        self._done = threading.Event()
        self._result: Optional[List[np.ndarray]] = None
        self._error: Optional[BaseException] = None
        #: monotonic fulfillment time (stamped at resolve, not at result()
        #: -- open-loop benchmarks read exact per-request latency off it)
        self.t_done: Optional[float] = None
        self._resolve_lock = threading.Lock()

    # future protocol ------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def set_result(self, outputs: List[np.ndarray]) -> bool:
        """Resolve with a value. First writer wins (a request already
        resolved -- e.g. by a deadline expiry racing a late worker -- is
        left untouched). Returns whether this call resolved the future."""
        import time
        with self._resolve_lock:
            if self._done.is_set():
                return False
            self._result = outputs
            self.t_done = time.monotonic()
            self._done.set()
            return True

    def set_exception(self, exc: BaseException) -> bool:
        """Resolve with an error; first writer wins (see set_result)."""
        import time
        with self._resolve_lock:
            if self._done.is_set():
                return False
            self._error = exc
            self.t_done = time.monotonic()
            self._done.set()
            return True

    def result(self, timeout: Optional[float] = None) -> List[np.ndarray]:
        if (self.deadline is not None and self._expire_cb is not None
                and not self._done.is_set() and self._clock is not None):
            # deadline-aware wait: if the deadline passes while every
            # worker is wedged (nothing left to reap the queue), the
            # caller's own wait resolves the future typed -- a request can
            # never outlive its deadline just because the pool did
            remaining = self.deadline - self._clock.now()
            wait1 = remaining if timeout is None else min(remaining, timeout)
            if wait1 > 0:
                self._done.wait(wait1)
            if (not self._done.is_set()
                    and self._clock.now() >= self.deadline):
                self._expire_cb(self)
            if timeout is not None:
                timeout = max(0.0, timeout - max(0.0, wait1))
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"serving request (tenant {self.tenant!r}, {self.rows} "
                f"row(s)) not completed within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


# ------------------------------------------------------------------ batches --

class Batch:
    """Same-signature requests concatenated into one padded feed."""

    def __init__(self, requests: Sequence[Request]):
        if not requests:
            raise ServingError("empty batch")
        self.requests: List[Request] = list(requests)
        self.sig = self.requests[0].sig
        self.rows = sum(r.rows for r in self.requests)
        #: rows actually dispatched: the pow2 shape bucket, so ragged
        #: arrival patterns reuse a handful of captured graphs
        self.padded_rows = pow2_bucket(self.rows)
        #: the error this batch failed with, if any (set by fail() --
        #: including scatter's internal non-row-wise rejection, so the
        #: pool's breaker sees every failure mode)
        self.failed_exc: Optional[BaseException] = None

    def feed(self) -> Dict[str, np.ndarray]:
        """Concatenate per-request rows (request order) and pad to the row
        bucket by repeating the last real row -- real data, so padding can
        never manufacture NaN/Inf in models with data-dependent ops."""
        out = {}
        names = self.requests[0].feed.keys()
        for k in names:
            parts = [r.feed[k] for r in self.requests]
            pad = self.padded_rows - self.rows
            if pad:
                parts.append(np.repeat(parts[-1][-1:], pad, axis=0))
            out[k] = (np.ascontiguousarray(parts[0]) if len(parts) == 1
                      else np.concatenate(parts, axis=0))
        return out

    def scatter(self, outputs: Sequence[np.ndarray]) -> int:
        """De-slice batch outputs back per request (byte-equal to solo
        serving) and resolve every request's future. Returns the number of
        futures THIS call resolved (a request already resolved -- e.g. by
        a deadline racing the batch -- keeps its first resolution)."""
        outs = [np.asarray(o) for o in outputs]
        for i, o in enumerate(outs):
            if o.ndim == 0 or int(o.shape[0]) != self.padded_rows:
                return self.fail(ServingError(
                    f"fetch #{i} has shape {tuple(o.shape)}, not "
                    f"{self.padded_rows} leading rows: the model is not "
                    f"row-wise (a batch-reduced fetch cannot be de-sliced "
                    f"per request); serve it through Predictor.run directly"))
        off = 0
        resolved = 0
        for r in self.requests:
            if r.set_result([np.ascontiguousarray(o[off:off + r.rows])
                             for o in outs]):
                resolved += 1
            off += r.rows
        return resolved

    def fail(self, exc: BaseException) -> int:
        """Resolve every not-yet-done request with ``exc``; returns how
        many futures this call resolved."""
        self.failed_exc = exc
        return sum(1 for r in self.requests if r.set_exception(exc))


# ------------------------------------------------------------------- queues --

class SimpleQueue:
    """Minimal single-tenant FIFO implementing the batcher's queue
    protocol (``pool.TenantQueue`` is the production multi-tenant one)."""

    def __init__(self, clock: Optional[Clock] = None):
        self._clock = clock or MonotonicClock()
        self._cond = threading.Condition()
        self._items: List[Request] = []
        self._closed = False

    def push(self, req: Request) -> None:
        with self._cond:
            self._items.append(req)
            self._cond.notify_all()

    def depth(self) -> int:
        return len(self._items)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- batcher protocol --
    def pop_first(self, timeout: float) -> Optional[Request]:
        deadline = self._clock.now() + timeout
        with self._cond:
            while not self._items:
                remaining = deadline - self._clock.now()
                if remaining <= 0 or self._closed:
                    return None
                self._clock.wait(self._cond, remaining)
            return self._items.pop(0)

    def pop_compatible(self, sig, max_rows: int) -> Optional[Request]:
        with self._cond:
            if self._items and self._items[0].sig == sig \
                    and self._items[0].rows <= max_rows:
                return self._items.pop(0)
            return None

    def wait_for_more(self, timeout: float) -> None:
        # called only after pop_compatible found nothing usable: wait for a
        # push (an unconditional cond-wait -- returning early just because
        # incompatible heads are queued would busy-spin the batcher)
        with self._cond:
            if not self._closed:
                self._clock.wait(self._cond, timeout)


# ------------------------------------------------------------------ batcher --

class DynamicBatcher:
    """Form bucketed batches from a request queue.

    ``max_batch`` bounds the *real* rows per batch (a single oversize
    request still serves whole -- requests are never split, so solo
    byte-equality holds trivially for them too). ``max_wait_ms`` bounds how
    long the first request of a batch waits for company; 0 disables
    coalescing-by-waiting (batches still form from already-queued work).
    """

    def __init__(self, max_batch: int = 32, max_wait_ms: float = 2.0,
                 clock: Optional[Clock] = None):
        if int(max_batch) < 1:
            raise ValueError("max_batch must be >= 1")
        if float(max_wait_ms) < 0:
            raise ValueError("max_wait_ms must be >= 0")
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self._clock = clock or MonotonicClock()

    def form(self, queue, timeout: float = 0.05) -> Optional[Batch]:
        """Block up to ``timeout`` for a first request, then coalesce
        compatible queued requests until ``max_batch`` rows or the
        ``max_wait_ms`` deadline. Returns None on an idle timeout."""
        first = queue.pop_first(timeout)
        if first is None:
            return None
        if first.solo:
            # bypassed past the queue's cap: dispatch alone, immediately --
            # waiting for company is what starved it in the first place
            return Batch([first])
        reqs = [first]
        rows = first.rows
        deadline = self._clock.now() + self.max_wait_ms / 1e3
        while rows < self.max_batch:
            nxt = queue.pop_compatible(first.sig, self.max_batch - rows)
            if nxt is not None:
                reqs.append(nxt)
                rows += nxt.rows
                continue
            remaining = deadline - self._clock.now()
            if remaining <= 0:
                break
            queue.wait_for_more(remaining)
        return Batch(reqs)
