"""Production serving tier: continuous batching + multi-tenant Predictor
pool (the port's copy of ``paddle_tpu/serving/``).

The layer between concurrent clients and the
:class:`~paddle_tpu_torch.inference.Predictor` (the reference's
AnalysisPredictor-behind-a-server capability class):

- :mod:`~paddle_tpu_torch.serving.batcher` -- dynamic batcher coalescing
  concurrent requests into pow2-bucketed batch shapes with per-request
  de-slicing;
- :mod:`~paddle_tpu_torch.serving.breaker` -- the per-(tenant, signature)
  circuit breaker;
- :mod:`~paddle_tpu_torch.serving.pool` -- :class:`PredictorPool`: N
  Predictors + workers, bounded-queue admission control with explicit typed
  shed, per-tenant quotas and weighted fair dequeue, deadlines, hot swap,
  graceful drain, the ``serving.dtype`` autotune knob, and serving metrics
  on the ``/metrics`` endpoint.

Deliberately NOT imported by ``paddle_tpu_torch/__init__.py``: a process
that never serves pays nothing -- ``Predictor.run`` without this import
opens no threads and no queues.

    from paddle_tpu_torch.serving import PredictorPool
    pool = PredictorPool("model_dir", size=2, max_batch=32, max_wait_ms=2)
    out, = pool.run({"x": batch})          # or pool.submit(...).result()
    pool.close()                           # graceful drain

``python -m paddle_tpu_torch.serving --selftest`` runs the hermetic
fake-clock batcher drills plus a tiny-MLP pool round-trip on the CPU.
"""
from .batcher import (Batch, Clock, DynamicBatcher, FakeClock,
                      MonotonicClock, Request, RequestShed, RequestTimeout,
                      ServingError, SimpleQueue, row_signature)
from .breaker import BreakerOpen, CircuitBreaker
from .pool import PredictorPool, ServingDtype, TenantQueue

__all__ = [
    "Batch", "BreakerOpen", "CircuitBreaker", "Clock", "DynamicBatcher",
    "FakeClock", "MonotonicClock", "PredictorPool", "Request",
    "RequestShed", "RequestTimeout", "ServingDtype", "ServingError",
    "SimpleQueue", "TenantQueue", "row_signature",
]
