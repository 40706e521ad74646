"""Run journal, metrics registry, tensor-health watchdog, black box,
flight-recorder timeline, registry export and the live ``/metrics``
endpoint (the port's copy of the part of ``paddle_tpu/observability/``
that the dataset code, the step guardian, the Predictor and the serving
tier read: ``journal``, ``metrics``, ``health``, ``blackbox``, ``timeline``,
``export`` and ``server``). The rest of that package (goodput, fleet,
attribution, alerts, SLOs) is not ported yet (ROADMAP item 12)."""
from . import blackbox, export, health, journal, metrics, server, timeline  # noqa: F401
