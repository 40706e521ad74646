"""Run journal, metrics registry, tensor-health watchdog and black box (the
port's copy of the part of ``paddle_tpu/observability/`` that the dataset
code and the step guardian read: ``journal``, ``metrics``, ``health`` and
``blackbox``). The rest of that package (timeline, export, goodput, fleet,
attribution, alerts) is not ported yet."""
from . import blackbox, health, journal, metrics  # noqa: F401
