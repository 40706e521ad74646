"""Run journal and metrics registry (the port's copy of the part of
``paddle_tpu/observability/`` that the dataset code reads: ``journal`` and
``metrics``). The rest of that package (timeline, health, export, goodput,
fleet, attribution) is not ported yet."""
from . import journal, metrics  # noqa: F401
