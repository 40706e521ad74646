"""Runtime observability (the port's copy of ``paddle_tpu/observability/``):

- ``metrics``  -- thread-safe Counter/Gauge/Histogram registry (always on,
  in-memory only); ``export`` renders it as JSON or Prometheus text.
- ``journal``  -- JSON-lines run journal (one ``run`` event per
  ``Executor.run``, ``predict`` events...), file sink gated on
  ``PADDLE_TPU_OBS=1``.
- ``timeline`` -- flight-recorder phase spans and the Chrome-trace exporter.
- ``health``   -- NaN/Inf watchdog over fetches and state
  (``PADDLE_TPU_OBS_HEALTH=off|warn|raise``).
- ``cost``     -- a step's matmul-class FLOPs (``utils/flops.py``) and its
  achieved MFU against the card's peak for the program's product dtype.
- ``memory``   -- device-memory gauges and each captured step's pool,
  argument and output bytes.
- ``anomaly``  -- rolling median/MAD step-time regression detector.
- ``goodput``  -- wall-clock ledger: productive step time against named
  loss causes, ``goodput_fraction`` + ``lost_seconds_total{cause}``.
- ``attribution`` -- per-IR-op device time of a captured step, from a
  profiled eager warm-up (``op_device_seconds{program,op,category}``) and
  the diff of two such artifacts.
- ``slo`` / ``alerts`` -- declarative SLO rules over the registry with
  multi-window multi-burn-rate alerting (``PADDLE_TPU_OBS_SLO=rules.json``).
- ``server``   -- opt-in live endpoint (``PADDLE_TPU_OBS_PORT``):
  ``/metrics`` ``/healthz`` ``/goodput`` ``/journal`` ``/alerts``.
- ``blackbox`` -- post-mortem bundles on terminal failure paths
  (``PADDLE_TPU_OBS_BLACKBOX=<dir>``).

``fleet`` (cross-rank aggregation) comes with the distributed stack
(ROADMAP item 13).
"""
from . import metrics  # noqa: F401
from . import export  # noqa: F401
from . import journal  # noqa: F401
from . import cost  # noqa: F401
from . import timeline  # noqa: F401
from . import health  # noqa: F401
from . import memory  # noqa: F401
from . import anomaly  # noqa: F401
from . import goodput  # noqa: F401
from . import server  # noqa: F401
from . import attribution  # noqa: F401
from . import alerts  # noqa: F401
from . import slo  # noqa: F401
from . import blackbox  # noqa: F401
from .metrics import (REGISTRY, MetricsRegistry, Counter, Gauge,  # noqa: F401
                      Histogram)
from .export import to_json, to_prometheus, parse_prometheus  # noqa: F401
from .journal import enabled, emit, recent, read_journal, current_rank  # noqa: F401
from .timeline import phase, export_chrome_trace, validate_trace  # noqa: F401
from .goodput import (GoodputReport,  # noqa: F401
                      compute as compute_goodput,
                      compute_live as compute_goodput_live,
                      run_ledger,
                      export as export_goodput)
from .server import ObsServer, start as start_server, stop as stop_server  # noqa: F401
from .alerts import Alert, AlertManager  # noqa: F401
from .slo import (SLOEngine, SLOConfigError, Rule,  # noqa: F401
                  load_rules, parse_rules, validate_rules, alerts_doc)
from .blackbox import write_bundle  # noqa: F401
from .attribution import (ProgramAttribution, attribute_trace,  # noqa: F401
                          diff_attributions, format_diff)
