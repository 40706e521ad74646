"""Live metrics endpoint: an opt-in stdlib HTTP daemon thread (the port's
copy of ``paddle_tpu/observability/server.py``).

Armed by ``PADDLE_TPU_OBS_PORT`` (``PredictorPool`` calls
:func:`maybe_start` at construction; with the env unset that is ONE
``os.environ`` read -- no socket, no thread, no import of
``http.server``). Under a multi-rank job each rank serves on ``port +
rank``; ``PADDLE_TPU_OBS_HOST`` picks the bind address (default
``127.0.0.1``).

Routes:

- ``/metrics``  -- Prometheus text exposition of the process registry
  (round-trippable through ``export.parse_prometheus``), after the goodput
  gauges and counters and the registered refreshers' on-demand gauges (the
  serving pool's model staleness) are refreshed. The goodput wall window
  comes from the recorded span range, not "now", so a quiescent process
  scrapes byte-stably.
- ``/healthz``  -- watchdog state as JSON: 200 while no tensor has gone
  NaN/Inf, 503 (with the last offender) after one has.
- ``/goodput``  -- the :mod:`goodput` ledger as JSON.
- ``/journal``  -- bounded JSONL tail of the in-process journal ring
  (``?n=``, default 100, capped at 1000).
- ``/alerts``   -- the SLO engine's view as JSON (:func:`slo.alerts_doc`):
  parsed rules, latest per-rule evaluations, active and recently-resolved
  alerts; a disarmed engine serves a stub with ``"armed": false``.

Failure policy: telemetry must degrade, never abort serving. A port
already in use (or any bind error) warns ONCE per port and returns None;
a handler error returns HTTP 500 but never reaches the serving loop.
"""
from __future__ import annotations

import json
import os
import threading
import warnings
from typing import Optional

PORT_ENV = "PADDLE_TPU_OBS_PORT"
HOST_ENV = "PADDLE_TPU_OBS_HOST"
JOURNAL_TAIL_DEFAULT = 100
JOURNAL_TAIL_CAP = 1000

_lock = threading.Lock()
_server: Optional["ObsServer"] = None
_warned_ports = set()


class ObsServer:
    """A running endpoint: ``httpd`` + daemon thread + resolved port."""

    def __init__(self, httpd, thread, host: str, port: int):
        self._httpd = httpd
        self._thread = thread
        self.host = host
        self.port = port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self):
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except Exception:
            pass
        self._thread.join(timeout=5)


def port_from_env() -> Optional[int]:
    """The armed port for THIS process, or None: base port from
    ``PADDLE_TPU_OBS_PORT`` plus the process rank when world size > 1
    (port 0 asks the OS for an ephemeral port -- tests)."""
    raw = os.environ.get(PORT_ENV)
    if raw is None or not raw.strip():
        return None
    try:
        base = int(raw)
    except ValueError:
        _warn_once(raw, f"{PORT_ENV}={raw!r} is not a port number; "
                        f"metrics endpoint disabled")
        return None
    if base == 0:
        return 0
    try:
        from ..parallel import env as _penv
        if _penv.get_world_size() > 1:
            return base + _penv.get_rank()
    except Exception:
        pass
    return base


def _warn_once(key, msg: str):
    with _lock:
        if key in _warned_ports:
            return
        _warned_ports.add(key)
    warnings.warn(f"paddle_tpu_torch observability server: {msg}")


_refreshers: list = []


def register_refresher(fn) -> None:
    """Register ``fn()`` to run before each ``/metrics`` scrape: it updates
    an on-demand gauge (the serving pool's ``model_staleness_seconds``)."""
    with _lock:
        _refreshers.append(fn)


def unregister_refresher(fn) -> None:
    with _lock:
        if fn in _refreshers:
            _refreshers.remove(fn)


def run_refreshers() -> None:
    """Refresh the on-demand gauges (before each ``/metrics`` scrape and
    each SLO evaluation). Degrades: a refresher's error warns once and the
    scrape still serves the raw registry."""
    with _lock:
        fns = list(_refreshers)
    for fn in fns:
        try:
            fn()
        except Exception as e:  # telemetry must not 500 the whole scrape
            _warn_once("refresh", f"metrics refresh failed: {e}")


def _refresh() -> None:
    """Per-scrape refresh of the derived metrics: the goodput gauges and
    counters, then the refreshers. Degrades like ``run_refreshers``."""
    try:
        from . import goodput as _goodput
        _goodput.export()
    except Exception as e:  # telemetry must not 500 the whole scrape
        _warn_once("goodput", f"goodput refresh failed: {e}")
    run_refreshers()


def _health_doc() -> dict:
    from . import health as _health
    from . import journal as _journal
    from .metrics import REGISTRY
    nonfinite = 0.0
    fam = REGISTRY.get("tensor_nonfinite_total")
    if fam is not None:
        nonfinite = sum(child.value for _k, child in fam.items())
    anomalies = 0.0
    fam = REGISTRY.get("anomaly_total")
    if fam is not None:
        anomalies = sum(child.value for _k, child in fam.items())
    last = (_journal.recent(1, event="tensor_nonfinite") or [None])[-1]
    doc = {
        "status": "ok" if nonfinite == 0 else "unhealthy",
        "health_mode": _health.mode(),
        "nonfinite_total": nonfinite,
        "anomaly_total": anomalies,
        "last_nonfinite": last,
        "pid": os.getpid(),
    }
    r = _journal.current_rank()
    if r is not None:
        doc["rank"] = r
    return doc


def _make_handler():
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        server_version = "paddle_tpu_torch_obs/1"

        def log_message(self, *a):   # stay silent: stderr is the user's
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            import urllib.parse
            parsed = urllib.parse.urlparse(self.path)
            try:
                if parsed.path == "/metrics":
                    from . import export as _export
                    _refresh()
                    self._send(
                        200, _export.to_prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif parsed.path == "/healthz":
                    doc = _health_doc()
                    self._send(200 if doc["status"] == "ok" else 503,
                               json.dumps(doc, sort_keys=True,
                                          default=str).encode(),
                               "application/json")
                elif parsed.path == "/goodput":
                    from . import goodput as _goodput
                    rep = _goodput.export()
                    self._send(200, json.dumps(rep.to_dict(), sort_keys=True).encode(),
                               "application/json")
                elif parsed.path == "/alerts":
                    from . import slo as _slo
                    self._send(200, json.dumps(_slo.alerts_doc(), sort_keys=True,
                                               default=str).encode(), "application/json")
                elif parsed.path == "/journal":
                    from . import journal as _journal
                    q = urllib.parse.parse_qs(parsed.query)
                    try:
                        n = int(q.get("n", [JOURNAL_TAIL_DEFAULT])[0])
                    except (TypeError, ValueError):
                        n = JOURNAL_TAIL_DEFAULT
                    n = max(1, min(n, JOURNAL_TAIL_CAP))
                    lines = [json.dumps(e, sort_keys=True, default=str)
                             for e in _journal.recent(n)]
                    self._send(200, ("\n".join(lines) + "\n").encode(),
                               "application/jsonl")
                else:
                    self._send(404, b"not found: use /metrics, /healthz, "
                                    b"/goodput, /journal or /alerts\n", "text/plain")
            except BrokenPipeError:
                pass
            except Exception as e:
                try:
                    self._send(500, f"error: {e}\n".encode(), "text/plain")
                except Exception:
                    pass

    return _Handler


def start(port: Optional[int] = None,
          host: Optional[str] = None) -> Optional[ObsServer]:
    """Start the endpoint (idempotent: a live server is returned as-is).
    Returns None -- after warning once per port -- when the bind fails;
    the run proceeds without telemetry, never aborts."""
    global _server
    with _lock:
        if _server is not None:
            return _server
    if port is None:
        port = port_from_env()
        if port is None:
            return None
    host = host or os.environ.get(HOST_ENV, "127.0.0.1")
    import http.server
    try:
        httpd = http.server.ThreadingHTTPServer((host, port),
                                                _make_handler())
    except OSError as e:
        _warn_once(port, f"cannot bind {host}:{port} ({e}); metrics "
                         f"endpoint disabled for this process -- pick "
                         f"another {PORT_ENV} or free the port")
        return None
    httpd.daemon_threads = True
    thread = threading.Thread(target=httpd.serve_forever,
                              name="paddle-tpu-torch-obs-server", daemon=True)
    srv = ObsServer(httpd, thread, host, httpd.server_address[1])
    with _lock:
        if _server is not None:   # lost a start race: keep the winner
            httpd.server_close()
            return _server
        _server = srv
    thread.start()
    from . import journal as _journal
    _journal.emit({"event": "obs_server", "url": srv.url})
    return srv


def maybe_start() -> Optional[ObsServer]:
    """The serving pool's construction hook: with ``PADDLE_TPU_OBS_PORT``
    unset this is one env read and returns None -- no socket, no thread."""
    if os.environ.get(PORT_ENV) is None:
        return None
    return start()


def current() -> Optional[ObsServer]:
    return _server


def stop():
    """Shut the endpoint down (tests / clean process exit)."""
    global _server
    with _lock:
        srv, _server = _server, None
    if srv is not None:
        srv.close()
