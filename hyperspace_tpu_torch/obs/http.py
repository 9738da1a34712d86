"""Zero-dependency runtime health endpoints: /metrics, /healthz, /debug.

A port of the JAX package's `obs/http.py`; its /healthz document has no
``jit`` section (the port compiles nothing at run time, obs/runtime.py)
and carries the process gauges under ``proc`` instead; its ``ingest``
section lists each attached ingest daemon's state (`attach_ingest`). A stdlib
:class:`~http.server.ThreadingHTTPServer` exposes the whole observability
plane of a *running* process:

- ``GET /metrics`` — Prometheus text exposition of the live registry
  (process gauges and SLO burn gauges refreshed per scrape);
- ``GET /healthz`` — one JSON verdict an operator or load balancer can
  act on: index health map, scheduler saturation, SLO burn verdicts,
  process gauges, event counts. 200 while serving is viable
  (``ok``/``degraded``), 503 once an SLO page verdict fires
  (``critical``);
- ``GET /debug/events[?level=warn&limit=100]`` — the structured event
  ring (obs/events.py);
- ``GET /debug/trace[?limit=8]`` — recent root span trees
  (obs/trace.py), the live counterpart of the JSON-lines sink;
- ``GET /debug/incidents[?name=<bundle>]`` — read-only index of the
  controller's incident bundles (serve/controller.py): the list, or one
  bundle's manifest + file inventory.

Lifecycle: a :class:`HealthServer` can be constructed standalone, but
the normal path is ``hyperspace.obs.http.enabled=true`` + a
``QueryServer`` (serve/scheduler.py), which acquires the process-global
refcounted instance on construction and releases it on shutdown — N
QueryServers share one port, and the last shutdown closes the socket.
When the key is false (the default) nothing here is imported, no thread
starts, and no socket exists — the zero-overhead contract the tracer's
disabled mode established.

Health *providers* (sessions, query servers) register weakly: the
endpoint never keeps a dead session alive, and a GC'd provider simply
drops out of /healthz.
"""

from __future__ import annotations

import json
import threading
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from hyperspace_tpu_torch.obs import events as _events
from hyperspace_tpu_torch.obs import metrics as _metrics
from hyperspace_tpu_torch.obs import runtime as _runtime
from hyperspace_tpu_torch.obs import slo as _slo
from hyperspace_tpu_torch.obs import trace as _trace

DEFAULT_HOST = "127.0.0.1"
DEFAULT_PORT = 0  # ephemeral: the bound port is on HealthServer.port

_REQUESTS = _metrics.counter("obs.http.requests", "health-plane HTTP requests served")
_ERRORS = _metrics.counter("obs.http.errors", "health-plane requests that failed (500)")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class HealthServer:
    """One process's health plane: a bound socket + daemon serve thread.

    Usable standalone::

        hs = HealthServer(host="0.0.0.0", port=9464)
        hs.attach_session(session)
        hs.start()
        ... # scrape http://host:port/metrics
        hs.stop()
    """

    def __init__(self, host: str = DEFAULT_HOST, port: int = DEFAULT_PORT):
        self.host = host
        self._requested_port = int(port)
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        # Weak provider sets: a dead session/server drops out of healthz.
        self._sessions: weakref.WeakSet = weakref.WeakSet()
        self._servers: weakref.WeakSet = weakref.WeakSet()
        self._controllers: weakref.WeakSet = weakref.WeakSet()
        self._supervisors: weakref.WeakSet = weakref.WeakSet()
        self._ingests: weakref.WeakSet = weakref.WeakSet()

    # -- providers --------------------------------------------------------
    def attach_session(self, session) -> None:
        with self._lock:
            self._sessions.add(session)

    def attach_server(self, query_server) -> None:
        with self._lock:
            self._servers.add(query_server)

    def detach_server(self, query_server) -> None:
        with self._lock:
            self._servers.discard(query_server)

    def attach_controller(self, controller) -> None:
        """Surface an ops controller's live verdict in /healthz
        (serve/controller.py registers itself on start())."""
        with self._lock:
            self._controllers.add(controller)

    def attach_supervisor(self, supervisor) -> None:
        """Surface a fleet supervisor's member list in /healthz: pids,
        ports, per-member last-heartbeat age — WITHOUT scraping members
        (FleetSupervisor.fleet_summary), so a silently dead member is
        visible between supervisor poll ticks."""
        with self._lock:
            self._supervisors.add(supervisor)

    def attach_ingest(self, daemon) -> None:
        """Surface a continuous-ingestion daemon's live state in /healthz:
        mode, pause flag, per-index freshness lag, last committed log ids
        (ingest/daemon.py registers itself on start())."""
        with self._lock:
            self._ingests.add(daemon)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "HealthServer":
        with self._lock:
            if self._httpd is not None:
                return self
            plane = self
            handler = type("_Handler", (_Handler,), {"plane": plane})
            self._httpd = ThreadingHTTPServer((self.host, self._requested_port), handler)
            self._httpd.daemon_threads = True
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="hs-obs-http",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            httpd, thread = self._httpd, self._thread
            self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5.0)

    @property
    def running(self) -> bool:
        with self._lock:
            return self._httpd is not None

    @property
    def port(self) -> int | None:
        """The actually bound port (resolves port=0), None when stopped."""
        with self._lock:
            httpd = self._httpd
            return httpd.server_address[1] if httpd is not None else None

    def url(self, path: str = "") -> str:
        return f"http://{self.host}:{self.port}{path}"

    # -- views ------------------------------------------------------------
    def healthz(self) -> dict:
        """The health verdict document (also the /healthz body). Carries
        the ACTUALLY-BOUND endpoint address: with ``port=0`` (the
        default — N fleet processes on one host must not fight over one
        configured port) the ephemeral port the kernel picked is
        reported here and via :attr:`port`/:func:`shared`, so a
        supervisor or service discovery can address this member."""
        with self._lock:
            sessions = list(self._sessions)
            servers = list(self._servers)
            controllers = list(self._controllers)
            supervisors = list(self._supervisors)
            ingests = list(self._ingests)
        indexes: dict[str, dict] = {}
        for s in sessions:
            with s._state_lock:
                indexes.update({root: dict(rec) for root, rec in s.index_health.items()})
        scheduler = [srv.saturation() for srv in servers]
        _slo.sample()
        slo_verdicts = _slo.evaluate()
        proc = _runtime.refresh_process_gauges()
        _events.refresh_gauges()
        status = "ok"
        if indexes or any(v["verdict"] == "warn" for v in slo_verdicts.values()):
            status = "degraded"
        if any(v["verdict"] == "page" for v in slo_verdicts.values()):
            status = "critical"
        return {
            "status": status,
            "endpoint": {"host": self.host, "port": self.port},
            "indexes": indexes,
            "scheduler": scheduler,
            # Self-driving operations (serve/controller.py): each
            # attached controller's live verdict — mode, engaged
            # overrides, remaining actuation budget, recent decisions.
            "controller": [c.snapshot() for c in controllers],
            "slo": slo_verdicts,
            "proc": proc,
            "events": _events.counts_by_severity(),
            # Fleet topology (serve/fleet/supervisor.py): member
            # pids/ports and per-member last-heartbeat ages, read from
            # registrations — no member scrape on the /healthz path.
            "fleet": [s.fleet_summary() for s in supervisors],
            # Continuous ingestion (ingest/daemon.py): each attached
            # daemon's mode, pause flag, freshness lag and last committed
            # log ids.
            "ingest": [d.snapshot() for d in ingests],
        }

    def metrics_text(self) -> str:
        from hyperspace_tpu_torch.obs.export import render_prometheus

        _runtime.refresh_process_gauges()
        _slo.sample()
        _slo.evaluate()
        _events.refresh_gauges()
        return render_prometheus()


class _Handler(BaseHTTPRequestHandler):
    plane: HealthServer  # injected per-server subclass (start())

    # Health scrapes are high-frequency; stdlib default logs every
    # request to stderr — route to logging at debug instead.
    def log_message(self, fmt: str, *args) -> None:
        import logging

        logging.getLogger("hyperspace_tpu_torch.obs.http").debug(fmt, *args)

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        _REQUESTS.inc()
        try:
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/metrics":
                self._send(200, self.plane.metrics_text(), PROMETHEUS_CONTENT_TYPE)
            elif url.path == "/healthz":
                doc = self.plane.healthz()
                self._send_json(503 if doc["status"] == "critical" else 200, doc)
            elif url.path == "/debug/events":
                level = (q.get("level") or [None])[0]
                limit = int((q.get("limit") or [256])[0])
                self._send_json(200, {"events": _events.recent(level=level, limit=limit)})
            elif url.path == "/debug/trace":
                limit = int((q.get("limit") or [8])[0])
                roots = _trace.recent_roots(limit=limit)
                self._send_json(200, {"traces": [r.to_json() for r in roots]})
            elif url.path == "/debug/incidents":
                # Read-only: list every attached controller's incident
                # bundles, or one bundle's manifest + file inventory via
                # ?name=<bundle dir name> (serve/controller.py).
                name = (q.get("name") or [None])[0]
                with self.plane._lock:
                    controllers = list(self.plane._controllers)
                if name is None:
                    bundles = []
                    for c in controllers:
                        bundles.extend(c.list_incidents())
                    self._send_json(200, {"incidents": bundles})
                else:
                    doc = None
                    for c in controllers:
                        doc = c.read_incident(name)
                        if doc is not None:
                            break
                    if doc is None:
                        self._send_json(404, {"error": f"unknown incident {name!r}"})
                    else:
                        self._send_json(200, doc)
            else:
                self._send_json(404, {"error": f"unknown path {url.path!r}"})
        except (ValueError, KeyError) as e:
            # Bad query params / unknown severity levels: client error.
            self._send_json(400, {"error": str(e)})
        except Exception as e:
            _ERRORS.inc()
            self._send_json(500, {"error": f"{type(e).__name__}: {e}"})

    def _send(self, code: int, body: str, content_type: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _send_json(self, code: int, doc: dict) -> None:
        self._send(code, json.dumps(doc, default=str), "application/json")


# -- process-global refcounted instance (QueryServer lifecycle) -----------

_shared_lock = threading.Lock()
_shared: "HealthServer | None" = None
_shared_refs = 0


def acquire(host: str = DEFAULT_HOST, port: int = DEFAULT_PORT) -> HealthServer:
    """The process-shared HealthServer, started on first acquire. Later
    acquirers share the first binding (one port per process — the
    refcounted in-process sharing); every acquire must be paired with a
    :func:`release`. With ``port=0`` the kernel picks an ephemeral port:
    read it back from the returned instance's ``.port`` (or
    ``shared().port``, or the /healthz ``endpoint`` section) — the fleet
    default, so N worker processes on one host never collide."""
    global _shared, _shared_refs
    with _shared_lock:
        if _shared is None:
            _shared = HealthServer(host=host, port=port).start()
        _shared_refs += 1
        return _shared


def release() -> None:
    """Drop one reference; the last release stops the shared server."""
    global _shared, _shared_refs
    with _shared_lock:
        if _shared is None:
            return
        _shared_refs -= 1
        if _shared_refs > 0:
            return
        server, _shared, _shared_refs = _shared, None, 0
    server.stop()


def shared() -> "HealthServer | None":
    """The live shared instance, if any (tests / standalone tools)."""
    with _shared_lock:
        return _shared
