"""Live monitoring: ``/metrics`` + ``/status`` + ``/trace`` over stdlib HTTP
(a copy of the reference's ``repro/obs/serve.py``: the same endpoints,
metric names and text, so one scraper reads either package).

A :class:`MonitorServer` is a tiny ``ThreadingHTTPServer`` that turns a
running tuning session — a distributed system of sessions, netopt
loops, and worker daemons — from post-hoc trace files into
something you can watch live:

* ``/metrics`` — Prometheus text exposition (version 0.0.4) of one
  :class:`~repro_torch.obs.metrics.Metrics` registry.  Registered *collectors*
  run at scrape time (copy-on-read: they pull ``Executor.stats()`` /
  tracker state and write instruments), so the measurement hot path
  carries zero monitoring cost and Serial/Subprocess/Remote pools all
  export uniformly through ``record_executor_stats``.
* ``/status`` — JSON snapshot assembled from attached *status sources*
  (``attach(name, status_fn)``): live session progress (best-so-far,
  spent vs budget, per-task state, surrogate hit/miss), netopt phase,
  and fleet health (per-endpoint jobs/failures/reconnects/in-flight
  plus daemon heartbeat load).
* ``/trace`` — bounded tail of recent spans from an attached
  :class:`~repro_torch.obs.trace.Tracer` (empty without one).

Lifecycle: owners (``Session``, netopt ``_Evaluator``, ``WorkerDaemon``)
either *own* a server (built from ``monitor=PORT``, stopped with the
run) or *borrow* one (``monitor=MonitorServer``) — mirroring the
borrowed-RemoteExecutor idiom — and must call :meth:`finalize` before
tearing down the structures their callbacks read: the last snapshot is
frozen, so a scrape after the run still answers with final values (the
acceptance path: the final ``/metrics`` scrape matches the report).

Stdlib only, like the rest of ``repro_torch.obs`` — daemons import this.
"""
from __future__ import annotations

import json
import math
import threading
import time
import weakref
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional
from urllib.parse import urlparse

from repro_torch.obs import log
from repro_torch.obs.metrics import Metrics

_REGISTRY: "weakref.WeakSet[MonitorServer]" = weakref.WeakSet()


def active_servers() -> List["MonitorServer"]:
    """Every started, not-yet-stopped :class:`MonitorServer` in this
    process — how tests (and the CLI smoke test) discover the ephemeral
    port a ``--monitor 0`` run bound."""
    return [s for s in _REGISTRY if s.running]


def _fmt(v: float) -> str:
    """Prometheus sample value: exact round-trip formatting."""
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _sanitize(name: str) -> str:
    """Metric-name charset: ``[a-zA-Z_:][a-zA-Z0-9_:]*``; dotted registry
    names become underscore-separated with a ``repro_`` prefix."""
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return "repro_" + out


def prometheus_text(snapshot: Dict[str, object]) -> str:
    """Render a ``Metrics.snapshot()`` dict to the Prometheus text
    exposition format.  Histograms are rendered as summaries (quantile
    labels + ``_count``/``_sum``) — the snapshot already reduced the
    stream, so the cumulative-bucket histogram type does not apply."""
    lines: List[str] = []
    for name, v in sorted(snapshot.get("counters", {}).items()):
        mn = _sanitize(name)
        lines.append(f"# TYPE {mn} counter")
        lines.append(f"{mn} {_fmt(v)}")
    for name, v in sorted(snapshot.get("gauges", {}).items()):
        mn = _sanitize(name)
        lines.append(f"# TYPE {mn} gauge")
        lines.append(f"{mn} {_fmt(v)}")
    for name, h in sorted(snapshot.get("histograms", {}).items()):
        mn = _sanitize(name)
        lines.append(f"# TYPE {mn} summary")
        for q, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
            if key in h:
                lines.append(f'{mn}{{quantile="{q}"}} {_fmt(h[key])}')
        lines.append(f"{mn}_count {_fmt(h.get('count', 0))}")
        lines.append(f"{mn}_sum {_fmt(h.get('sum', 0.0))}")
    return "\n".join(lines) + "\n" if lines else ""


class _Source:
    """One attached status source: a live callback, then (after
    ``finalize``) its frozen last snapshot."""

    __slots__ = ("status_fn", "collector", "frozen")

    def __init__(self, status_fn: Optional[Callable[[], dict]],
                 collector: Optional[Callable[[Metrics], None]]) -> None:
        self.status_fn = status_fn
        self.collector = collector
        self.frozen: Optional[dict] = None


class _Handler(BaseHTTPRequestHandler):
    server_version = "repro-monitor/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # keep scrapes off stderr
        pass

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        mon: "MonitorServer" = self.server.monitor  # type: ignore[attr-defined]
        path = urlparse(self.path).path
        try:
            if path == "/metrics":
                body = mon.metrics_text().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/status":
                body = json.dumps(mon.status_snapshot(), sort_keys=True,
                                  default=str).encode()
                ctype = "application/json"
            elif path == "/trace":
                body = json.dumps({"spans": mon.trace_tail()},
                                  sort_keys=True, default=str).encode()
                ctype = "application/json"
            elif path == "/":
                body = json.dumps({"endpoints": ["/metrics", "/status",
                                                 "/trace"]}).encode()
                ctype = "application/json"
            else:
                self.send_error(404, "unknown endpoint")
                return
        except Exception as e:  # a broken callback must not kill scrapes
            body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
            self.send_response(500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MonitorServer:
    """The live-monitoring HTTP server; see the module docstring.

    ``port=0`` binds an ephemeral port (read it back from ``.port``
    after :meth:`start`).  Handlers run on daemon threads and every
    snapshot is copy-on-read, so a slow or wedged scraper never blocks
    the tuning run.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 trace_tail: int = 256) -> None:
        self.host = host
        self.requested_port = int(port)
        self.trace_tail_limit = int(trace_tail)
        self.metrics = Metrics()
        self.tracer = None  # a repro_torch.obs.trace.Tracer, when one exists
        self._lock = threading.Lock()
        self._sources: Dict[str, _Source] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_unix = 0.0

    # ------------------------------------------------------------ lifecycle

    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def port(self) -> int:
        if self._httpd is None:
            return self.requested_port
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MonitorServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.requested_port),
                                    _Handler)
        httpd.daemon_threads = True
        httpd.monitor = self  # type: ignore[attr-defined]
        self._httpd = httpd
        self._started_unix = time.time()
        self._thread = threading.Thread(target=httpd.serve_forever,
                                        name="repro-monitor", daemon=True)
        self._thread.start()
        _REGISTRY.add(self)
        log.info("monitor serving", url=self.url)
        return self

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        _REGISTRY.discard(self)

    def __enter__(self) -> "MonitorServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ------------------------------------------------------------- sources

    def attach(self, name: str, status_fn: Optional[Callable[[], dict]],
               collector: Optional[Callable[[Metrics], None]] = None,
               tracer=None) -> str:
        """Register a status source (and optional scrape-time collector).
        Returns the actual source name — suffixed on collision, so a
        shared (borrowed) server can host several runs."""
        with self._lock:
            actual, i = name, 1
            while actual in self._sources:
                i += 1
                actual = f"{name}#{i}"
            self._sources[actual] = _Source(status_fn, collector)
        if tracer is not None and getattr(tracer, "enabled", False):
            self.tracer = tracer
        return actual

    def finalize(self, name: str) -> None:
        """Freeze ``name``'s status into its last live snapshot and run
        its collector one final time, then drop both callbacks — called
        by owners *before* tearing down what the callbacks read (e.g.
        executor close).  Idempotent; a post-run scrape then still
        serves final values."""
        with self._lock:
            src = self._sources.get(name)
        if src is None or (src.status_fn is None and src.collector is None):
            return
        status_fn, collector = src.status_fn, src.collector
        src.status_fn = src.collector = None
        if collector is not None:
            try:
                collector(self.metrics)
            except Exception as e:
                log.warn("monitor collector failed at finalize",
                         source=name, error=str(e))
        if status_fn is not None:
            try:
                src.frozen = status_fn()
            except Exception as e:
                src.frozen = {"error": f"{type(e).__name__}: {e}"}

    def detach(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    # ------------------------------------------------------------ snapshots

    def metrics_text(self) -> str:
        """Run live collectors, then render the registry — what
        ``/metrics`` serves."""
        with self._lock:
            collectors = [(n, s.collector) for n, s in self._sources.items()
                          if s.collector is not None]
        for name, collector in collectors:
            try:
                collector(self.metrics)
            except Exception as e:
                log.warn("monitor collector failed", source=name,
                         error=str(e))
        return prometheus_text(self.metrics.snapshot())

    def status_snapshot(self) -> Dict[str, object]:
        """Assemble ``/status``: one section per attached source (live
        callback or frozen final snapshot)."""
        with self._lock:
            items = list(self._sources.items())
        sources: Dict[str, object] = {}
        for name, src in items:
            if src.status_fn is not None:
                try:
                    sources[name] = src.status_fn()
                except Exception as e:
                    sources[name] = {"error": f"{type(e).__name__}: {e}"}
            elif src.frozen is not None:
                sources[name] = dict(src.frozen, final=True)
        return {"time_unix": time.time(),
                "uptime_s": (time.time() - self._started_unix
                             if self._started_unix else 0.0),
                "sources": sources}

    def trace_tail(self) -> List[Dict[str, object]]:
        tracer = self.tracer
        if tracer is None:
            return []
        return tracer.recent_spans(self.trace_tail_limit)


def coerce_monitor(monitor) -> "tuple[Optional[MonitorServer], bool]":
    """``monitor=`` coercion shared by Session / netopt / daemons:
    ``None`` -> no server; an ``int`` port -> a new *owned* server
    (started by the caller, stopped with the run); a
    :class:`MonitorServer` -> *borrowed* (caller attaches but never
    stops it).  Returns ``(server, owned)``."""
    if monitor is None:
        return None, False
    if isinstance(monitor, MonitorServer):
        return monitor, False
    return MonitorServer(port=int(monitor)), True
