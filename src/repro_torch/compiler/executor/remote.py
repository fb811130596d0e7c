"""``RemoteExecutor`` — fan measurement jobs over TCP to worker daemons.

The network sibling of :class:`~repro_torch.compiler.executor.pool.
SubprocessExecutor`: same :class:`~repro_torch.compiler.executor.base.Executor`
protocol (``submit``/``poll``/``drain``/``close``, ``MeasureHandle``
semantics unchanged), same fault semantics, but the workers are
``python -m repro_torch.compiler.executor.worker`` daemons on this or any other
host — one tuning session driving a fleet.

Routing is capability-based: each daemon advertises a
:class:`~repro_torch.compiler.executor.wire.WorkerCapabilities` descriptor at
handshake (device count, backend, env pins, job slots) and a job is only
dispatched to a daemon compatible with its
:class:`~repro_torch.compiler.executor.base.WorkerSpec` — heterogeneous pools,
where different hosts serve different topologies.  A job no *live*
endpoint can ever serve fails fast (``NoCompatibleWorker``) instead of
wedging the queue.

Fault semantics mirror the pool, with the network in place of the
process table:

* measure fn raises on the daemon    -> failed result, daemon survives;
* connection dies (crash, heartbeat
  loss after ``heartbeat_timeout_s``) -> in-flight jobs fail (the oracle
                                        maps them to ``penalty_latency``
                                        rows) and the endpoint enters
                                        bounded reconnect-with-backoff,
                                        so a restarted daemon rejoins the
                                        fleet without losing the session;
* a job exceeds ``timeout_s``
  (counted from the started-ack,
  with ``startup_grace_s`` before it) -> that job fails and the
                                        connection is dropped/re-dialed
                                        (the remote analog of killing a
                                        hung worker); other in-flight
                                        jobs on the endpoint are re-queued,
                                        not failed.

Stdlib-only, torch-free (the executor package's import-light rule).
"""
from __future__ import annotations

import collections
import selectors
import socket
import time
from typing import Deque, Dict, List, Optional, Tuple, Union

from repro_torch import obs
from repro_torch.compiler.executor.base import (Executor, MeasureHandle,
                                          MeasureResult, WorkerSpec)
from repro_torch.compiler.executor.wire import (PROTOCOL_VERSION, FrameBuffer,
                                          ProtocolError, WorkerCapabilities,
                                          encode_frame, endpoint_label,
                                          parse_endpoints, recv_frame,
                                          spec_compatible, spec_to_wire)


class _RJob:
    __slots__ = ("handle", "deadline", "started", "dispatched")

    def __init__(self, handle: MeasureHandle):
        self.handle = handle
        self.deadline: Optional[float] = None
        self.started: Optional[float] = None
        self.dispatched: Optional[float] = None


class _Endpoint:
    """One daemon address: live socket + capabilities + per-endpoint
    stats + reconnect bookkeeping."""

    def __init__(self, addr: Tuple[str, int], backoff_s: float):
        self.addr = addr
        self.label = endpoint_label(addr)
        self.sock: Optional[socket.socket] = None
        self.caps = WorkerCapabilities()
        self.buf = FrameBuffer()
        self.jobs: Dict[int, _RJob] = {}   # in flight on this connection
        self.last_rx = 0.0
        self.last_tx = 0.0
        self.alive = True                  # False = reconnects exhausted
        self.ever_connected = False
        self.attempts = 0                  # consecutive failed dials
        self.next_attempt = 0.0
        self.initial_backoff = backoff_s
        self.backoff = backoff_s
        # observability (RemoteExecutor.stats())
        self.n_jobs = 0                    # results received (ok or not)
        self.n_failures = 0                # failed results + connection-lost
        self.n_reconnects = 0              # successful re-dials
        self.ack_lat_sum = 0.0             # started-ack -> result seconds
        self.ack_lat_n = 0
        # daemon-side load telemetry (heartbeat "load", wire minor 1);
        # {} until a telemetry-speaking daemon heartbeats
        self.daemon_load: Dict[str, object] = {}

    @property
    def connected(self) -> bool:
        return self.sock is not None

    def free_slots(self) -> int:
        return self.caps.slots - len(self.jobs) if self.connected else 0

    def stats(self) -> Dict[str, object]:
        return {"connected": self.connected, "alive": self.alive,
                "slots": self.caps.slots if self.connected else 0,
                "backend": self.caps.backend,
                "device_count": self.caps.device_count,
                "jobs": self.n_jobs, "failures": self.n_failures,
                "reconnects": self.n_reconnects,
                "in_flight": len(self.jobs),
                "mean_ack_to_result_s": (self.ack_lat_sum / self.ack_lat_n
                                         if self.ack_lat_n else 0.0),
                "daemon": dict(self.daemon_load)}


class RemoteExecutor(Executor):
    """Executor over one or more TCP worker daemons.

    ``endpoints``            ``"host:port"``, ``"h1:p1,h2:p2"``, or a
                             sequence of either.
    ``timeout_s``            per-measurement limit counted from the
                             daemon's started-ack (None = unlimited).
    ``startup_grace_s``      extra pre-ack allowance (dispatch -> ack
                             covers network + factory/torch import).
    ``heartbeat_s``          how often this side emits liveness frames.
    ``heartbeat_timeout_s``  silence after which a connection is declared
                             dead (daemons heartbeat every ~2s; keep this
                             several multiples of that).
    ``reconnect_backoff_s``  initial re-dial delay, doubling per failed
                             attempt up to ``max_backoff_s``.
    ``max_reconnects``       consecutive failed dials before an endpoint
                             is abandoned for the session.
    ``max_inflight``         bound on submitted-but-unresolved jobs;
                             default ``2x`` the fleet's advertised slots.

    At least one endpoint must accept the handshake at construction —
    a fleet that is entirely unreachable is a configuration error, not
    something to retry forever.
    """

    _POLL_S = 0.02

    def __init__(self, endpoints: Union[str, List[str]],
                 timeout_s: Optional[float] = None,
                 startup_grace_s: float = 120.0,
                 heartbeat_s: float = 2.0,
                 heartbeat_timeout_s: float = 15.0,
                 reconnect_backoff_s: float = 0.5,
                 max_backoff_s: float = 8.0,
                 max_reconnects: int = 8,
                 connect_timeout_s: float = 5.0,
                 max_inflight: Optional[int] = None):
        addrs = parse_endpoints(endpoints)
        if len({endpoint_label(a) for a in addrs}) != len(addrs):
            raise ValueError(f"duplicate endpoints in {endpoints!r}")
        self.timeout_s = timeout_s
        self.startup_grace_s = startup_grace_s
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.max_backoff_s = max_backoff_s
        self.max_reconnects = max_reconnects
        self.connect_timeout_s = connect_timeout_s
        self.max_inflight = max_inflight
        self._eps = [_Endpoint(a, reconnect_backoff_s) for a in addrs]
        self._sel = selectors.DefaultSelector()
        self._queue: Deque[_RJob] = collections.deque()
        self._next_id = 0
        self._closed = False
        errors = []
        for ep in self._eps:
            try:
                self._connect(ep)
            except (OSError, ProtocolError) as e:
                errors.append(f"{ep.label}: {e}")
                self._mark_disconnected(ep)
        if not any(ep.connected for ep in self._eps):
            raise ConnectionError(
                "no worker daemon reachable: " + "; ".join(errors))
        self.n_workers = sum(ep.caps.slots for ep in self._eps
                             if ep.connected)

    # ------------------------------------------------------------- protocol
    def submit(self, task: str, settings: Dict[str, object],
               spec: Optional[WorkerSpec] = None) -> MeasureHandle:
        if self._closed:
            raise RuntimeError("executor is closed")
        handle = MeasureHandle(self._next_id, task, settings, executor=self,
                               spec=spec)
        self._next_id += 1
        self._queue.append(_RJob(handle))
        self._dispatch()
        while self._inflight() >= self._inflight_limit():
            self._service(self._POLL_S)
        return handle

    def poll(self) -> None:
        if not self._closed:
            self._service(0.0)

    def drain(self, handles: Optional[List[MeasureHandle]] = None) -> None:
        def pending() -> bool:
            if handles is not None:
                return any(not h.done() for h in handles)
            return self._inflight() > 0

        while pending():
            self._service(self._POLL_S)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for ep in self._eps:
            if ep.connected:
                try:
                    ep.sock.sendall(encode_frame({"type": "shutdown"}))
                except OSError:
                    pass
                self._disconnect_socket(ep)
            for job in ep.jobs.values():
                job.handle._resolve(MeasureResult(
                    ok=False, error="ExecutorClosed: job abandoned"))
            ep.jobs.clear()
        for job in self._queue:
            job.handle._resolve(MeasureResult(
                ok=False, error="ExecutorClosed: job abandoned"))
        self._queue.clear()
        self._sel.close()

    def stats(self) -> Dict[str, object]:
        per = {ep.label: ep.stats() for ep in self._eps}
        running = sum(len(ep.jobs) for ep in self._eps)
        return {"kind": "remote",
                "workers_alive": sum(ep.caps.slots for ep in self._eps
                                     if ep.connected),
                # the pool calls kill-and-replace "respawns"; the remote
                # analog is a successful re-dial — alias it so uniform
                # consumers need only one key
                "respawns": sum(ep.n_reconnects for ep in self._eps),
                "reconnects": sum(ep.n_reconnects for ep in self._eps),
                "queued": len(self._queue), "running": running,
                "max_inflight": self._inflight_limit(),
                "jobs": sum(ep.n_jobs for ep in self._eps),
                "failures": sum(ep.n_failures for ep in self._eps),
                "endpoints": per}

    # ---------------------------------------------------------- connections
    def _connect(self, ep: _Endpoint) -> None:
        sock = socket.create_connection(ep.addr,
                                        timeout=self.connect_timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        try:
            sock.sendall(encode_frame({"type": "hello",
                                       "version": PROTOCOL_VERSION}))
            ep.caps = WorkerCapabilities.from_wire(
                recv_frame(sock, timeout_s=self.connect_timeout_s))
        except Exception:
            sock.close()
            raise
        sock.settimeout(self.connect_timeout_s)  # bounds steady-state sends
        ep.sock = sock
        ep.buf = FrameBuffer()
        ep.last_rx = ep.last_tx = time.monotonic()
        if ep.ever_connected:
            ep.n_reconnects += 1
        ep.ever_connected = True
        ep.attempts = 0
        ep.backoff = ep.initial_backoff
        self._sel.register(sock, selectors.EVENT_READ, ep)

    def _disconnect_socket(self, ep: _Endpoint) -> None:
        if ep.sock is not None:
            try:
                self._sel.unregister(ep.sock)
            except (KeyError, ValueError):
                pass
            ep.sock.close()
            ep.sock = None

    def _mark_disconnected(self, ep: _Endpoint) -> None:
        """Schedule the next dial; abandon after ``max_reconnects``."""
        ep.attempts += 1
        if ep.attempts > self.max_reconnects:
            ep.alive = False
            return
        ep.next_attempt = time.monotonic() + ep.backoff
        ep.backoff = min(ep.backoff * 2, self.max_backoff_s)

    def _lose(self, ep: _Endpoint, error: str, requeue: bool) -> None:
        """Connection-level failure: fail (or re-queue) its in-flight jobs
        and enter reconnect backoff."""
        self._disconnect_socket(ep)
        jobs = list(ep.jobs.values())
        ep.jobs.clear()
        for job in jobs:
            if requeue:
                job.deadline = job.started = job.dispatched = None
                self._queue.appendleft(job)
            else:
                ep.n_failures += 1
                job.handle._resolve(MeasureResult(ok=False, error=error))
        self._mark_disconnected(ep)

    # -------------------------------------------------------------- routing
    def _compatible_eps(self, spec: Optional[WorkerSpec],
                        connected_only: bool) -> List[_Endpoint]:
        out = []
        for ep in self._eps:
            if not ep.alive:
                continue
            if connected_only and not ep.connected:
                continue
            # an alive-but-never-connected endpoint has unknown caps:
            # optimistically routable (it may still come up compatible)
            if (ep.connected or ep.ever_connected) \
                    and not spec_compatible(spec, ep.caps):
                continue
            out.append(ep)
        return out

    def _dispatch(self) -> None:
        """Route queued jobs to compatible endpoints with free slots
        (least-loaded first); fail jobs that no live endpoint can ever
        serve."""
        if not self._queue:
            return
        deferred: Deque[_RJob] = collections.deque()
        while self._queue:
            job = self._queue.popleft()
            spec = job.handle.spec
            ready = [ep for ep in self._compatible_eps(spec, True)
                     if ep.free_slots() > 0]
            if not ready:
                if not self._compatible_eps(spec, False):
                    job.handle._resolve(MeasureResult(
                        ok=False,
                        error="NoCompatibleWorker: no live daemon matches "
                              f"this job's spec (env={dict(spec.env) if spec else {}}); "
                              "endpoints: "
                              + ", ".join(f"{ep.label}[{'up' if ep.connected else 'down'}]"
                                          for ep in self._eps)))
                else:
                    deferred.append(job)  # compatible capacity will return
                continue
            ep = min(ready, key=lambda e: (len(e.jobs),
                                           self._eps.index(e)))
            self._send_job(ep, job)
        self._queue.extend(deferred)

    def _send_job(self, ep: _Endpoint, job: _RJob) -> None:
        h = job.handle
        msg = {"type": "job", "job_id": h.job_id, "task": h.task,
               "settings": h.settings,
               "spec": spec_to_wire(h.spec) if h.spec is not None else None}
        if h.spec is None:
            # remote daemons rebuild measure fns from specs only — there is
            # no pickled-closure fallback across the wire
            h._resolve(MeasureResult(
                ok=False, error="NoWorkerSpec: remote jobs need a "
                                "WorkerSpec naming an importable factory"))
            return
        job.dispatched = time.monotonic()
        if self.timeout_s is not None:
            job.deadline = (job.dispatched + self.timeout_s
                            + self.startup_grace_s)
        try:
            ep.sock.sendall(encode_frame(msg))
            ep.last_tx = time.monotonic()
        except OSError as e:
            self._lose(ep, f"WorkerCrash: send to {ep.label} failed ({e})",
                       requeue=False)
            job.deadline = job.dispatched = None
            self._queue.appendleft(job)
            return
        ep.jobs[h.job_id] = job

    # -------------------------------------------------------------- service
    def _inflight(self) -> int:
        return len(self._queue) + sum(len(ep.jobs) for ep in self._eps)

    def _inflight_limit(self) -> int:
        if self.max_inflight is not None:
            return self.max_inflight
        slots = sum(ep.caps.slots for ep in self._eps if ep.connected)
        return max(2 * slots, 2)

    def _service(self, block_s: float) -> None:
        """One pump: redial due endpoints, expire deadlines and silent
        connections, send/receive frames, dispatch."""
        now = time.monotonic()
        # bounded reconnect: re-dial endpoints whose backoff has elapsed
        for ep in self._eps:
            if ep.alive and not ep.connected and now >= ep.next_attempt:
                try:
                    self._connect(ep)
                except (OSError, ProtocolError):
                    self._mark_disconnected(ep)
        # per-job deadlines (timeout counted from started-ack; pre-ack the
        # startup grace applies) — a timeout drops the connection, the
        # remote analog of killing a hung worker; innocent in-flight jobs
        # on the same endpoint are re-queued, not failed
        for ep in self._eps:
            expired = [j for j in ep.jobs.values()
                       if j.deadline is not None and now > j.deadline]
            if expired:
                job = expired[0]
                del ep.jobs[job.handle.job_id]
                ep.n_jobs += 1
                ep.n_failures += 1
                job.handle._resolve(MeasureResult(
                    ok=False,
                    error=f"TimeoutError: measurement exceeded "
                          f"{self.timeout_s:.1f}s on {ep.label}; "
                          "connection dropped"))
                self._lose(ep, "timeout", requeue=True)
        # heartbeat loss
        for ep in self._eps:
            if (ep.connected
                    and now - ep.last_rx > self.heartbeat_timeout_s):
                self._lose(ep, f"WorkerCrash: {ep.label} silent for "
                               f"{self.heartbeat_timeout_s:.1f}s "
                               "(heartbeat lost)", requeue=False)
        # our own liveness frames
        for ep in self._eps:
            if ep.connected and now - ep.last_tx > self.heartbeat_s:
                try:
                    ep.sock.sendall(encode_frame({"type": "heartbeat"}))
                    ep.last_tx = now
                except OSError as e:
                    self._lose(ep, f"WorkerCrash: heartbeat to {ep.label} "
                                   f"failed ({e})", requeue=False)
        # inbound frames
        if any(ep.connected for ep in self._eps):
            for key, _ in self._sel.select(timeout=max(block_s, 0.0)):
                ep: _Endpoint = key.data
                if not ep.connected:
                    continue
                try:
                    data = ep.sock.recv(1 << 20)
                except socket.timeout:
                    continue
                except OSError as e:
                    self._lose(ep, f"WorkerCrash: read from {ep.label} "
                                   f"failed ({e})", requeue=False)
                    continue
                if not data:
                    self._lose(ep, f"WorkerCrash: connection to {ep.label} "
                                   "closed mid-measurement", requeue=False)
                    continue
                ep.last_rx = time.monotonic()
                try:
                    msgs = ep.buf.feed(data)
                except ProtocolError as e:
                    self._lose(ep, f"WorkerCrash: protocol error from "
                                   f"{ep.label} ({e})", requeue=False)
                    continue
                for msg in msgs:
                    self._handle_frame(ep, msg)
        elif block_s > 0:
            time.sleep(min(block_s, self._POLL_S))
        # a fully-dead fleet must fail fast, not spin drain() forever
        if not any(ep.alive for ep in self._eps):
            for ep in self._eps:
                for job in ep.jobs.values():
                    ep.n_failures += 1
                    job.handle._resolve(MeasureResult(
                        ok=False, error="FleetDown: every endpoint "
                                        "exhausted its reconnect budget"))
                ep.jobs.clear()
            while self._queue:
                self._queue.popleft().handle._resolve(MeasureResult(
                    ok=False, error="FleetDown: every endpoint exhausted "
                                    "its reconnect budget"))
        self._dispatch()

    def _handle_frame(self, ep: _Endpoint, msg: Dict[str, object]) -> None:
        t = msg.get("type")
        if t == "started":
            job = ep.jobs.get(msg.get("job_id"))
            if job is not None:
                job.started = time.monotonic()
                if self.timeout_s is not None:
                    job.deadline = job.started + self.timeout_s
        elif t == "result":
            job = ep.jobs.pop(msg.get("job_id"), None)
            if job is None:
                return  # stale: a job we already timed out / re-queued
            ep.n_jobs += 1
            if job.started is not None:
                ep.ack_lat_sum += time.monotonic() - job.started
                ep.ack_lat_n += 1
            ok = bool(msg.get("ok"))
            if not ok:
                ep.n_failures += 1
            span = msg.get("span")
            if isinstance(span, dict):
                # daemon-timed measure span (wire minor 1): merge into the
                # session's timeline under this endpoint's lane
                try:
                    obs.current().add_span(
                        str(span.get("name", "measure")),
                        cat=str(span.get("cat", "measure")),
                        wall_start_s=float(span["t_wall"]),
                        dur_s=float(span["dur_s"]),
                        tid=ep.label,
                        args={"task": str(span.get("task", ""))})
                except (KeyError, TypeError, ValueError):
                    pass  # malformed telemetry must never fail a result
            job.handle._resolve(MeasureResult(
                ok=ok, value=msg.get("value") if ok else None,
                error="" if ok else str(msg.get("error", "unknown"))))
        elif t == "heartbeat":
            load = msg.get("load")
            if isinstance(load, dict):  # wire minor 1 telemetry
                ep.daemon_load = load
        # heartbeats already refreshed last_rx; ignore unknown types
