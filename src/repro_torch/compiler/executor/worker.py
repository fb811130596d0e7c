"""Measurement worker daemon — the server side of the remote fabric.

    python -m repro_torch.compiler.executor.worker --listen HOST:PORT \
        [--slots N] [--backend cpu] [--device-count N]

One daemon serves measurement jobs over TCP to any number of
:class:`~repro_torch.compiler.executor.remote.RemoteExecutor` clients, speaking
the versioned frame protocol of :mod:`repro_torch.compiler.executor.wire`.  Per
connection: handshake (hello -> capabilities), then jobs fan across
``slots`` runner threads while a heartbeat thread keeps the client's
liveness detector fed.  Factory resolution follows the subprocess pool's
worker semantics exactly — each distinct :class:`~repro_torch.compiler.executor
.base.WorkerSpec` resolves once per daemon *process*, its env pins are
applied before the first resolution, and a spec whose pins contradict the
already-initialized runtime fails its jobs loudly (``WorkerEnvConflict``)
instead of silently measuring the wrong topology.

``slots > 1`` runs jobs as threads of ONE process (they share a runtime);
that is right for stub/IO-bound oracles, while oracles that hold a GPU want
``--slots 1`` and one daemon per core — crash isolation then comes from
daemon granularity, with the executor's reconnect logic riding out a
restarted daemon.

Security: trusted networks only.  A job names an importable factory this
process will call — the protocol deliberately has no authentication
(see the ``wire`` module docstring); bind to loopback or a private
fabric, never a public interface.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
import traceback
from typing import Dict, Optional, Tuple

from repro_torch.compiler.executor.base import WorkerSpec, resolve_factory
from repro_torch.compiler.executor.wire import (PROTOCOL_VERSION, FrameBuffer,
                                          ProtocolError, WorkerCapabilities,
                                          device_count_pin, encode_frame,
                                          parse_endpoints, spec_from_wire)
from repro_torch.obs import log


class _FactoryCache:
    """Daemon-wide spec -> measure-fn cache with the pool's env-pin
    semantics (env is process-global, so the cache must be too)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._fns: Dict[Tuple, Tuple[Optional[object], Optional[str]]] = {}

    def resolve(self, spec: WorkerSpec):
        key = spec.cache_key()
        with self._lock:
            if key not in self._fns:
                stale = {k: v for k, v in spec.env.items()
                         if os.environ.get(k) != v}
                if self._fns and stale:
                    self._fns[key] = (
                        None, "WorkerEnvConflict: spec needs "
                        f"{stale} but this daemon's runtime already "
                        "initialized under "
                        f"{ {k: os.environ.get(k) for k in stale} }")
                else:
                    try:
                        os.environ.update(dict(spec.env))
                        self._fns[key] = (resolve_factory(spec), None)
                    except Exception:
                        self._fns[key] = (
                            None, "WorkerInitError: "
                            + traceback.format_exc(limit=4).strip())
            return self._fns[key]


class _Connection:
    """One client connection: reader loop + heartbeat + job runners."""

    def __init__(self, daemon: "WorkerDaemon", sock: socket.socket,
                 peer: str):
        self.daemon = daemon
        self.sock = sock
        self.peer = peer
        self._wlock = threading.Lock()
        self._closed = threading.Event()
        self._slots = threading.Semaphore(daemon.capabilities.slots)

    # every write shares one lock: job runners, heartbeats, and the
    # handshake interleave on this socket
    def send(self, msg: Dict[str, object]) -> bool:
        if self._closed.is_set():
            return False
        try:
            with self._wlock:
                self.sock.sendall(encode_frame(msg))
            return True
        except OSError:
            self.close()
            return False

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.sock.close()

    # ----------------------------------------------------------- lifecycle
    def run(self) -> None:
        try:
            if not self._handshake():
                return
            hb = threading.Thread(target=self._heartbeat_loop, daemon=True)
            hb.start()
            self._read_loop()
        finally:
            self.close()

    def _handshake(self) -> bool:
        buf = FrameBuffer()
        self.sock.settimeout(self.daemon.handshake_timeout_s)
        try:
            while True:
                data = self.sock.recv(65536)
                if not data:
                    return False
                msgs = buf.feed(data)
                if msgs:
                    hello = msgs[0]
                    break
        except (OSError, ProtocolError):
            return False
        if (hello.get("type") != "hello"
                or hello.get("version") != PROTOCOL_VERSION):
            self.send({"type": "error",
                       "error": f"unsupported hello {hello.get('type')!r} "
                                f"v{hello.get('version')} (this daemon "
                                f"speaks v{PROTOCOL_VERSION})"})
            return False
        self.sock.settimeout(self.daemon.read_timeout_s)
        return self.send(self.daemon.capabilities.to_wire())

    def _heartbeat_loop(self) -> None:
        while not self._closed.wait(self.daemon.heartbeat_s):
            # minor-1 extension: load telemetry rides the liveness frame
            # (old executors ignore unknown keys)
            if not self.send({"type": "heartbeat",
                              "load": self.daemon.load_snapshot()}):
                return

    def _read_loop(self) -> None:
        buf = FrameBuffer()
        while not self._closed.is_set() and not self.daemon.stopping:
            try:
                data = self.sock.recv(65536)
            except socket.timeout:
                continue  # periodic stop-flag check
            except OSError:
                return
            if not data:
                return  # client went away
            try:
                msgs = buf.feed(data)
            except ProtocolError:
                return
            for msg in msgs:
                t = msg.get("type")
                if t == "job":
                    threading.Thread(target=self._run_job, args=(msg,),
                                     daemon=True).start()
                elif t == "shutdown":
                    if msg.get("scope") == "daemon":
                        self.daemon.stop()
                    return
                # heartbeats (and unknown types, for forward compat) are
                # liveness only — nothing to do

    # ----------------------------------------------------------------- jobs
    def _run_job(self, msg: Dict[str, object]) -> None:
        job_id = msg.get("job_id")
        with self._slots:  # the client never oversubscribes; belt-and-braces
            try:
                spec = spec_from_wire(msg["spec"])
                settings = dict(msg.get("settings") or {})
            except Exception as e:
                self.send({"type": "result", "job_id": job_id, "ok": False,
                           "error": f"ProtocolError: bad job frame: {e}"})
                return
            fn, init_error = self.daemon.factories.resolve(spec)
            if init_error is not None:
                self.send({"type": "result", "job_id": job_id, "ok": False,
                           "error": init_error})
                return
            # started-ack: factory/runtime import is done, the measurement
            # itself begins now — the executor re-arms the job's timeout
            # clock on this frame (same contract as the subprocess pool)
            if not self.send({"type": "started", "job_id": job_id}):
                return
            # the daemon times its own measure fn and ships the span in
            # the result frame (minor-1 extension), so the session's
            # trace carries daemon-side extents, not client-side guesses
            t_wall = time.time()
            t0 = time.monotonic()
            self.daemon.job_started()
            try:
                value = fn(settings)
            except Exception as e:  # infeasible configuration
                dur = time.monotonic() - t0
                self.daemon.job_finished(dur)
                self.send({"type": "result", "job_id": job_id, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "span": self.daemon.job_span(msg, t_wall, dur)})
            else:
                dur = time.monotonic() - t0
                self.daemon.job_finished(dur)
                self.send({"type": "result", "job_id": job_id, "ok": True,
                           "value": value,
                           "span": self.daemon.job_span(msg, t_wall, dur)})


class WorkerDaemon:
    """TCP measurement daemon; embeddable (``start()``) or standalone
    (``serve_forever()`` via the module CLI)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 slots: int = 1, backend: str = "cpu",
                 device_count: Optional[int] = None,
                 heartbeat_s: float = 2.0, verbose: bool = False,
                 status_port: Optional[int] = None):
        if device_count is None:
            # advertise the topology this process is already pinned to, so
            # heterogeneous routing works without repeating --device-count
            device_count = device_count_pin(os.environ)
        self.capabilities = WorkerCapabilities(
            slots=max(int(slots), 1), backend=backend,
            device_count=device_count,
            env=({"XLA_FLAGS": os.environ["XLA_FLAGS"]}
                 if "XLA_FLAGS" in os.environ else {}),
            pid=os.getpid(), host=socket.gethostname())
        self.heartbeat_s = heartbeat_s
        self.handshake_timeout_s = 10.0
        self.read_timeout_s = 0.25
        self.verbose = verbose
        self.factories = _FactoryCache()
        # load telemetry shipped inside heartbeat frames (see wire.py)
        self._load_lock = threading.Lock()
        self.busy = 0            # jobs currently measuring
        self.jobs_done = 0       # measure fn completions (ok or raised)
        self.measure_s_sum = 0.0
        self.stopping = False
        # self-served monitoring (--status-port): each daemon exposes its
        # own /metrics + /status, so fleet health is scrapeable even for
        # daemons no executor is currently connected to
        self.monitor = None
        if status_port is not None:
            from repro_torch.obs.serve import MonitorServer
            self.monitor = MonitorServer(port=int(status_port), host=host)
        self._conns: list[_Connection] = []
        self._thread: Optional[threading.Thread] = None
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(16)
        self._listener.settimeout(0.25)
        self.address: Tuple[str, int] = self._listener.getsockname()[:2]

    @property
    def endpoint(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    # --------------------------------------------------- load telemetry
    def job_started(self) -> None:
        with self._load_lock:
            self.busy += 1

    def job_finished(self, dur_s: float) -> None:
        with self._load_lock:
            self.busy -= 1
            self.jobs_done += 1
            self.measure_s_sum += dur_s

    def load_snapshot(self) -> Dict[str, object]:
        with self._load_lock:
            mean = (self.measure_s_sum / self.jobs_done
                    if self.jobs_done else None)
            return {"busy": self.busy, "jobs_done": self.jobs_done,
                    "mean_measure_s": mean}

    @staticmethod
    def job_span(msg: Dict[str, object], t_wall: float,
                 dur_s: float) -> Dict[str, object]:
        """Result-frame span payload for one measure-fn execution."""
        return {"name": "measure", "cat": "measure",
                "t_wall": t_wall, "dur_s": dur_s,
                "task": str(msg.get("task", ""))}

    def _status(self) -> Dict[str, object]:
        caps = self.capabilities
        return {"kind": "worker", "endpoint": self.endpoint,
                "slots": caps.slots, "backend": caps.backend,
                "device_count": caps.device_count,
                "pid": caps.pid, "host": caps.host,
                "connections": sum(1 for c in list(self._conns)
                                   if not c._closed.is_set()),
                "load": self.load_snapshot()}

    def _collect_metrics(self, metrics) -> None:
        load = self.load_snapshot()
        metrics.counter("worker.jobs_done").value = float(load["jobs_done"])
        metrics.gauge("worker.busy").set(float(load["busy"]))
        with self._load_lock:
            metrics.counter("worker.measure_s").value = self.measure_s_sum

    def serve_forever(self) -> None:
        if self.monitor is not None:
            # attach BEFORE start: the instant `running` flips true a
            # scraper may hit /status, and it must already see "worker"
            self.monitor.attach("worker", self._status,
                                collector=self._collect_metrics)
            self.monitor.start()
            log.log("warn" if self.verbose else "info",
                    f"worker daemon status at {self.monitor.url}")
        log.log("warn" if self.verbose else "info",
                f"worker daemon listening on {self.endpoint} "
                f"(slots={self.capabilities.slots}, "
                f"backend={self.capabilities.backend}, "
                f"device_count={self.capabilities.device_count})")
        while not self.stopping:
            try:
                sock, peer = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break  # listener closed by stop()
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(self, sock, f"{peer[0]}:{peer[1]}")
            self._conns.append(conn)
            threading.Thread(target=conn.run, daemon=True).start()
        self._listener.close()

    def start(self) -> "WorkerDaemon":
        """Serve on a background thread (in-process daemons for tests and
        the loopback throughput bench)."""
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.stopping = True
        self._listener.close()
        for conn in self._conns:
            conn.close()
        if self.monitor is not None:
            self.monitor.stop()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


# ------------------------------------------------------------------ spawn

def spawn_daemon(slots: int = 1, backend: str = "cpu",
                 device_count: Optional[int] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 heartbeat_s: float = 2.0, timeout_s: float = 30.0,
                 env: Optional[Dict[str, str]] = None):
    """Spawn ``python -m repro_torch.compiler.executor.worker`` as a subprocess;
    returns ``(Popen, "host:port")`` once the daemon is accepting.  The
    bound port is discovered through ``--port-file`` (so ``port=0`` works),
    making this the one spawn path tests and benches share."""
    import subprocess
    import tempfile
    import time
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    penv = dict(os.environ if env is None else env)
    penv["PYTHONPATH"] = src + os.pathsep + penv.get("PYTHONPATH", "")
    fd, port_file = tempfile.mkstemp(prefix="worker-port-")
    os.close(fd)
    os.unlink(port_file)  # the daemon creates it once bound
    cmd = [sys.executable, "-m", "repro_torch.compiler.executor.worker",
           "--listen", f"{host}:{port}", "--slots", str(slots),
           "--backend", backend, "--heartbeat-s", str(heartbeat_s),
           "--port-file", port_file]
    if device_count is not None:
        cmd += ["--device-count", str(device_count)]
    proc = subprocess.Popen(cmd, env=penv)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            with open(port_file) as f:
                endpoint = f.read().strip()
            if endpoint:
                os.unlink(port_file)
                return proc, endpoint
        if proc.poll() is not None:
            raise RuntimeError(f"worker daemon exited rc={proc.returncode} "
                               "before binding")
        time.sleep(0.02)
    proc.kill()
    raise RuntimeError(f"worker daemon did not bind within {timeout_s}s")


# -------------------------------------------------------------------- CLI

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compiler.executor.worker",
        description="Measurement worker daemon for RemoteExecutor "
                    "(trusted networks only — no authentication).")
    ap.add_argument("--listen", required=True, metavar="HOST:PORT",
                    help="bind address (port 0 = ephemeral; see "
                         "--port-file)")
    ap.add_argument("--slots", type=int, default=1,
                    help="concurrent jobs (threads of one process; keep 1 "
                         "for oracles that hold a GPU)")
    ap.add_argument("--backend", default="cpu",
                    help="advertised backend tag for heterogeneous routing")
    ap.add_argument("--device-count", type=int, default=None,
                    help="advertised device count (default: parsed from "
                         "this process's XLA_FLAGS pin, else wildcard)")
    ap.add_argument("--heartbeat-s", type=float, default=2.0,
                    help="liveness frame interval")
    ap.add_argument("--port-file", default=None,
                    help="write the bound HOST:PORT here once listening "
                         "(spawners using port 0 read it back)")
    ap.add_argument("--status-port", type=int, default=None,
                    metavar="PORT",
                    help="self-serve /metrics + /status on this HTTP port "
                         "(0 = ephemeral; off by default)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    (host, port), = parse_endpoints(args.listen)
    daemon = WorkerDaemon(host=host, port=port, slots=args.slots,
                          backend=args.backend,
                          device_count=args.device_count,
                          heartbeat_s=args.heartbeat_s,
                          verbose=args.verbose or args.port_file is None,
                          status_port=args.status_port)
    if args.port_file:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(daemon.endpoint)
        os.replace(tmp, args.port_file)  # atomic: readers see whole lines
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
