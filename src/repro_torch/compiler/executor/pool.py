"""``SubprocessExecutor`` — a crash-isolated pool of measurement workers.

Each worker is a *spawned* (never forked — CUDA state does not survive a
fork) process serving ``(job_id, spec, task, settings) -> (job_id, ok,
payload)`` over a duplex pipe.  The :class:`~repro_torch.compiler.executor.
base.WorkerSpec` travels with each job: the worker applies its env
(runtime pins such as ``CUDA_VISIBLE_DEVICES``) and resolves its measure-fn factory once
per distinct spec, so one pool can serve every task of a session.

The parent keeps all the bookkeeping: a bounded submission queue, one
in-flight job per worker, per-job deadlines.  Three failure classes all
resolve to a failed :class:`MeasureResult` without disturbing the rest of
the pool:

* the measure fn raises          -> worker survives, reports the error;
* the worker process dies        -> detected via its sentinel, respawned;
* the job exceeds ``timeout_s``  -> the (hung) worker is killed and
                                    respawned.

Every respawn is lazy — a replacement is only spawned when there is
queued work to give it.
"""
from __future__ import annotations

import collections
import math
import os
import time
import traceback
from multiprocessing import connection, get_context
from typing import Deque, Dict, List, Optional

from repro_torch import obs
from repro_torch.compiler.executor.base import (Executor, MeasureHandle,
                                          MeasureResult, WorkerSpec,
                                          resolve_factory)

_SHUTDOWN = None  # sentinel job telling a worker to exit cleanly
_STARTED = "__started__"  # worker -> parent: measurement underway


def _worker_main(conn) -> None:
    """Worker process entry point (module-level: spawn-picklable).

    Each job carries its :class:`WorkerSpec`; the worker applies the
    spec's env and resolves its factory once per distinct spec, then
    caches the measure fn — so one pool serves every task of a
    multi-task session.  A spec whose factory fails to resolve fails its
    jobs identically instead of crash-looping the pool through respawns.
    """
    fns = {}  # spec.cache_key() -> (measure fn | None, init_error | None)
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return  # parent went away
        if msg is _SHUTDOWN:
            return
        job_id, spec, _task, settings = msg
        key = spec.cache_key()
        if key not in fns:
            # Env pins only take effect before the runtime (torch/CUDA) first
            # initializes in this process — i.e. before the first factory
            # resolution.  Once any factory has resolved, a later spec's
            # env entries must already be in force (same value, whether
            # set by an earlier spec or inherited from the parent);
            # anything else would silently measure the wrong topology,
            # so it fails this spec's jobs loudly instead.
            stale = {k: v for k, v in spec.env.items()
                     if os.environ.get(k) != v}
            if fns and stale:
                fns[key] = (None, "WorkerEnvConflict: spec needs "
                            f"{stale} but this worker's runtime already "
                            "initialized under "
                            f"{ {k: os.environ.get(k) for k in stale} }")
            else:
                try:
                    os.environ.update(dict(spec.env))
                    fns[key] = (resolve_factory(spec), None)
                except Exception:
                    fns[key] = (None, "WorkerInitError: "
                                + traceback.format_exc(limit=4).strip())
        fn, init_error = fns[key]
        if init_error is not None:
            conn.send((job_id, False, init_error))
            continue
        # ack: startup (spawn + factory/torch import) is done, the
        # measurement itself starts now — the parent restarts the
        # timeout clock so slow worker start-up is never billed to the
        # configuration being measured
        conn.send((_STARTED, job_id))
        try:
            out = fn(settings)
        except Exception as e:  # infeasible configuration
            conn.send((job_id, False, f"{type(e).__name__}: {e}"))
        else:
            conn.send((job_id, True, out))


def adaptive_inflight(workers: int, ema_duration_s: Optional[float],
                      lead_s: float = 0.25, max_depth: int = 8) -> int:
    """In-flight bound from observed measurement durations.

    The bound balances two failure modes: *short* measurements starve the
    pool between parent service pumps unless a deep queue keeps workers
    fed, while *long* measurements (SPMD compiles) should keep the classic
    shallow bound so ``submit`` hands control back to the parent quickly
    (overlapping MAPPO/GBT work) and queued work tracks the freshest
    surrogate.  The queue is sized to ~``lead_s`` seconds of work per
    worker on top of the one job each runs, clamped to [2, ``max_depth``]x
    the worker count; with no observations yet it is the historical
    ``2 * workers`` default.
    """
    if ema_duration_s is None:
        return 2 * workers
    depth = 1 + math.ceil(lead_s / max(ema_duration_s, 1e-6))
    return workers * int(min(max(depth, 2), max_depth))


class _Job:
    __slots__ = ("handle", "deadline", "started", "dispatched")

    def __init__(self, handle: MeasureHandle):
        self.handle = handle
        self.deadline: Optional[float] = None  # set at dispatch time
        self.started: Optional[float] = None   # set at the worker's ack
        self.dispatched: Optional[float] = None  # sent to a worker


class _Worker:
    __slots__ = ("proc", "conn", "job")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn
        self.job: Optional[_Job] = None


class SubprocessExecutor(Executor):
    """Fan measurement jobs across ``workers`` spawned processes.

    ``spec``           default measure-fn factory; jobs may override it
                       per ``submit`` (a session shares one pool across
                       all its tasks this way).  ``None`` is allowed when
                       every job brings its own spec.
    ``timeout_s``      per-measurement wall-clock limit (None = unlimited),
                       counted from the worker's started-ack — never from
                       dispatch — so cold-worker startup (spawn + factory/
                       torch import) is not billed to the configuration
                       being measured.
    ``startup_grace_s``extra allowance a dispatched job gets *before* the
                       ack arrives; a worker hung in startup is killed
                       after ``timeout_s + startup_grace_s``.
    ``max_inflight``   bound on submitted-but-unresolved jobs; ``submit``
                       blocks (servicing the pool) once it is reached.
                       ``None`` (default) adapts the bound to observed
                       measurement durations (``adaptive_inflight``):
                       starts at the classic ``2 * workers`` and deepens
                       up to ``8 * workers`` for sub-second measurements
                       that would otherwise starve the pool between
                       service pumps; an explicit int pins the bound.
    """

    _POLL_S = 0.02  # service granularity when blocking

    def __init__(self, spec: Optional[WorkerSpec] = None, workers: int = 2,
                 timeout_s: Optional[float] = None,
                 max_inflight: Optional[int] = None,
                 startup_grace_s: float = 120.0):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.spec = spec
        self.n_workers = int(workers)
        self.timeout_s = timeout_s
        self.startup_grace_s = startup_grace_s
        self.max_inflight = max_inflight  # None = adaptive
        self._ema_duration_s: Optional[float] = None
        self.respawns = 0  # workers killed (timeout) or found dead (crash)
        self.jobs_done = 0  # resolved jobs (ok or failed)
        self.failures = 0   # resolved with ok=False (incl. crashes)
        self._ctx = get_context("spawn")
        self._workers: List[_Worker] = []
        self._queue: Deque[_Job] = collections.deque()
        self._next_id = 0
        self._closed = False

    # ------------------------------------------------------------- protocol
    def submit(self, task: str, settings: Dict[str, object],
               spec: Optional[WorkerSpec] = None) -> MeasureHandle:
        if self._closed:
            raise RuntimeError("executor is closed")
        spec = spec or self.spec
        if spec is None:
            raise ValueError("no WorkerSpec: executor has no default and "
                             "the job carried none")
        handle = MeasureHandle(self._next_id, task, settings, executor=self,
                               spec=spec)
        self._next_id += 1
        self._queue.append(_Job(handle))
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
            self._dispatch()
            self._service(self._POLL_S)

    def start(self) -> None:
        """Pre-spawn the full pool (optional — dispatch spawns lazily)."""
        while len(self._workers) < self.n_workers:
            self._spawn()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for w in self._workers:
            if w.job is None:
                try:
                    w.conn.send(_SHUTDOWN)
                except (OSError, BrokenPipeError):
                    pass
            else:  # abandon in-flight work
                w.proc.kill()
                w.job.handle._resolve(MeasureResult(
                    ok=False, error="ExecutorClosed: job abandoned"))
                w.job = None
        for w in self._workers:
            w.proc.join(timeout=2.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=1.0)
            w.conn.close()
        self._workers.clear()
        for job in self._queue:  # never dispatched
            job.handle._resolve(MeasureResult(
                ok=False, error="ExecutorClosed: job abandoned"))
        self._queue.clear()

    def stats(self) -> Dict[str, object]:
        return {"kind": "subprocess",
                "workers_alive": len(self._workers),
                "respawns": self.respawns,
                "queued": len(self._queue),
                "running": sum(1 for w in self._workers
                               if w.job is not None),
                "max_inflight": self._inflight_limit(),
                "jobs": self.jobs_done,
                "failures": self.failures}

    # ------------------------------------------------------------ internals
    def _inflight_limit(self) -> int:
        if self.max_inflight is not None:
            return self.max_inflight
        return adaptive_inflight(self.n_workers, self._ema_duration_s)

    def _observe_duration(self, duration_s: float) -> None:
        """Fold one measurement's ack-to-result duration into the EMA the
        adaptive in-flight bound is computed from."""
        if self._ema_duration_s is None:
            self._ema_duration_s = duration_s
        else:
            self._ema_duration_s = (0.7 * self._ema_duration_s
                                    + 0.3 * duration_s)

    def _inflight(self) -> int:
        return len(self._queue) + sum(1 for w in self._workers
                                      if w.job is not None)

    def _spawn(self) -> _Worker:
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=_worker_main,
                                 args=(child_conn,), daemon=True)
        proc.start()
        child_conn.close()  # parent keeps its end only
        w = _Worker(proc, parent_conn)
        self._workers.append(w)
        return w

    def _dispatch(self) -> None:
        """Hand queued jobs to idle workers, spawning up to the pool size."""
        idle = [w for w in self._workers if w.job is None]
        while self._queue and (idle or len(self._workers) < self.n_workers):
            w = idle.pop() if idle else self._spawn()
            job = self._queue.popleft()
            if self.timeout_s is not None:
                # pre-ack deadline: measurement budget + startup grace;
                # the _STARTED ack re-arms it to the pure timeout_s
                job.deadline = (time.monotonic() + self.timeout_s
                                + self.startup_grace_s)
            job.dispatched = time.monotonic()
            try:
                w.conn.send((job.handle.job_id, job.handle.spec,
                             job.handle.task, job.handle.settings))
            except (OSError, BrokenPipeError):
                self._reap(w, "WorkerCrash: pipe closed before dispatch")
                self._queue.appendleft(job)
                job.deadline = None
                job.dispatched = None
                continue
            w.job = job

    def _reap(self, w: _Worker, error: str) -> None:
        """Remove a dead/hung worker, failing its in-flight job."""
        self.respawns += 1
        if w.proc.is_alive():
            w.proc.kill()
        w.proc.join(timeout=2.0)
        w.conn.close()
        self._workers.remove(w)
        if w.job is not None:
            self.jobs_done += 1
            self.failures += 1
            w.job.handle._resolve(MeasureResult(ok=False, error=error))
            w.job = None

    def _service(self, block_s: float) -> None:
        """One pump of the event loop: expire deadlines, collect results,
        detect crashes, refill workers.  Blocks at most ``block_s``."""
        now = time.monotonic()
        for w in list(self._workers):
            if (w.job is not None and w.job.deadline is not None
                    and now > w.job.deadline and not w.conn.poll()):
                self._reap(w, "TimeoutError: measurement exceeded "
                              f"{self.timeout_s:.1f}s; worker killed")
        busy = [w for w in self._workers if w.job is not None]
        if not busy:
            self._dispatch()
            return
        timeout = block_s
        deadlines = [w.job.deadline for w in busy
                     if w.job.deadline is not None]
        if deadlines:
            timeout = max(0.0, min(timeout, min(deadlines) - now))
        sources, by_source = [], {}
        for w in busy:
            sources += [w.conn, w.proc.sentinel]
            by_source[w.conn] = w
            by_source[w.proc.sentinel] = w
        ready = connection.wait(sources, timeout=timeout)
        seen = set()
        for src in ready:
            w = by_source[src]
            if id(w) in seen or w.job is None:
                continue
            seen.add(id(w))
            # Prefer the pipe even when the sentinel fired: a worker that
            # wrote its result and then died still counts as a success.
            if w.conn.poll():
                try:
                    msg = w.conn.recv()
                except (EOFError, OSError):
                    self._reap(w, "WorkerCrash: worker process died "
                                  "mid-measurement")
                    continue
                if msg[0] == _STARTED:
                    # measurement begins now: restart the clock so worker
                    # start-up (spawn + torch/factory import) is not billed
                    # to this configuration
                    if msg[1] == w.job.handle.job_id:
                        w.job.started = time.monotonic()
                        if w.job.deadline is not None:
                            w.job.deadline = w.job.started + self.timeout_s
                        if w.job.dispatched is not None:
                            # dispatch->ack: worker startup + queue latency
                            obs.current().add_span_mono(
                                "dispatch", cat="executor",
                                start_mono_s=w.job.dispatched,
                                dur_s=w.job.started - w.job.dispatched,
                                tid=f"pool-w{w.proc.pid}",
                                args={"task": w.job.handle.task})
                    continue
                job_id, ok, payload = msg
                if job_id != w.job.handle.job_id:
                    # stale result from a pre-timeout job on a reused
                    # worker cannot happen (workers are killed on
                    # timeout), but guard against protocol drift
                    continue
                if w.job.started is not None:  # feed the adaptive bound
                    dur = time.monotonic() - w.job.started
                    self._observe_duration(dur)
                    obs.current().add_span_mono(
                        "measure", cat="measure",
                        start_mono_s=w.job.started, dur_s=dur,
                        tid=f"pool-w{w.proc.pid}",
                        args={"task": w.job.handle.task})
                self.jobs_done += 1
                if not ok:
                    self.failures += 1
                w.job.handle._resolve(
                    MeasureResult(ok=bool(ok), value=payload if ok else None,
                                  error="" if ok else str(payload)))
                w.job = None
            elif not w.proc.is_alive():
                self._reap(w, "WorkerCrash: worker process died "
                              "mid-measurement (exitcode "
                              f"{w.proc.exitcode})")
        self._dispatch()
