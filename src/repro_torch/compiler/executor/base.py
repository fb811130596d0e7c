"""Executor protocol, result/handle types, and the in-process executor.

Measurement jobs are *data*: a task name plus a decoded knob-settings
dict.  What actually runs them is a measure function built by a factory —
either a plain callable (``SerialExecutor(fn=...)``) or a
:class:`WorkerSpec` naming an importable module-level factory, so a
spawned worker process can rebuild the function on its side without
pickling closures.

Stdlib-only on purpose: see the package docstring.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class WorkerSpec:
    """How a worker (re)builds its measure function.

    ``factory`` is ``"package.module:callable"``; the callable is invoked
    with ``*args, **kwargs`` and must return ``fn(settings) -> result``.
    ``env`` entries are applied to ``os.environ`` *before* the factory
    module is imported — where a worker's runtime pins are set before it
    initializes (``CUDA_VISIBLE_DEVICES`` for a factory that touches the
    card; ``XLA_FLAGS`` device-count pins in the reference's compile
    oracle, which the wire protocol still routes on).
    """

    factory: str
    args: Tuple = ()
    kwargs: Mapping[str, object] = dataclasses.field(default_factory=dict)
    env: Mapping[str, str] = dataclasses.field(default_factory=dict)

    def cache_key(self) -> Tuple:
        """Stable identity for caching resolved measure fns: one executor
        can serve jobs from many specs (one per tuning task), resolving
        each factory once per worker."""
        return (self.factory, tuple(self.args),
                tuple(sorted((k, repr(v)) for k, v in self.kwargs.items())),
                tuple(sorted(self.env.items())))


def resolve_factory(spec: WorkerSpec) -> Callable[[Dict[str, object]], object]:
    """Import ``spec.factory`` and call it -> the measure function."""
    mod_name, sep, attr = spec.factory.partition(":")
    if not sep or not attr:
        raise ValueError(f"WorkerSpec.factory must be 'module:callable', "
                         f"got {spec.factory!r}")
    factory = getattr(importlib.import_module(mod_name), attr)
    return factory(*spec.args, **dict(spec.kwargs))


@dataclasses.dataclass
class MeasureResult:
    """Outcome of one measurement job, however it was executed.

    ``ok=False`` covers all three failure classes — the measure function
    raised, the worker process died, or the job exceeded its timeout —
    distinguished only by the ``error`` string.  The oracle maps every
    failed result to its ``penalty_latency`` row.
    """

    ok: bool
    value: object = None
    error: str = ""


def add_worker_args(parser) -> None:
    """The one definition of the ``--workers``/``--timeout-s``/``--remote``
    CLI surface (every tuning entry point shares it — keep help text and
    defaults from drifting apart)."""
    parser.add_argument(
        "--workers", type=int, default=0,
        help="parallel measurement worker processes (0 = in-process; "
             "batched analytical oracles ignore this)")
    parser.add_argument(
        "--timeout-s", type=float, default=None,
        help="per-measurement timeout in seconds, counted from when the "
             "measurement starts on a worker (needs --workers >= 1 or "
             "--remote)")
    parser.add_argument(
        "--remote", metavar="HOST:PORT[,HOST:PORT...]", default=None,
        help="measure on remote worker daemons (python -m "
             "repro_torch.compiler.executor.worker --listen HOST:PORT) instead "
             "of a local pool; mutually exclusive with --workers")
    parser.add_argument(
        "--trace", metavar="PATH", default=None,
        help="write a span-level trace of the run: Chrome-trace JSON "
             "(load in Perfetto / chrome://tracing; summarize with "
             "tools/trace_summary.py), or raw JSONL if PATH ends in "
             ".jsonl")
    parser.add_argument(
        "--trace-sample-rate", type=float, default=1.0, metavar="RATE",
        help="keep this fraction of per-measurement measure/dispatch "
             "spans in the trace (phase-level spans are always kept; "
             "dropped spans stay accounted in the trace's sampling "
             "metadata); needs --trace")
    parser.add_argument(
        "--monitor", type=int, default=None, metavar="PORT",
        help="serve live /metrics (Prometheus), /status (JSON), and "
             "/trace on http://127.0.0.1:PORT for the duration of the "
             "run (0 = ephemeral port)")


def validate_worker_args(parser, args) -> None:
    """Shared checks: one transport per session, and a timeout is only
    enforceable where measurements can be preempted."""
    if getattr(args, "remote", None) and args.workers:
        parser.error("--remote and --workers are mutually exclusive: one "
                     "measurement transport per session (remote daemons "
                     "bring their own slots; drop --workers)")
    if (args.timeout_s is not None and not args.workers
            and not getattr(args, "remote", None)):
        parser.error("--timeout-s needs --workers >= 1 or --remote "
                     "(in-process measurements cannot be preempted)")
    rate = getattr(args, "trace_sample_rate", 1.0)
    if not 0.0 <= rate <= 1.0:
        parser.error("--trace-sample-rate must be in [0, 1]")
    if rate < 1.0 and not getattr(args, "trace", None):
        parser.error("--trace-sample-rate needs --trace (there is no "
                     "trace to sample without it)")


class MeasureHandle:
    """Future for one submitted job; resolved by its executor."""

    __slots__ = ("job_id", "task", "settings", "spec", "_result",
                 "_executor")

    def __init__(self, job_id: int, task: str, settings: Dict[str, object],
                 executor: Optional["Executor"] = None,
                 spec: Optional[WorkerSpec] = None):
        self.job_id = job_id
        self.task = task
        self.settings = settings
        self.spec = spec
        self._result: Optional[MeasureResult] = None
        self._executor = executor

    def done(self) -> bool:
        return self._result is not None

    def result(self) -> MeasureResult:
        """Block (by driving the executor) until the job resolves."""
        if self._result is None and self._executor is not None:
            self._executor.drain([self])
        if self._result is None:
            raise RuntimeError(f"job {self.job_id} never resolved")
        return self._result

    def _resolve(self, result: MeasureResult) -> None:
        self._result = result


class Executor:
    """Protocol: ``submit(task, settings) -> handle`` / ``drain()``.

    ``poll()`` services any completions without blocking (so callers can
    ask ``handle.done()`` meaningfully); ``drain(handles)`` blocks until
    the given handles — or everything in flight, if ``None`` — resolve.

    ``submit``'s optional ``spec`` names the measure-fn factory for *this
    job*, overriding the executor's default — that is what lets one
    worker pool serve every task of a multi-task session instead of each
    task spawning its own ``tasks * workers`` processes.
    """

    n_workers: int = 1

    def submit(self, task: str, settings: Dict[str, object],
               spec: Optional[WorkerSpec] = None) -> MeasureHandle:
        raise NotImplementedError

    def poll(self) -> None:
        """Service completions that are already available; never blocks."""

    def drain(self, handles: Optional[List[MeasureHandle]] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release workers; the executor must not be used afterwards."""

    def stats(self) -> Dict[str, object]:
        """Uniform observability snapshot — every executor answers the
        same keys so reports never ``hasattr``-sniff the transport.
        Executors without workers or queues return the zeroed shape."""
        return {"kind": "serial", "workers_alive": 0, "respawns": 0,
                "queued": 0, "running": 0, "max_inflight": 0,
                "jobs": 0, "failures": 0}

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SerialExecutor(Executor):
    """In-process executor: ``submit`` runs the measurement immediately.

    Exactly today's behavior — one measurement at a time, in submission
    order, in the parent process — which makes it both the zero-overhead
    default and the determinism reference for ``SubprocessExecutor``.
    Per-measurement timeouts cannot preempt in-process work and are
    therefore not enforced here; likewise per-spec ``env`` pins are *not*
    applied (the parent process already initialized its runtime — env
    mutation after the fact is a worker-only concept).
    """

    def __init__(self, fn: Optional[Callable[[Dict], object]] = None,
                 spec: Optional[WorkerSpec] = None):
        if fn is not None and spec is not None:
            raise ValueError("SerialExecutor takes fn= or spec=, not both")
        self._fn = fn if fn is not None else (
            resolve_factory(spec) if spec is not None else None)
        self._fns: Dict[Tuple, Callable] = {}  # per-job-spec resolutions
        self._next_id = 0

    def submit(self, task: str, settings: Dict[str, object],
               spec: Optional[WorkerSpec] = None) -> MeasureHandle:
        handle = MeasureHandle(self._next_id, task, settings, executor=self,
                               spec=spec)
        self._next_id += 1
        try:
            # an explicit default fn wins over the job's spec: in-process
            # the fn IS the resolved factory, so re-resolving the spec
            # would only build a redundant copy
            fn = self._fn
            if fn is None and spec is not None:
                key = spec.cache_key()
                if key not in self._fns:
                    self._fns[key] = resolve_factory(spec)
                fn = self._fns[key]
            if fn is None:
                raise ValueError("no measure fn: executor has no default "
                                 "and the job carried no spec")
            with obs.current().span("measure", cat="measure", task=task):
                value = fn(settings)
            handle._resolve(MeasureResult(ok=True, value=value))
        except Exception as e:  # infeasible configuration
            handle._resolve(MeasureResult(
                ok=False, error=f"{type(e).__name__}: {e}"))
        return handle

    def drain(self, handles: Optional[List[MeasureHandle]] = None) -> None:
        pass  # everything resolves at submit time
