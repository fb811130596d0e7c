"""``repro_torch.compiler.executor`` — parallel, crash-isolated measurement
execution (a copy of the reference's ``repro.compiler.executor``, stdlib
only).

Measurement becomes a submit/drain pipeline:

* :class:`Executor` — the protocol: ``submit(task, settings) -> handle``
  plus ``poll``/``drain``/``close``.
* :class:`SerialExecutor` — in-process execution (the determinism
  reference for the tests).
* :class:`SubprocessExecutor` — a pool of *spawned* worker processes
  (never forked: a parent with CUDA up cannot fork it into children);
  per-measurement timeouts, worker-crash isolation (a dead or hung worker
  yields a failure result and the pool respawns), and bounded, adaptive
  in-flight depth.
* :class:`RemoteExecutor` — the same protocol over TCP to worker daemons
  (``python -m repro_torch.compiler.executor.worker --listen HOST:PORT``),
  with capability-based routing across heterogeneous pools and the
  pool's fault semantics mapped onto connections (heartbeat loss,
  bounded reconnect-with-backoff).  See ``wire`` for the frame protocol
  (byte-identical to the reference's: a daemon of either package serves
  an executor of the other) and its trusted-network-only security
  posture.

Results always flow back through the one memoizing, JSONL-persisting
``Oracle`` in the parent process, so memo/records/resume semantics are
unchanged no matter which executor ran the measurement.

This package must stay importable without torch: workers that measure
cheap stub oracles (tests, the card's fabric phase) should not pay a torch
import at spawn time (``repro_torch/__init__.py`` imports torch lazily for
this).  Anything torch-flavored belongs in the worker *factory* the
:class:`WorkerSpec` names, which is resolved lazily inside the worker
process — and a factory that touches CUDA pins its device through
``WorkerSpec.env`` (``CUDA_VISIBLE_DEVICES``).
"""
from repro_torch.compiler.executor.base import (Executor, MeasureHandle,
                                          MeasureResult, SerialExecutor,
                                          WorkerSpec, add_worker_args,
                                          resolve_factory,
                                          validate_worker_args)
from repro_torch.compiler.executor.pool import SubprocessExecutor
from repro_torch.compiler.executor.remote import RemoteExecutor
from repro_torch.compiler.executor.wire import parse_endpoints

_WORKER_EXPORTS = ("WorkerDaemon", "spawn_daemon")


def __getattr__(name):
    # lazy: `python -m repro_torch.compiler.executor.worker` imports this
    # package first, and an eager worker import here would trip runpy's
    # found-in-sys.modules warning on every daemon start
    if name in _WORKER_EXPORTS:
        from repro_torch.compiler.executor import worker
        return getattr(worker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Executor",
    "MeasureHandle",
    "MeasureResult",
    "RemoteExecutor",
    "SerialExecutor",
    "SubprocessExecutor",
    "WorkerDaemon",
    "WorkerSpec",
    "add_worker_args",
    "parse_endpoints",
    "resolve_factory",
    "spawn_daemon",
    "validate_worker_args",
]
