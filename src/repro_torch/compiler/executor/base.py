"""Executor protocol, result/handle types, and the in-process executor.

A copy of the serial part of the reference's ``compiler/executor/base.py``
(stdlib only).  Measurement jobs are *data*: a task name plus a decoded
knob-settings dict, run by a measure function.  The subprocess pool, the
remote fabric and ``WorkerSpec`` factories come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch import obs


@dataclasses.dataclass
class MeasureResult:
    """Outcome of one measurement job, however it was executed.

    ``ok=False`` covers every failure class (the measure function raised,
    a worker died, a job timed out), distinguished only by ``error``.
    """

    ok: bool
    value: object = None
    error: str = ""


class MeasureHandle:
    """Future for one submitted job; resolved by its executor."""

    __slots__ = ("job_id", "task", "settings", "_result", "_executor")

    def __init__(self, job_id: int, task: str, settings: Dict[str, object],
                 executor: Optional["Executor"] = None):
        self.job_id = job_id
        self.task = task
        self.settings = settings
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
    """Protocol: ``submit(task, settings) -> handle`` / ``drain()``."""

    n_workers: int = 1

    def submit(self, task: str, settings: Dict[str, object]) -> MeasureHandle:
        raise NotImplementedError

    def poll(self) -> None:
        """Service completions that are already available; never blocks."""

    def drain(self, handles: Optional[List[MeasureHandle]] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        """Release workers; the executor must not be used afterwards."""

    def stats(self) -> Dict[str, object]:
        """Uniform observability snapshot (the reference's eight keys)."""
        return {"kind": "serial", "workers_alive": 0, "respawns": 0,
                "queued": 0, "running": 0, "max_inflight": 0,
                "jobs": 0, "failures": 0}

    def __enter__(self) -> "Executor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class SerialExecutor(Executor):
    """In-process executor: ``submit`` runs the measurement immediately,
    one at a time, in submission order.  A measure function that raises
    yields a failed :class:`MeasureResult` (an infeasible configuration),
    not an exception."""

    def __init__(self, fn: Callable[[Dict], object]):
        self._fn = fn
        self._next_id = 0

    def submit(self, task: str, settings: Dict[str, object]) -> MeasureHandle:
        handle = MeasureHandle(self._next_id, task, settings, executor=self)
        self._next_id += 1
        try:
            with obs.current().span("measure", cat="measure", task=task):
                value = self._fn(settings)
            handle._resolve(MeasureResult(ok=True, value=value))
        except Exception as e:  # infeasible configuration
            handle._resolve(MeasureResult(
                ok=False, error=f"{type(e).__name__}: {e}"))
        return handle

    def drain(self, handles: Optional[List[MeasureHandle]] = None) -> None:
        pass  # everything resolves at submit time
